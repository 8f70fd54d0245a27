"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--profile-dir DIR]

Builds the port's CUDA kernels from ``bsed_tpu_torch/csrc`` (nvcc, at first
use), holds each kernel against its plain PyTorch version at the shapes the
serving path gives it, drives the serving path (``make_fast_forward`` on
preset ``baseline``, bf16, precision 'high', B=64 full 10 s clips, random
weights from seed 0) and checks that it went through both kernels, then
holds the float32 kernel path against the plain path. One JSON line per
phase; then the card's name and power limit as nvidia-smi gives them, the
kernels line, and last ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before the last line. Needs one CUDA device; imports no JAX.
``--profile-dir`` also writes the full torch.profiler table of one serving
batch to ``DIR/serve_profile.txt``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_FLOPS = {"float32": 67e12,   # CUDA-core float32
              "bfloat16": 989e12}  # dense tensor-core bf16
B_SERVE = 64
N_TIMED = 5


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def bound(bytes_moved: float, flops_by_type: dict):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    the operations over the peak rate of their type."""
    t_bytes = bytes_moved / H100_BYTES_PER_S
    t_ops = sum(f / H100_FLOPS[k] for k, f in flops_by_type.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int, warmup: int = 2):
    """Median per-call device time (CUDA events, ms) of ``fn()``."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def check_mel_kernel(torch, dev):
    """K1 against its plain version at the serving shape (B=64, 10 s)."""
    import numpy as np
    from bsed_tpu_torch.config import AudioConfig
    from bsed_tpu_torch.ops import mel, mel_kernel
    from bsed_tpu_torch.ops.filterbank import mel_filterbank

    a = AudioConfig()
    fb64 = mel_filterbank(a.sr, a.n_window, a.n_mels, a.mel_f_min,
                          a.mel_f_max, dtype=np.float64)
    kb = mel_kernel.build_mel_kernel_bases(a.n_window, a.hop_size, fb64,
                                           device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    audio = torch.randn((B_SERVE, a.n_samples), generator=gen, device=dev)
    args = (kb, a.n_window, a.hop_size, a.n_mels)
    got = mel_kernel.fused_block_mel(audio, *args)
    want = mel_kernel.fused_block_mel_plain(audio, *args)
    torch.cuda.synchronize()
    t = mel.num_frames(a.n_samples, a.hop_size)
    assert got.shape == want.shape == (B_SERVE, t, a.n_mels), got.shape
    assert torch.isfinite(got).all()
    err_lin = float((got - want).abs().max())
    err_db = float((mel.amplitude_to_db(got)
                    - mel.amplitude_to_db(want)).abs().max())
    emit(phase="mel_kernel_check", shape=list(got.shape),
         max_abs_err=err_lin, rel_err=err_lin / float(want.abs().max()),
         max_abs_err_db=err_db, gate_db=1e-3)
    assert err_db <= 1e-3, f"K1 log-mel differs by {err_db} dB"

    ms = time_ms(lambda: mel_kernel.fused_block_mel(audio, *args), 10)
    plain_ms = time_ms(lambda: mel_kernel.fused_block_mel_plain(audio, *args),
                       3, warmup=1)
    # yardstick only (the port never calls it): torch.stft → |·| → mel
    win = torch.hamming_window(a.n_window, periodic=False, device=dev)
    fb_full = torch.as_tensor(fb64.astype(np.float32), device=dev)

    def library():
        spec = torch.stft(audio, a.n_window, a.hop_size, window=win,
                          center=True, pad_mode="reflect",
                          return_complex=True)
        return spec.abs().transpose(1, 2) @ fb_full
    library_ms = time_ms(library, 10)

    bins = kb.fb.shape[0]
    rem = a.n_window - 8 * a.hop_size
    flops = B_SERVE * ((t + 8) * a.hop_size * 6 * bins * 2   # stage 1
                       + t * bins * 8 * 6 * 2 * 2            # recombination
                       + t * rem * 2 * bins * 2              # tail
                       + t * bins * 4                        # |·|
                       + t * bins * a.n_mels * 2)            # mel
    consts = sum(c.numel() * 4 for c in kb)
    nbytes = audio.numel() * 4 + got.numel() * 4 + consts
    b_ms, b_by = bound(nbytes, {"float32": flops})
    return {"name": "mel_kernel", "route": "cuda",
            "source": "bsed_tpu_torch/csrc/mel_kernel.cu",
            "replaces": "bsed_tpu/ops/mel_kernel.py:304",
            "max_abs_err": err_lin, "max_abs_err_db": err_db,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms,
            "library_call": "torch.stft -> abs -> mel matmul",
            "gflop_per_call": flops / 1e9, "mb_per_call": nbytes / 1e6}


STEM_BLOCKS = ((0, 1255, 2, 16), (1, 627, 2, 32), (2, 313, 1, 64))


def check_stem_epilogue(torch, dev):
    """K2 against its plain version at blocks 0-2's serving shapes, GLU, in
    float32 and bfloat16."""
    from bsed_tpu_torch.ops import folded_stem, stem_epilogue as se

    gen = torch.Generator(device=dev).manual_seed(2)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    ms = plain_ms = b_ms = 0.0
    flop_t = byte_t = 0.0
    per_block = []
    for blk, t_in, pt, c in STEM_BLOCKS:
        f = 128 // c
        h32 = torch.randn((B_SERVE, t_in, 16, 128), generator=gen, device=dev)
        w_small = torch.randn((c, c), generator=gen, device=dev) / c ** 0.5
        w32 = torch.block_diag(*[w_small] * f).contiguous()
        inv = torch.ones(128, device=dev)
        cvec = 0.3 * torch.randn(128, generator=gen, device=dev)
        bvec = 0.1 * torch.randn(128, generator=gen, device=dev)
        pool_w = torch.as_tensor(folded_stem._freq_pool_matrix(f, 2, c),
                                 device=dev)
        ep = se.make_fused_epilogue("glu", pt, pool_w)
        for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 0.06)):
            h, w = h32.to(dt), w32.to(dt)
            got = ep(h, inv, cvec, w, bvec)
            want = se.stem_epilogue_plain(h, inv, cvec, w, bvec, "glu", pt,
                                          pool_w)
            torch.cuda.synchronize()
            assert got.shape == want.shape == (B_SERVE, t_in // pt, 16, 64)
            diff = (got.float() - want.float()).abs()
            err = float(diff.max())
            excess = float((diff - tol * want.float().abs()).max())
            emit(phase="stem_epilogue_check", block=blk,
                 shape=list(h.shape), dtype=str(dt).split(".")[1],
                 max_abs_err=err, gate_rtol_atol=tol)
            assert excess <= tol, f"K2 block {blk} {dt}: |Δ| {err}"
            worst[dt] = max(worst[dt], err)
            if dt is torch.bfloat16:       # the serving dtype: time it
                k = time_ms(lambda: ep(h, inv, cvec, w, bvec), 10)
                p = time_ms(lambda: se.stem_epilogue_plain(
                    h, inv, cvec, w, bvec, "glu", pt, pool_w), 5)
                rows = B_SERVE * t_in * 16
                mm = rows * 128 * 128 * 2
                ew = rows * 128 * 8 + rows // pt * 64 * 3
                nbytes = (h.numel() + got.numel() + w.numel()) * 2 + 3 * 512
                bb, by = bound(nbytes, {"bfloat16": mm, "float32": ew})
                per_block.append({"block": blk, "ms": k, "plain_ms": p,
                                  "bound_ms": bb, "bound_by": by})
                ms, plain_ms, b_ms = ms + k, plain_ms + p, b_ms + bb
                flop_t += mm / H100_FLOPS["bfloat16"] + ew / H100_FLOPS[
                    "float32"]
                byte_t += nbytes / H100_BYTES_PER_S
    emit(phase="stem_epilogue_times", dtype="bfloat16", blocks=per_block)
    return {"name": "stem_epilogue", "route": "cuda",
            "source": "bsed_tpu_torch/csrc/stem_epilogue.cu",
            "replaces": "bsed_tpu/ops/stem_epilogue.py:307",
            "max_abs_err": worst[torch.bfloat16],
            "max_abs_err_f32": worst[torch.float32],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": "bytes" if byte_t >= flop_t else "operations",
            "library_ms": None,
            "times_are": "sum over the 3 launches of one B=64 bf16 forward"}


def serve(dev, compute_dtype, use_kernels=True):
    from bsed_tpu_torch.config import get_config
    from bsed_tpu_torch.serve import make_fast_forward
    from bsed_tpu_torch.utils.weights import init_params

    cfg = get_config("baseline")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype=compute_dtype))
    params, stats = init_params(cfg, 0)
    return cfg, make_fast_forward(cfg, params, stats, device=dev,
                                  precision="high", use_kernels=use_kernels)


def main_path(torch, dev, card, kernel_ms, profile_dir):
    """The serving path at B=64 full-width clips, bf16, precision 'high';
    K1 must launch once and K2 three times per batch."""
    from bsed_tpu_torch.ops import mel_kernel, stem_epilogue

    cfg, forward = serve(dev, "bfloat16")
    gen = torch.Generator(device=dev).manual_seed(3)
    audio = torch.randn((B_SERVE, cfg.audio.n_samples), generator=gen,
                        device=dev) * 0.1
    for _ in range(2):                                 # warm-up
        forward(audio)
    torch.cuda.synchronize()

    mel_kernel.fused_block_mel.launches = 0
    stem_epilogue.stem_epilogue_fwd.launches = 0
    t0 = time.perf_counter()
    for _ in range(N_TIMED):
        strong, weak = forward(audio)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"mel_kernel": mel_kernel.fused_block_mel.launches,
                "stem_epilogue": stem_epilogue.stem_epilogue_fwd.launches}

    assert strong.shape == (B_SERVE, cfg.n_frames, cfg.nclass), strong.shape
    assert weak.shape == (B_SERVE, cfg.nclass), weak.shape
    assert torch.isfinite(strong).all() and torch.isfinite(weak).all()
    assert launches == {"mel_kernel": N_TIMED,
                        "stem_epilogue": 3 * N_TIMED}, launches
    emit(phase="main_path", preset="baseline", compute_dtype="bfloat16",
         precision="high", batch=B_SERVE, batches=N_TIMED,
         strong=list(strong.shape), weak=list(weak.shape),
         clips_per_s=B_SERVE * N_TIMED / elapsed,
         ms_per_batch=elapsed / N_TIMED * 1e3, launches=launches,
         kernel_median_ms=kernel_ms, card=card,
         weak_mean=float(weak.mean()), weak_std=float(weak.std()))
    profile(torch, forward, audio, profile_dir)
    return launches


def profile(torch, forward, audio, profile_dir):
    """Device time by kernel over one batch (torch.profiler); the top
    entries are printed, the full table written to ``profile_dir``."""
    import os
    from torch.profiler import ProfilerActivity, profile as prof

    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        forward(audio)
        torch.cuda.synchronize()
    events = p.key_averages()
    attr = ("device_time_total" if hasattr(events[0], "device_time_total")
            else "cuda_time_total")
    rows = sorted(((getattr(e, attr), e.key, e.count) for e in events
                   if getattr(e, attr) > 0), reverse=True)
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        with open(os.path.join(profile_dir, "serve_profile.txt"), "w") as fh:
            fh.write(events.table(sort_by=attr, row_limit=60))
    emit(phase="profile", batch=int(audio.shape[0]),
         top=[{"name": k[:60], "ms": t / 1e3, "calls": n}
              for t, k, n in rows[:12]])


def path_equality(torch, dev):
    """float32 serving path with the kernels against the same path on the
    plain versions, B=8; posteriors within 2e-3."""
    gen = torch.Generator(device=dev).manual_seed(4)
    cfg, fwd_k = serve(dev, "float32")
    _, fwd_p = serve(dev, "float32", use_kernels=False)
    audio = torch.randn((8, cfg.audio.n_samples), generator=gen,
                        device=dev) * 0.1
    sk, wk = fwd_k(audio)
    sp, wp = fwd_p(audio)
    torch.cuda.synchronize()
    err = max(float((sk - sp).abs().max()), float((wk - wp).abs().max()))
    emit(phase="path_equality", dtype="float32", batch=8,
         max_abs_err_posteriors=err, gate=2e-3)
    assert err <= 2e-3, f"kernel path differs from plain path by {err}"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile-dir", default=None,
                        help="write the serving profile table here")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from bsed_tpu_torch import kernels

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit(phase="device", name=name, nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    reports = kernels.build(kernels.SOURCES)
    for src, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {src}] {line.strip()}", file=sys.stderr)
    emit(phase="build", seconds=time.perf_counter() - t0,
         built=sorted(reports))

    k1 = check_mel_kernel(torch, dev)
    k2 = check_stem_epilogue(torch, dev)
    launches = main_path(torch, dev, smi,
                         {k["name"]: k["ms"] for k in (k1, k2)},
                         args.profile_dir)
    path_equality(torch, dev)

    k1["launches"] = launches["mel_kernel"]
    k2["launches"] = launches["stem_epilogue"]
    print(smi, flush=True)
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
