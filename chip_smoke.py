"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--profile-dir DIR]

Builds the port's CUDA kernels from ``bsed_tpu_torch/csrc`` (nvcc, at first
use, all sources in parallel) and drives every slice of the port:

  * serving: K1 (mel, an FFT kernel) and K2's eval form against their
    plain PyTorch versions at the serving shapes, K1 also against a
    float64 ``torch.stft`` golden on a few clips, with K1's bound counted
    from the function's work (real FFT, |·|, banded mel); then the serving
    path
    (``make_fast_forward`` on preset ``baseline``, bf16, precision 'high',
    B=64 full 10 s clips, random weights from seed 0), which must launch K1
    once, K2 three times and K4 twice (the hoisted BiGRU, one call a
    layer) per batch, a profiled batch (device time, busy share, launches),
    and the float32 kernel path against the plain path;
  * the fused-stem serving path: K5 (block 0) against its plain version at
    B=64, beside the standard block 0 (cuDNN conv + torch) as a yardstick,
    then ``make_fast_forward(use_fused_stem=True)`` at B=64, which must
    launch K1 and K5 once and K4 twice per batch and K2 never, held at B=8
    against the same path on the plain versions and against the standard
    CRNN path;
  * K4 (the BiGRU recurrence, a 2-block cluster kernel) against its plain
    version at the serving shape in float32 and bfloat16, the serving
    BiGRU (``HoistedBiGRU``) against cuDNN's ``nn.GRU``, and times a layer
    beside cuDNN's: µs a step, the cluster shape (RB, C), registers per
    thread and the serving layer's glue on its own; then the two BiGRU
    forms at the serving shape, 2 layers, bf16 and f32: host-clock wall
    time in turns and each form's distance from the f32 plain form;
  * training: K2's train form (dropout bits) and K3 (its backward) against
    their plain versions at the student shapes (B=72), with the body that
    served each dtype (bfloat16: wgmma, float32: FMA), its registers and
    spills from the ptxas report, per-block times, and K3's bound counted
    from the function's work (two bf16 passes for dW; the older count
    with a float32 FMA dW stays as ``bound_ms_fma_dw``), then the flagship
    train step (``train.steps.make_train_step`` on ``baseline_mt_isp`` with
    ``perf_config``: bf16, folded train stem with fused epilogues, fused
    streams; 12 SYN + 12 real full-width clips, epoch 30, random weights
    from seed 0), which must launch K2 six times and K3 three times per
    step, a profiled step, and the float32 kernel step against the plain
    step;
  * the eval path: ``evaluate_checkpoint`` on a checkpoint of preset
    baseline (full width, random weights from seed 0, written with the
    port's ``export_torch_checkpoint``) over 256 synthetic clips resident
    on the card at B=64, with the kernels (K2 eval three times and K4
    twice a batch) and on their plain versions: scores, wall seconds by
    phase, clips/s, posteriors within the float32 serving gate, every
    flipped binarized frame within that gate of the threshold, and card
    and host decoding giving identical event tables;
  * the loader-fed train step: a ``ThreeStreamLoader`` resident on the
    card feeds the flagship train step (same keys, shapes and dtypes as
    the random batch), ms a step beside the random-batch step's;
  * the trainer (``trainer_path``): ``python -m bsed_tpu_torch.cli train
    --preset baseline_mt_isp --perf -s 96`` through the CLI's ``main`` —
    2 epochs (the first profiled), a resume to a third, a fresh 3-epoch
    run and ``eval --store-dir`` — with K2's train form 48 and K3 24 times
    an epoch and K2's eval form 6 and K4 4 times an evaluate, finite
    results, a bit-exact checkpoint round trip, the resumed epoch against
    the uninterrupted one within the card's measured noise floor, and the
    store's evaluation equal to the best epoch's val scores; seconds an
    epoch by part, ms a step, busy share, checkpoint bytes and save ms;
  * K2's and K3's group-pool form (on no path of either package) against
    their plain versions at the shapes of blocks 3-6 (B=72, G=16/8/4/2),
    with the body that served each dtype (bfloat16: wgmma for both).

One JSON line per phase; then the card's name and power limit as
nvidia-smi gives them, the kernels line, and last ``{"ok": true,
"device": {...}}``. Any failure exits non-zero before the last line. Needs
one CUDA device; imports no JAX. ``--profile-dir`` also writes the
torch.profiler tables of one serving batch, one fused-stem batch and one
train step to ``DIR/serve_profile.txt``, ``DIR/fused_stem_profile.txt``
and ``DIR/train_profile.txt``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_FLOPS = {"float32": 67e12,   # CUDA-core float32
              "bfloat16": 989e12}  # dense tensor-core bf16
B_SERVE = 64
GOLDEN_CLIPS = 4                  # clips held against the float64 golden
N_TIMED = 5
B_TRAIN = 12                      # SYN clips per step; the real stream too
B_STUDENT = 6 * B_TRAIN           # the fused student forward's batch
BF16_GRAD_GATE = 5e-2             # relative Frobenius error, bf16 grads


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
    """Median per-call time (CUDA events, ms) of ``fn()``: one call between
    two events, so the time includes whatever host time of the wrapper the
    card waits for (the ``ms`` of every kernel entry, PRs 1-6)."""
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


def pipelined_ms(fn, reps: int = 10, warmup: int = 2, runs: int = 3):
    """Time a call of ``fn()`` (ms) the other way: CUDA events around
    ``reps`` back-to-back calls, divided by ``reps``, the median of
    ``runs`` runs. The card queues the next call while it runs this one,
    so a wrapper's host time is hidden where the call's device time
    exceeds it (``ms_pipelined``, beside ``time_ms``'s ``ms``)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    times.sort()
    return times[len(times) // 2]


def device_rows(torch, run, calls: int = 1):
    """``calls`` calls of ``run`` under torch.profiler: (events, the
    self-time attribute, rows), rows being (device self time in µs, key,
    count) of the device-side events only (kernels, memcpy, memset; the
    operators that launch them repeat the same time), largest first."""
    from torch.profiler import ProfilerActivity, profile as prof

    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    events = p.key_averages()
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    rows = sorted(((getattr(e, attr), e.key, e.count) for e in events
                   if getattr(e, attr) > 0
                   and "CUDA" in str(getattr(e, "device_type", ""))),
                  reverse=True)
    return events, attr, rows


def kernel_device_ms(torch, fn, needle: str, reps: int = 10) -> float:
    """The device time (ms) a call of ``fn()`` spends in kernels whose name
    contains ``needle``, from torch.profiler over ``reps`` calls: no host
    time at all. Up to three profiled windows: a window can come back
    with no record of a kernel launched through ctypes (seen once, for K5,
    in a run whose other profiles had their kernels)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        _, _, rows = device_rows(torch, fn, reps)
        total = sum(t for t, k, _ in rows if needle in k)
        if total > 0:
            break
    assert total > 0, f"no device time under {needle} in three windows"
    return total / 1e3 / reps


PTXAS = {}                        # source name -> ptxas report of this run


def kernel_resources(source: str, needle: str):
    """Registers a thread and spill bytes of the kernels of ``source``
    whose mangled name contains ``needle``, from this run's ptxas report:
    the largest over the template instances, and how many there are. None
    when the library was not built in this run."""
    import re
    log = PTXAS.get(source)
    if log is None:
        return None
    regs, spills, name = [], [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.rsplit(" ", 1)[-1]
        elif name and needle in name:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spills.append(int(m.group(1)) + int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs.append(int(m.group(1)))
                name = None
    if not regs:
        return None
    return {"instances": len(regs), "registers": max(regs),
            "spill_bytes": max(spills, default=0)}


def body_report(se, torch, fwd: bool, lane_form: bool = True):
    """Which body served each dtype, with its resources."""
    src = "stem_epilogue" if fwd else "stem_epilogue_bwd"
    which = "fwd" if fwd else "bwd"
    names = {("fwd", "mma"): ("epilogue_mma_kernel" if lane_form
                              else "epilogue_pg_mma_kernel"),
             ("fwd", "fma"): ("epilogue_kernel" if lane_form
                              else "epilogue_pg_kernel"),
             ("bwd", "mma"): "epilogue_bwd_mma_kernel",
             ("bwd", "fma"): "epilogue_bwd_kernel"}
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        body = se.kernel_body(dt, lane_form)[which]
        out[str(dt).split(".")[1]] = {
            "body": body, "kernel": names[which, body],
            "resources": kernel_resources(src, names[which, body])}
    return out


def own_blocks(per_block, fwd: bool):
    """The per-block records of one kernel: its own times (``fwd_`` or
    ``bwd_`` keys, prefix dropped) beside the block's identity."""
    tag = "fwd_" if fwd else "bwd_"
    other = "bwd_" if fwd else "fwd_"
    return [{k[len(tag):] if k.startswith(tag) else k: v
             for k, v in rec.items() if not k.startswith(other)}
            for rec in per_block]


def check_mel_kernel(torch, dev):
    """K1 against its plain version at the serving shape (B=64, 10 s) and
    against a float64 torch.stft golden on a few clips, both within 1e-3
    dB. The bound counts the function's work, whatever computes it: a real
    FFT (2.5·N·log2 N per frame), |·| over the live bins (3 FLOP each) and
    the mel over the filterbank's nonzeros (2 FLOP each); audio in, mel
    out."""
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
    win = torch.hamming_window(a.n_window, periodic=False, device=dev,
                               dtype=torch.float64)
    fb_gold = torch.as_tensor(fb64, device=dev)
    spec = torch.stft(audio[:GOLDEN_CLIPS].double(), a.n_window, a.hop_size,
                      window=win, center=True, pad_mode="reflect",
                      return_complex=True)
    gold = spec.abs().transpose(1, 2) @ fb_gold
    torch.cuda.synchronize()
    t = mel.num_frames(a.n_samples, a.hop_size)
    assert got.shape == want.shape == (B_SERVE, t, a.n_mels), got.shape
    assert torch.isfinite(got).all()
    err_lin = float((got - want).abs().max())
    db = mel.amplitude_to_db
    err_db = float((db(got) - db(want)).abs().max())
    err_gold_db = float((db(got[:GOLDEN_CLIPS].double()) - db(gold))
                        .abs().max())
    plain_gold_db = float((db(want[:GOLDEN_CLIPS].double()) - db(gold))
                          .abs().max())
    del spec, gold, want
    emit(phase="mel_kernel_check", shape=list(got.shape),
         max_abs_err=err_lin, max_abs_err_db=err_db,
         golden_clips=GOLDEN_CLIPS, max_abs_err_db_vs_f64=err_gold_db,
         plain_max_abs_err_db_vs_f64=plain_gold_db, gate_db=1e-3)
    assert err_db <= 1e-3, f"K1 log-mel differs by {err_db} dB"
    assert err_gold_db <= 1e-3, f"K1 vs float64 golden: {err_gold_db} dB"

    ms = time_ms(lambda: mel_kernel.fused_block_mel(audio, *args), 10)
    plain_ms = time_ms(lambda: mel_kernel.fused_block_mel_plain(audio, *args),
                       3, warmup=1)
    # yardstick only (the port never calls it): torch.stft → |·| → mel
    win32 = win.float()
    fb_full = fb_gold.float()

    def library():
        spec = torch.stft(audio, a.n_window, a.hop_size, window=win32,
                          center=True, pad_mode="reflect",
                          return_complex=True)
        return spec.abs().transpose(1, 2) @ fb_full
    library_ms = time_ms(library, 10)

    live = int((kb.bands[:, 0] + kb.bands[:, 1]).max())
    nnz = kb.weights.numel()
    frames = B_SERVE * t
    flops = frames * (2.5 * a.n_window * math.log2(a.n_window)
                      + 3 * live + 2 * nnz)
    nbytes = audio.numel() * 4 + got.numel() * 4
    b_ms, b_by = bound(nbytes, {"float32": flops})
    # the work of the block DFT the TPU kernel uses, kept for comparison
    rem = a.n_window - 8 * a.hop_size
    block_flops = B_SERVE * ((t + 8) * a.hop_size * 6 * live * 2
                             + t * live * 8 * 6 * 2 * 2 + t * rem * 2 * live
                             * 2 + t * live * 4 + t * live * a.n_mels * 2)
    return {"name": "mel_kernel", "route": "cuda",
            "source": "bsed_tpu_torch/csrc/mel_kernel.cu",
            "replaces": "bsed_tpu/ops/mel_kernel.py:304",
            "max_abs_err": err_lin, "max_abs_err_db": err_db,
            "max_abs_err_db_vs_f64": err_gold_db,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms,
            "library_call": "torch.stft -> abs -> mel matmul",
            "gflop_per_call": flops / 1e9, "mb_per_call": nbytes / 1e6,
            "block_dft_gflop": block_flops / 1e9,
            "filterbank_nnz": nnz, "live_bins": live}


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
            "library_ms": None, "body": body_report(se, torch, True),
            "blocks": per_block,
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
    K1 must launch once, K2 three times and K4 twice (one call a BiGRU
    layer) per batch."""
    from bsed_tpu_torch.ops import gru_kernel, mel_kernel, stem_epilogue

    cfg, forward = serve(dev, "bfloat16")
    gen = torch.Generator(device=dev).manual_seed(3)
    audio = torch.randn((B_SERVE, cfg.audio.n_samples), generator=gen,
                        device=dev) * 0.1
    for _ in range(2):                                 # warm-up
        forward(audio)
    torch.cuda.synchronize()

    mel_kernel.fused_block_mel.launches = 0
    stem_epilogue.stem_epilogue_fwd.launches = 0
    gru_kernel.gru_bidir_recurrence.launches = 0
    t0 = time.perf_counter()
    for _ in range(N_TIMED):
        strong, weak = forward(audio)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"mel_kernel": mel_kernel.fused_block_mel.launches,
                "stem_epilogue": stem_epilogue.stem_epilogue_fwd.launches,
                "gru_kernel": gru_kernel.gru_bidir_recurrence.launches}

    assert strong.shape == (B_SERVE, cfg.n_frames, cfg.nclass), strong.shape
    assert weak.shape == (B_SERVE, cfg.nclass), weak.shape
    assert torch.isfinite(strong).all() and torch.isfinite(weak).all()
    assert launches == {"mel_kernel": N_TIMED, "stem_epilogue": 3 * N_TIMED,
                        "gru_kernel": 2 * N_TIMED}, launches
    emit(phase="main_path", preset="baseline", compute_dtype="bfloat16",
         precision="high", batch=B_SERVE, batches=N_TIMED,
         strong=list(strong.shape), weak=list(weak.shape),
         clips_per_s=B_SERVE * N_TIMED / elapsed,
         ms_per_batch=elapsed / N_TIMED * 1e3, launches=launches,
         kernel_median_ms=kernel_ms, card=card,
         weak_mean=float(weak.mean()), weak_std=float(weak.std()))
    profile(torch, lambda: forward(audio), elapsed / N_TIMED, profile_dir,
            "profile", "serve_profile.txt", batch=B_SERVE)
    return launches


def profile(torch, run, timed_s, profile_dir, phase, table, **kw):
    """One call of ``run`` under torch.profiler (``device_rows``): device
    self time by kernel, its sum against the timed call's wall time
    (``timed_s``, from the phase's timed loop) and the count of
    device-side events; the top entries are printed, the full table
    written to ``profile_dir``."""
    events, attr, rows = device_rows(torch, run)
    write_table(events, attr, profile_dir, table)
    busy_ms = sum(t for t, _, _ in rows) / 1e3
    emit(phase=phase, **kw, device_ms=busy_ms, timed_ms=timed_s * 1e3,
         device_busy_share=busy_ms / (timed_s * 1e3),
         device_launches=sum(n for _, _, n in rows),
         top=[{"name": k[:70], "ms": t / 1e3, "calls": n}
              for t, k, n in rows[:30]])


def write_table(events, attr, profile_dir, name):
    import os
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        with open(os.path.join(profile_dir, name), "w") as fh:
            fh.write(events.table(sort_by=attr, row_limit=80))


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


def check_stem_kernel(torch, dev):
    """K5 against reference_stem_block at B=64, T=1255, float32 (gate
    2e-5 max |Δ|, tests/test_stem_kernel.py), block 0's weights from seed
    0; times of both, and as a yardstick of the same work done the
    standard way (not one library call of the same function): the port's
    eval block 0 (``models/layers.ConvBlock``: cuDNN conv with TF32 off,
    BatchNorm, GLU and the pool in torch) on the same input."""
    from bsed_tpu_torch.config import get_config
    from bsed_tpu_torch.models.layers import ConvBlock
    from bsed_tpu_torch.ops import stem_kernel as sk
    from bsed_tpu_torch.utils import weights
    from bsed_tpu_torch.utils.weights import init_params

    cfg = get_config("baseline")
    params, stats = init_params(cfg, 0)
    p0 = params["encoder"]["cnn"]["block0"]
    s0 = stats["encoder"]["cnn"]["block0"]
    folded = sk.fold_block0_params(p0, s0, device=dev)
    t = cfg.audio.max_frames
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((B_SERVE, t, 128, 1), generator=gen, device=dev)
    got = sk.fused_stem_block(x, folded)
    want = sk.reference_stem_block(x, folded)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B_SERVE, t // 2, 64, 16), got.shape
    assert torch.isfinite(got).all()
    err = float((got - want).abs().max())
    emit(phase="check_stem_kernel", shape=list(x.shape), dtype="float32",
         max_abs_err=err, gate=2e-5)
    assert err <= 2e-5, f"K5 differs from its plain version by {err}"
    ms = time_ms(lambda: sk.fused_stem_block(x, folded), 10)
    ms_pipe = pipelined_ms(lambda: sk.fused_stem_block(x, folded))
    device_ms = kernel_device_ms(torch, lambda: sk.fused_stem_block(x, folded),
                                 "stem_kernel")
    plain_ms = time_ms(lambda: sk.reference_stem_block(x, folded), 5)
    blk = ConvBlock(1, 16, (2, 2), "glu")
    weights.load_conv_block(blk, p0, s0)
    blk.to(dev).eval()
    with torch.inference_mode():
        like_err = float((blk(x) - want).abs().max())
        like_ms = time_ms(lambda: blk(x), 10)
    pix = B_SERVE * (t // 2) * 2 * 128         # conv pixels the pool reads
    flops = pix * (16 * 2 * 9 * 2 + 16 * 6) + got.numel() * 5
    nbytes = x.numel() * 4 + got.numel() * 4 + sk.N_PACKED * 4
    b_ms, b_by = bound(nbytes, {"float32": flops})
    return {"name": "stem_kernel", "route": "cuda",
            "source": "bsed_tpu_torch/csrc/stem_kernel.cu",
            "replaces": "bsed_tpu/ops/stem_kernel.py:137",
            "max_abs_err": err, "ms": ms, "ms_pipelined": ms_pipe,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "like_for_like_ms": like_ms,
            "like_for_like": "models/layers.ConvBlock block 0, eval: cuDNN "
                             "conv (TF32 off) + BN + GLU + 2x2 pool in "
                             "torch, same input",
            "like_for_like_max_abs_err": like_err,
            "resources": kernel_resources("stem_kernel", "stem_kernel"),
            "phases": "python -m bsed_tpu_torch.kernels.ablation --kernel "
                      "stem",
            "gflop_per_call": flops / 1e9, "mb_per_call": nbytes / 1e6,
            "times_are": "one B=64 float32 block-0 forward; ms is one "
                         "call between two CUDA events (as PRs 1-5), "
                         "ms_pipelined a run of back-to-back calls, "
                         "device_ms the kernel's own device time "
                         "(profiler)"}


def fused_stem_forward(dev, use_kernels=True, **kw):
    from bsed_tpu_torch.config import get_config
    from bsed_tpu_torch.serve import make_fast_forward
    from bsed_tpu_torch.utils.weights import init_params

    cfg = get_config("baseline")
    params, stats = init_params(cfg, 0)
    # widen the heads' N(0, 0.01) init so posteriors move away from 0.5
    # and the equality gates see encoder differences (as
    # tests/test_torch_serve.py does)
    for head in params["predictor"].values():
        head["kernel"] *= 30.0
    return cfg, make_fast_forward(cfg, params, stats, device=dev,
                                  precision="high", use_kernels=use_kernels,
                                  **kw)


def fused_stem_path(torch, dev, card, profile_dir):
    """The fused-stem serving path (preset baseline, precision 'high',
    blocks 1-6 and the GRU in float32): B=64, 2 warm-up and 5 timed
    batches, K1 and K5 once and K4 twice per batch and K2 never, and one
    profiled
    batch (``fused_stem_profile.txt``). Then at B=8: against
    the same path on the plain versions (2e-3, as path_equality) and
    against the standard CRNN path with kernels (1e-4,
    test_stem_kernel.py::test_fast_forward_matches_standard_path)."""
    from bsed_tpu_torch.ops import (gru_kernel, mel_kernel, stem_epilogue,
                                    stem_kernel)

    cfg, forward = fused_stem_forward(dev, use_fused_stem=True)
    gen = torch.Generator(device=dev).manual_seed(13)
    audio = torch.randn((B_SERVE, cfg.audio.n_samples), generator=gen,
                        device=dev) * 0.1
    for _ in range(2):
        forward(audio)
    torch.cuda.synchronize()

    mel_kernel.fused_block_mel.launches = 0
    stem_kernel.fused_stem_block.launches = 0
    stem_epilogue.stem_epilogue_fwd.launches = 0
    gru_kernel.gru_bidir_recurrence.launches = 0
    t0 = time.perf_counter()
    for _ in range(N_TIMED):
        strong, weak = forward(audio)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"mel_kernel": mel_kernel.fused_block_mel.launches,
                "stem_kernel": stem_kernel.fused_stem_block.launches,
                "stem_epilogue": stem_epilogue.stem_epilogue_fwd.launches,
                "gru_kernel": gru_kernel.gru_bidir_recurrence.launches}
    assert strong.shape == (B_SERVE, cfg.n_frames, cfg.nclass), strong.shape
    assert torch.isfinite(strong).all() and torch.isfinite(weak).all()
    assert launches == {"mel_kernel": N_TIMED, "stem_kernel": N_TIMED,
                        "stem_epilogue": 0, "gru_kernel": 2 * N_TIMED}, \
        launches
    emit(phase="fused_stem_path", preset="baseline", compute_dtype="float32",
         precision="high", batch=B_SERVE, batches=N_TIMED,
         clips_per_s=B_SERVE * N_TIMED / elapsed,
         ms_per_batch=elapsed / N_TIMED * 1e3, launches=launches, card=card,
         weak_mean=float(weak.mean()), weak_std=float(weak.std()))
    profile(torch, lambda: forward(audio), elapsed / N_TIMED, profile_dir,
            "fused_stem_profile", "fused_stem_profile.txt", batch=B_SERVE)
    del forward, strong, weak, audio
    torch.cuda.empty_cache()

    audio = torch.randn((8, cfg.audio.n_samples), generator=gen,
                        device=dev) * 0.1
    sk, wk = fused_stem_forward(dev, use_fused_stem=True)[1](audio)
    sp, wp = fused_stem_forward(dev, False, use_fused_stem=True)[1](audio)
    ss, ws = fused_stem_forward(dev, use_folded_stem=False)[1](audio)
    torch.cuda.synchronize()
    err_plain = max(float((sk - sp).abs().max()), float((wk - wp).abs().max()))
    err_std = max(float((sk - ss).abs().max()), float((wk - ws).abs().max()))
    emit(phase="fused_stem_equality", dtype="float32", batch=8,
         max_abs_err_vs_plain=err_plain, gate_vs_plain=2e-3,
         max_abs_err_vs_standard=err_std, gate_vs_standard=1e-4)
    assert err_plain <= 2e-3, f"fused path vs plain path: {err_plain}"
    assert err_std <= 1e-4, f"fused path vs standard path: {err_std}"
    return launches


GRU_T = 313                       # serving frames after the CNN
N_GRU = 10                        # timed calls of each BiGRU form


def hoisted_glue(torch, bigru, x):
    """The serving BiGRU's work a layer outside K4, as ``HoistedBiGRU``
    does it for its first layer: one projection of both directions + b_ih,
    the stack with the reverse half flipped, then flip and cat of an
    output of K4's shape."""
    w_ih, b_ih, _ = bigru.layers[0]
    x = x.to(bigru.dtype)
    ys2 = torch.zeros((2,) + x.shape[:2] + (w_ih.shape[1] // 6,),
                      device=x.device, dtype=bigru.dtype)

    def glue():
        xp = x @ w_ih + b_ih
        g3 = xp.shape[-1] // 2
        torch.stack([xp[..., :g3], xp[..., g3:].flip(1)])
        return torch.cat([ys2[0], ys2[1].flip(1)], dim=-1)
    return glue


def check_gru_kernel(torch, dev):
    """K4 at the serving shape (B=64, T=313, H=128): against its plain
    version (float32 1e-5; bfloat16 within 3e-2 of the float32 plain
    recurrence), the serving 2-layer BiGRU (``HoistedBiGRU`` on K4)
    against cuDNN's nn.GRU on the same weights (float32, 1e-4); times of
    K4 per layer (and per step), of one serving layer (projection matmul +
    K4 + glue), of that layer's glue alone and of cuDNN's one-layer
    bidirectional nn.GRU, in both dtypes, with the cluster shape (RB, C)
    and registers per thread."""
    from bsed_tpu_torch.models.rnn import BidirectionalGRU, HoistedBiGRU
    from bsed_tpu_torch.ops import gru_kernel as gk

    gen = torch.Generator(device=dev).manual_seed(14)
    h = 128
    xp2 = torch.randn((2, B_SERVE, GRU_T, 3 * h), generator=gen, device=dev)
    w = torch.randn((2, 3 * h, h), generator=gen, device=dev) * 0.1
    bias = torch.randn((2, 3 * h), generator=gen, device=dev) * 0.1
    want32 = gk.gru_bidir_recurrence_plain(xp2, w, bias)
    got32 = gk.gru_bidir_recurrence(xp2, w, bias)
    got16 = gk.gru_bidir_recurrence(xp2.bfloat16(), w.bfloat16(),
                                    bias.bfloat16())
    torch.cuda.synchronize()
    err32 = float((got32 - want32).abs().max())
    err16 = float((got16.float() - want32).abs().max())

    torch.manual_seed(0)
    rnn = BidirectionalGRU(h, h, 2).to(dev).eval()
    x = torch.randn((B_SERVE, GRU_T, h), generator=gen, device=dev)
    with torch.no_grad():
        err_net = float((HoistedBiGRU(rnn)(x) - rnn(x)).abs().max())
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    resident = gk.resident_clusters(dev)
    rows, cluster = gk.cluster_shape(B_SERVE, sms, resident)
    regs = {str(dt).split(".")[1]: gk.registers_per_thread(dt, rows)
            for dt in (torch.float32, torch.bfloat16)}
    emit(phase="check_gru_kernel", shape=list(xp2.shape),
         max_abs_err_f32=err32, gate_f32=1e-5,
         max_abs_err_bf16_vs_f32=err16, gate_bf16=3e-2,
         max_abs_err_2layer_vs_cudnn=err_net, gate_2layer=1e-4,
         rows_per_cluster=rows, cluster=cluster,
         blocks=2 * -(-B_SERVE // rows) * cluster, sms=sms,
         resident_clusters=resident,
         registers_per_thread=regs)
    assert err32 <= 1e-5, f"K4 float32 differs by {err32}"
    assert err16 <= 3e-2, f"K4 bfloat16 differs by {err16}"
    assert err_net <= 1e-4, f"hoisted BiGRU + K4 vs nn.GRU: {err_net}"

    res = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        a = (xp2.to(dt), w.to(dt), bias.to(dt))
        one = BidirectionalGRU(h, h, 1, dtype=dt).to(dev).eval()
        served = HoistedBiGRU(one)
        with torch.no_grad():
            k = time_ms(lambda: gk.gru_bidir_recurrence(*a), 10)
            hoisted = time_ms(lambda: served(x), 10)
            glue = time_ms(hoisted_glue(torch, served, x), 10)
            lib = time_ms(lambda: one(x), 10)
        plain = time_ms(lambda: gk.gru_bidir_recurrence_plain(*a), 3,
                        warmup=1)
        it = 2 if dt is torch.bfloat16 else 4
        mm = 2 * B_SERVE * GRU_T * h * 3 * h * 2
        ew = 2 * B_SERVE * GRU_T * h * 16
        nbytes = (xp2.numel() + got32.numel() + w.numel()) * it \
            + bias.numel() * 4
        ops = ({"float32": mm + ew} if dt is torch.float32
               else {"bfloat16": mm, "float32": ew})
        b_ms, b_by = bound(nbytes, ops)
        res[name] = {"ms": k, "us_per_step": k * 1e3 / GRU_T,
                     "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                     "hoisted_layer_ms": hoisted, "glue_ms": glue,
                     "library_ms": lib}
    emit(phase="gru_kernel_times", batch=B_SERVE, frames=GRU_T,
         rows_per_cluster=rows, cluster=cluster, per_layer=res,
         library_call="nn.GRU(128, 128, 1, bidirectional=True) (cuDNN), "
         "projection included; like for like with hoisted_layer_ms")
    f32 = res["float32"]
    return {"name": "gru_kernel", "route": "cuda",
            "source": "bsed_tpu_torch/csrc/gru_kernel.cu",
            "replaces": "bsed_tpu/ops/gru_kernel.py:108",
            "max_abs_err": err32, "max_abs_err_bf16_vs_f32": err16,
            "ms": f32["ms"], "us_per_step": f32["us_per_step"],
            "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
            "library_ms": f32["library_ms"],
            "hoisted_layer_ms": f32["hoisted_layer_ms"],
            "glue_ms": f32["glue_ms"], "rows_per_cluster": rows,
            "cluster": cluster, "registers_per_thread": regs,
            "bf16": res["bfloat16"],
            "times_are": "one layer, both directions, B=64, T=313, float32; "
                         "library_ms is cuDNN's one-layer bidirectional GRU "
                         "with its input projection, to be set against "
                         "hoisted_layer_ms (the serving layer: projection, "
                         "K4, glue); the floor is 313 dependent steps, not "
                         "the bound"}


def bigru_forms(torch, dev, card):
    """The serving BiGRU's two forms at the serving shape (B=64, T=313, 2
    layers, random baseline weights from seed 0), in bf16 and f32: the
    hoisted form on K4 (``HoistedBiGRU``, what serving runs) and cuDNN's
    nn.GRU (``BidirectionalGRU``, what training runs). Host clock around
    N_GRU calls ending in synchronize(), the forms in turns (K4, cuDNN,
    cuDNN, K4): the host's time launching cuDNN's per-timestep kernels is
    what the hoisted form removes, so CUDA events alone would hide it.
    Accuracy: each form's max |Δ| from the f32 hoisted form on K4's plain
    version; the bf16 K4 form within 3e-2 (tests/test_gru_kernel.py)."""
    from bsed_tpu_torch.config import get_config
    from bsed_tpu_torch.models.rnn import BidirectionalGRU, HoistedBiGRU
    from bsed_tpu_torch.utils import weights
    from bsed_tpu_torch.utils.weights import init_params

    params, _ = init_params(get_config("baseline"), 0)
    gen = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn((B_SERVE, GRU_T, 128), generator=gen, device=dev)

    def module(dtype):
        rnn = BidirectionalGRU(128, 128, 2, dtype=dtype)
        weights.load_gru(rnn, params["encoder"]["rnn"])
        return rnn.to(dev).eval()

    def wall_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(N_GRU):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / N_GRU * 1e3

    with torch.inference_mode():
        want = HoistedBiGRU(module(None), use_kernel=False)(x)
        res = {}
        for dt in (torch.bfloat16, torch.float32):
            rnn = module(dt)
            forms = {"hoisted_k4": HoistedBiGRU(rnn), "cudnn": rnn}
            times = {k: [] for k in forms}
            for k in ("hoisted_k4", "cudnn", "cudnn", "hoisted_k4"):
                times[k].append(wall_ms(lambda: forms[k](x)))
            errs = {k: float((f(x) - want).abs().max())
                    for k, f in forms.items()}
            res[str(dt).split(".")[1]] = {
                k: {"wall_ms": times[k], "max_abs_err_vs_f32_plain": errs[k]}
                for k in forms}
    emit(phase="bigru_forms", batch=B_SERVE, frames=GRU_T, layers=2,
         calls=N_GRU, gate_bf16_hoisted=3e-2, card=card, **res)
    err16 = res["bfloat16"]["hoisted_k4"]["max_abs_err_vs_f32_plain"]
    err32 = res["float32"]["hoisted_k4"]["max_abs_err_vs_f32_plain"]
    assert err16 <= 3e-2, f"bf16 hoisted BiGRU on K4 vs f32: {err16}"
    assert err32 <= 1e-5, f"f32 hoisted BiGRU on K4 vs plain: {err32}"
    return res


PG_BLOCKS = ((3, 16), (4, 8), (5, 4), (6, 2))   # blocks 3-6: (block, G)


def check_stem_epilogue_pg(torch, dev):
    """K2-pg and K3-pg against their plain versions at blocks 3-6's
    student shapes (B=72, T=313, G=16/8/4/2, pt=1, pg=2, GLU), with and
    without dropout bits, and at (pt, pg) = (2, 2) and (1, 1) on block 3:
    gates as check_stem_epilogue_train. Times are bf16 with bits, summed
    over blocks 3-6; launches are counted over those timed calls."""
    from bsed_tpu_torch.ops import stem_epilogue as se

    gen = torch.Generator(device=dev).manual_seed(15)
    t_in = GRU_T
    worst = {"fwd_f32": 0.0, "bwd_f32": 0.0, "fwd_bf16": 0.0,
             "bwd_bf16_rel": 0.0}
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "t_ops": 0.0,
               "t_bytes": 0.0} for k in ("fwd", "bwd")}
    launches = {"fwd": 0, "bwd": 0}
    cases = [(blk, g, 1, 2, bits) for blk, g in PG_BLOCKS
             for bits in (False, True)]
    cases += [(3, 16, 2, 2, True), (3, 16, 1, 1, True)]
    per_block = []
    for blk, g, pt, pg, with_bits in cases:
        shape = (B_STUDENT, t_in, g, 128)
        h32 = torch.randn(shape, generator=gen, device=dev)
        w32 = torch.randn((128, 128), generator=gen, device=dev) / 128 ** 0.5
        inv = 1.0 + 0.2 * torch.randn(128, generator=gen, device=dev)
        cvec = 0.3 * torch.randn(128, generator=gen, device=dev)
        bvec = 0.1 * torch.randn(128, generator=gen, device=dev)
        bits = (torch.randint(0, 256, (B_STUDENT, t_in * g, 128),
                              generator=gen, device=dev, dtype=torch.uint8)
                if with_bits else None)
        keep_k = 128 if with_bits else 0
        gz32 = torch.randn((B_STUDENT, t_in // pt, g // pg, 128),
                           generator=gen, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            h, w, gz = h32.to(dt), w32.to(dt), gz32.to(dt)
            args = (h, inv, cvec, w, bvec, "glu", pt, None)
            got = se.stem_epilogue_fwd(*args, 0, bits, keep_k, pg)
            want = se.stem_epilogue_plain(*args, bits, keep_k, pg)
            g1 = se.stem_epilogue_bwd(gz, *args, 0, bits, keep_k, pg)
            g2 = se.stem_epilogue_bwd(gz, *args, 0, bits, keep_k, pg)
            gp = se.stem_epilogue_bwd_plain(gz, *args, bits, keep_k, pg)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(g1, g2))
            dfw = (got.float() - want.float()).abs()
            name = str(dt).split(".")[1]
            rec = {"block": blk, "G": g, "pt": pt, "pg": pg,
                   "bits": with_bits, "dtype": name,
                   "fwd_max_abs_err": float(dfw.max()),
                   "bwd_bit_identical": same}
            if dt is torch.float32:
                fwd_ok = bool((dfw <= 1e-5 + 1e-5 * want.abs()).all())
                # dh within 2e-4; each parameter reduction within 2e-4 of
                # the plain version or no farther from the float64 chain
                # than twice the plain float32 version is
                g64 = se.stem_epilogue_bwd_plain(
                    gz.double(), h.double(), inv.double(), cvec.double(),
                    w.double(), bvec.double(), "glu", pt, None, bits,
                    keep_k, pg)
                dh_err = float((g1[0] - gp[0]).abs().max())
                bwd_ok = bool(((g1[0] - gp[0]).abs()
                               <= 2e-4 + 2e-4 * gp[0].abs()).all())
                errs = {"h": {"vs_plain": dh_err}}
                for n, a, b, e in zip("inv c w b".split(), g1[1:], gp[1:],
                                      g64[1:]):
                    close = bool(((a - b).abs()
                                  <= 2e-4 + 2e-4 * b.abs()).all())
                    ek = float((a.double() - e).abs().max())
                    ep = float((b.double() - e).abs().max())
                    errs[n] = {"vs_plain": float((a - b).abs().max()),
                               "kernel_vs_f64": ek, "plain_vs_f64": ep}
                    bwd_ok = bwd_ok and (close or ek <= 2 * ep)
                rec["bwd_max_abs_err"] = errs
                del g64
                worst["fwd_f32"] = max(worst["fwd_f32"], float(dfw.max()))
                worst["bwd_f32"] = max(worst["bwd_f32"], dh_err)
            else:
                fwd_ok = bool((dfw <= 0.06 + 0.06 * want.float().abs()).all())
                rels = {n: rel_fro(a, b) for n, a, b in
                        zip("h inv c w b".split(), g1, gp)}
                rec["bwd_rel_fro"] = rels
                bwd_ok = all(r <= BF16_GRAD_GATE for r in rels.values())
                worst["fwd_bf16"] = max(worst["fwd_bf16"], float(dfw.max()))
                worst["bwd_bf16_rel"] = max(worst["bwd_bf16_rel"],
                                            max(rels.values()))
            emit(phase="check_stem_epilogue_pg", **rec)
            assert fwd_ok, f"K2-pg, block {blk} {name} pt={pt} pg={pg}"
            assert bwd_ok, f"K3-pg, block {blk} {name} pt={pt} pg={pg}"
            assert same, f"K3-pg block {blk} {name}: not repeatable"
            if (dt is not torch.bfloat16 or not with_bits
                    or (pt, pg) != (1, 2)):
                continue
            rows = B_STUDENT * t_in * g
            n = rows * 128
            mm = rows * 128 * 128 * 2
            n0 = (se.stem_epilogue_fwd.launches, se.stem_epilogue_bwd.launches)
            kf = time_ms(lambda: se.stem_epilogue_fwd(*args, 0, bits, keep_k,
                                                      pg), 10)
            kb = time_ms(lambda: se.stem_epilogue_bwd(gz, *args, 0, bits,
                                                      keep_k, pg), 10)
            launches["fwd"] += se.stem_epilogue_fwd.launches - n0[0]
            launches["bwd"] += se.stem_epilogue_bwd.launches - n0[1]
            kf_pipe = pipelined_ms(lambda: se.stem_epilogue_fwd(
                *args, 0, bits, keep_k, pg))
            kf_dev = kernel_device_ms(
                torch, lambda: se.stem_epilogue_fwd(*args, 0, bits, keep_k,
                                                    pg), "epilogue_pg")
            pf = time_ms(lambda: se.stem_epilogue_plain(*args, bits, keep_k,
                                                        pg), 5)
            pb = time_ms(lambda: se.stem_epilogue_bwd_plain(
                gz, *args, bits, keep_k, pg), 5)
            # K2-pg: h and bits read, output written; 1 product in bf16
            fb = n * 2 + n + got.numel() * 2 + w.numel() * 2 + 3 * 512
            f_ops = {"bfloat16": mm, "float32": n * 10}
            # K3-pg, the function's work: gz, h, bits read, dh written; the
            # three products at the tensor-core rate, dW as two bf16
            # passes (as check_stem_epilogue_train counts K3)
            bb = gz.numel() * 2 + n * 2 + n + n * 2 + w.numel() * 2 \
                + 128 * 128 * 4 + 7 * 512
            b_ops = {"bfloat16": 4 * mm, "float32": n * 20}
            tot["bwd"]["bound_ms_fma_dw"] = \
                tot["bwd"].get("bound_ms_fma_dw", 0.0) + bound(
                    bb, {"bfloat16": 2 * mm, "float32": mm + n * 20})[0]
            rec_b = {"block": blk, "G": g, "fwd_ms": kf,
                     "fwd_ms_pipelined": kf_pipe, "fwd_device_ms": kf_dev,
                     "fwd_plain_ms": pf,
                     "bwd_ms": kb, "bwd_plain_ms": pb}
            for acc, k, pl, nbytes, ops, tag in (
                    (tot["fwd"], kf, pf, fb, f_ops, "fwd"),
                    (tot["bwd"], kb, pb, bb, b_ops, "bwd")):
                acc["ms"] += k
                acc["plain_ms"] += pl
                acc["bound_ms"] += bound(nbytes, ops)[0]
                acc["t_bytes"] += nbytes / H100_BYTES_PER_S
                acc["t_ops"] += sum(v / H100_FLOPS[t] for t, v in ops.items())
                rec_b[tag + "_bound_ms"] = bound(nbytes, ops)[0]
            for key, v in (("ms_pipelined", kf_pipe), ("device_ms", kf_dev)):
                tot["fwd"][key] = tot["fwd"].get(key, 0.0) + v
            per_block.append(rec_b)
        del h32, w32, bits, gz32, h, w, gz, got, want, g1, g2, gp
        torch.cuda.empty_cache()
    emit(phase="stem_epilogue_pg_times", dtype="bfloat16", batch=B_STUDENT,
         pt=1, pg=2, blocks=per_block)

    def entry(name, src, replaces, t, err, n, fwd):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "max_abs_err": err,
                "ms": t["ms"], "ms_pipelined": t.get("ms_pipelined"),
                "device_ms": t.get("device_ms"), "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": ("bytes" if t["t_bytes"] >= t["t_ops"]
                             else "operations"),
                "library_ms": None, "launches": n,
                "body": body_report(se, torch, fwd, lane_form=False),
                "blocks": own_blocks(per_block, fwd),
                "times_are": "sum over blocks 3-6 (G=16/8/4/2) of one B=72 "
                             "bf16 forward/backward with dropout bits, "
                             "pt=1, pg=2; ms is one call between two "
                             "CUDA events (as PRs 1-5), ms_pipelined a run "
                             "of back-to-back calls, device_ms the "
                             "kernel's own device time (profiler); "
                             "launches are the calls timed for ms (no path "
                             "runs it)"}
    return (entry("stem_epilogue_pg", "bsed_tpu_torch/csrc/stem_epilogue.cu",
                  "bsed_tpu/ops/stem_epilogue.py:307", tot["fwd"],
                  worst["fwd_bf16"], launches["fwd"], True)
            | {"max_abs_err_f32": worst["fwd_f32"]},
            entry("stem_epilogue_pg_bwd",
                  "bsed_tpu_torch/csrc/stem_epilogue_bwd.cu",
                  "bsed_tpu/ops/stem_epilogue.py:325", tot["bwd"],
                  worst["bwd_f32"], launches["bwd"], False)
            | {"bound_ms_fma_dw": tot["bwd"]["bound_ms_fma_dw"],
               "max_abs_err_is": "float32 dh",
               "bf16_rel_fro_err": worst["bwd_bf16_rel"],
               "bf16_gate": BF16_GRAD_GATE})


def rel_fro(a, b) -> float:
    """Relative Frobenius error ||a − b|| / ||b|| in float32."""
    b = b.float()
    return float((a.float() - b).norm() / b.norm().clamp_min(1e-30))


def check_stem_epilogue_train(torch, dev):
    """K2's train form (dropout bits) and K3 against their plain versions
    at blocks 0-2's student shapes (B=72), GLU, real per-lane BN affine:
    float32 forward 1e-5 and gradients 2e-4 (rtol/atol; for the parameter
    reductions, or at most twice the plain version's distance from the
    float64 chain), bfloat16 forward 0.06 and gradients within
    BF16_GRAD_GATE relative Frobenius error; K3 twice on the same input
    must give the same bits. Times are bf16."""
    from bsed_tpu_torch.ops import folded_stem, stem_epilogue as se

    gen = torch.Generator(device=dev).manual_seed(5)
    worst = {"fwd_f32": 0.0, "bwd_f32": 0.0, "fwd_bf16": 0.0,
             "bwd_bf16_rel": 0.0}
    fwd_t = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "t_ops": 0.0,
             "t_bytes": 0.0}
    bwd_t = dict(fwd_t)
    per_block = []
    for blk, t_in, pt, c in STEM_BLOCKS:
        f = 128 // c
        shape = (B_STUDENT, t_in, 16, 128)
        h32 = torch.randn(shape, generator=gen, device=dev)
        w_small = torch.randn((c, c), generator=gen, device=dev) / c ** 0.5
        w32 = torch.block_diag(*[w_small] * f).contiguous()
        inv = 1.0 + 0.2 * torch.randn(128, generator=gen, device=dev)
        cvec = 0.3 * torch.randn(128, generator=gen, device=dev)
        bvec = 0.1 * torch.randn(128, generator=gen, device=dev)
        bits = torch.randint(0, 256, (B_STUDENT, t_in * 16, 128),
                             generator=gen, device=dev, dtype=torch.uint8)
        gz32 = torch.randn((B_STUDENT, t_in // pt, 16, 64), generator=gen,
                           device=dev)
        pool_w = torch.as_tensor(folded_stem._freq_pool_matrix(f, 2, c),
                                 device=dev)
        for dt in (torch.float32, torch.bfloat16):
            h, w, gz = h32.to(dt), w32.to(dt), gz32.to(dt)
            args = (h, inv, cvec, w, bvec, "glu", pt, pool_w)
            got = se.stem_epilogue_fwd(*args, c, bits, 128)
            want = se.stem_epilogue_plain(*args, bits, 128)
            g1 = se.stem_epilogue_bwd(gz, *args, c, bits, 128)
            g2 = se.stem_epilogue_bwd(gz, *args, c, bits, 128)
            gp = se.stem_epilogue_bwd_plain(gz, *args, bits, 128)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(g1, g2))
            dfw = (got.float() - want.float()).abs()
            name = str(dt).split(".")[1]
            rec = {"block": blk, "dtype": name, "shape": list(h.shape),
                   "fwd_max_abs_err": float(dfw.max()),
                   "bwd_bit_identical": same}
            if dt is torch.float32:
                fwd_ok = bool((dfw <= 1e-5 + 1e-5 * want.abs()).all())
                # the parameter gradients are sums over B·T·16 rows (1.4M
                # at block 0), whose float32 rounding depends on the
                # order: a gradient passes within 2e-4 rtol/atol of the
                # plain version, or no further from the float64 chain
                # than twice the plain float32 version is
                g64 = se.stem_epilogue_bwd_plain(
                    gz.double(), h.double(), inv.double(), cvec.double(),
                    w.double(), bvec.double(), "glu", pt, pool_w.double(),
                    bits, 128)
                bwd_ok, errs = True, {}
                for n, a, b, e in zip("h inv c w b".split(), g1, gp, g64):
                    close = bool(((a - b).abs()
                                  <= 2e-4 + 2e-4 * b.abs()).all())
                    ek = float((a.double() - e).abs().max())
                    ep = float((b.double() - e).abs().max())
                    errs[n] = {"vs_plain": float((a - b).abs().max()),
                               "kernel_vs_f64": ek, "plain_vs_f64": ep}
                    bwd_ok = bwd_ok and (close or ek <= 2 * ep)
                rec["bwd_max_abs_err"] = errs
                del g64
                worst["fwd_f32"] = max(worst["fwd_f32"], float(dfw.max()))
                worst["bwd_f32"] = max(worst["bwd_f32"], max(
                    float((a - b).abs().max()) for a, b in zip(g1, gp)))
            else:
                fwd_ok = bool((dfw <= 0.06 + 0.06 * want.float().abs()).all())
                rels = {n: rel_fro(a, b) for n, a, b in
                        zip("h inv c w b".split(), g1, gp)}
                rec["bwd_rel_fro"] = rels
                bwd_ok = all(r <= BF16_GRAD_GATE for r in rels.values())
                worst["fwd_bf16"] = max(worst["fwd_bf16"], float(dfw.max()))
                worst["bwd_bf16_rel"] = max(worst["bwd_bf16_rel"],
                                            max(rels.values()))
            emit(phase="stem_epilogue_train_check", **rec)
            assert fwd_ok, f"K2 train form, block {blk} {name}"
            assert bwd_ok, f"K3, block {blk} {name}"
            assert same, f"K3 block {blk} {name}: reductions not repeatable"
            if dt is not torch.bfloat16:
                continue
            rows = B_STUDENT * t_in * 16
            n = rows * 128
            mm = rows * 128 * 128 * 2
            kf = time_ms(lambda: se.stem_epilogue_fwd(*args, c, bits, 128),
                         10)
            pf = time_ms(lambda: se.stem_epilogue_plain(*args, bits, 128), 5)
            kb = time_ms(lambda: se.stem_epilogue_bwd(gz, *args, c, bits,
                                                      128), 10)
            pb = time_ms(lambda: se.stem_epilogue_bwd_plain(
                gz, *args, bits, 128), 5)
            # K2: h and bits read, output written; 1 product in bf16
            fb = n * 2 + n + got.numel() * 2 + w.numel() * 2 + 3 * 512
            f_ops = {"bfloat16": mm, "float32": n * 10}
            # K3, the function's work whatever implements it: gz, h, bits
            # read, dh written; the three products at the tensor-core
            # rate, dW as two bf16 passes (h is exact in bf16 and
            # y^T dlin = inv (h^T dlin) + c db^T, so only dlin needs a
            # hi/lo split: the cheapest form known that keeps
            # float32-grade operands)
            bb = gz.numel() * 2 + n * 2 + n + n * 2 + w.numel() * 2 \
                + 128 * 128 * 4 + 7 * 512
            b_ops = {"bfloat16": 4 * mm, "float32": n * 20}
            # the older count: dW as a float32 FMA product
            bwd_t["bound_ms_fma_dw"] = bwd_t.get("bound_ms_fma_dw", 0.0) \
                + bound(bb, {"bfloat16": 2 * mm, "float32": mm + n * 20})[0]
            rec_b = {"block": blk, "fwd_ms": kf, "fwd_plain_ms": pf,
                     "bwd_ms": kb, "bwd_plain_ms": pb}
            for acc, k, pl, nbytes, ops, tag in (
                    (fwd_t, kf, pf, fb, f_ops, "fwd"),
                    (bwd_t, kb, pb, bb, b_ops, "bwd")):
                bms, _ = bound(nbytes, ops)
                acc["ms"] += k
                acc["plain_ms"] += pl
                acc["bound_ms"] += bms
                acc["t_bytes"] += nbytes / H100_BYTES_PER_S
                acc["t_ops"] += sum(v / H100_FLOPS[t] for t, v in ops.items())
                rec_b[tag + "_bound_ms"] = bms
            per_block.append(rec_b)
        del h32, w32, bits, gz32, h, w, gz, got, want, g1, g2, gp
        torch.cuda.empty_cache()
    emit(phase="stem_epilogue_train_times", dtype="bfloat16",
         batch=B_STUDENT, blocks=per_block)

    def entry(name, src, replaces, t, err, fwd):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "max_abs_err": err,
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": ("bytes" if t["t_bytes"] >= t["t_ops"]
                             else "operations"),
                "bound_bytes_ms": t["t_bytes"] * 1e3,
                "bound_operations_ms": t["t_ops"] * 1e3,
                "library_ms": None, "body": body_report(se, torch, fwd),
                "blocks": own_blocks(per_block, fwd),
                "times_are": "sum over blocks 0-2 of one B=72 bf16 student "
                             "forward/backward"}
    return (entry("stem_epilogue_train", "bsed_tpu_torch/csrc/stem_epilogue.cu",
                  "bsed_tpu/ops/stem_epilogue.py:307", fwd_t,
                  worst["fwd_bf16"], True)
            | {"max_abs_err_f32": worst["fwd_f32"]},
            entry("stem_epilogue_bwd",
                  "bsed_tpu_torch/csrc/stem_epilogue_bwd.cu",
                  "bsed_tpu/ops/stem_epilogue.py:325", bwd_t,
                  worst["bwd_f32"], False) | {
                      "bound_ms_fma_dw": bwd_t["bound_ms_fma_dw"],
                      "max_abs_err_is": "float32 gradients",
                      "bf16_rel_fro_err": worst["bwd_bf16_rel"],
                      "bf16_gate": BF16_GRAD_GATE})


def train_setup(torch, dev, compute_dtype, use_kernels, batch_size):
    """(cfg, state, step, batch) of the flagship train step on ``dev``:
    ``baseline_mt_isp`` + perf_config, random weights from seed 0, a random
    full-width batch made on the card as bench.py:160-171 makes it."""
    from bsed_tpu_torch.config import get_config, perf_config
    from bsed_tpu_torch.train import steps

    cfg = perf_config(get_config("baseline_mt_isp"))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype=compute_dtype))
    modules = steps.build_modules(cfg, device=dev, use_kernels=use_kernels)
    state = steps.create_train_state(cfg, modules, 0)
    gen = torch.Generator(device=dev).manual_seed(11)
    t_in, f = cfg.audio.max_frames, cfg.audio.n_mels
    batch = {
        "syn": torch.randn((batch_size, t_in, f), generator=gen,
                           device=dev).abs(),
        "syn_strong": (torch.rand((batch_size, cfg.n_frames, cfg.nclass),
                                  generator=gen, device=dev) > 0.9).float(),
        "real": torch.randn((batch_size, t_in, f), generator=gen,
                            device=dev).abs(),
        "real_weak": (torch.rand((batch_size, cfg.nclass), generator=gen,
                                 device=dev) > 0.8).float()}
    return cfg, state, steps.make_train_step(modules), batch


def train_path(torch, dev, card, profile_dir):
    """The flagship train step, bf16, 12 + 12 full-width clips at epoch 30:
    2 warm-up steps, then 5 timed; K2 must launch 6 times (3 student + 3
    teacher blocks) and K3 3 times per step; finite metrics; the params
    and the EMA params must move."""
    from bsed_tpu_torch.ops import stem_epilogue as se

    cfg, state, step, batch = train_setup(torch, dev, "bfloat16", True,
                                          B_TRAIN)
    for _ in range(2):
        step(state, batch, 1, 30.0)
    torch.cuda.synchronize()
    p0 = [p.detach().clone() for p in state.model.parameters()]
    e0 = [p.detach().clone() for p in state.ema_model.parameters()]
    torch.cuda.reset_peak_memory_stats()

    se.stem_epilogue_fwd.launches = 0
    se.stem_epilogue_bwd.launches = 0
    t0 = time.perf_counter()
    for _ in range(N_TIMED):
        metrics = step(state, batch, 1, 30.0)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"stem_epilogue_train": se.stem_epilogue_fwd.launches,
                "stem_epilogue_bwd": se.stem_epilogue_bwd.launches}

    values = {k: float(v) for k, v in metrics.items()}
    assert all(math.isfinite(v) for v in values.values()), values
    assert launches == {"stem_epilogue_train": 6 * N_TIMED,
                        "stem_epilogue_bwd": 3 * N_TIMED}, launches
    moved = lambda a, b: any(not torch.equal(x, y.detach())  # noqa: E731
                             for x, y in zip(a, b))
    assert moved(p0, state.model.parameters()), "params did not move"
    assert moved(e0, state.ema_model.parameters()), "EMA did not move"
    step_s = elapsed / N_TIMED
    emit(phase="train_path", preset="baseline_mt_isp", config="perf_config",
         compute_dtype="bfloat16", batch_syn=B_TRAIN, batch_real=B_TRAIN,
         steps=N_TIMED, epoch=30.0, ms_per_step=step_s * 1e3,
         clips_per_s=2 * B_TRAIN / step_s, launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         loss=values["loss"], card=card)
    train_profile(torch, state, step, batch, step_s, profile_dir)
    return launches, step_s * 1e3


def train_profile(torch, state, step, batch, step_s, profile_dir):
    """One train step under torch.profiler (``profile``), then the GRU's
    weight cast."""
    profile(torch, lambda: step(state, batch, 1, 30.0), step_s, profile_dir,
            "train_profile", "train_profile.txt")
    gru_weight_cast(torch, state.model.encoder.rest.rnn.gru.weight_ih_l0.device)


def gru_weight_cast(torch, dev):
    """Forward + backward of the train GRU at the student shape (B=72,
    313 frames) with float32 master weights cast to bf16 on every call
    (the train step's form) against bf16 weights held by the module (the
    serving form); host clock around synchronised calls, median of 5."""
    from bsed_tpu_torch.models.rnn import BidirectionalGRU

    x = torch.randn((B_STUDENT, 313, 128), device=dev)
    res = {}
    for cast in (False, True):
        gru = BidirectionalGRU(128, 128, 2, dtype=torch.bfloat16,
                               cast_weights=cast).to(dev).train()
        xi = x.clone().requires_grad_(True)
        times = []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gru(xi).sum().backward()
            torch.cuda.synchronize()
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        res["bf16_weights_ms" if cast else "f32_master_cast_ms"] = \
            sorted(times)[len(times) // 2]
    emit(phase="gru_weight_cast", batch=B_STUDENT, frames=313, **res)


def train_equality(torch, dev):
    """The float32 train step with the kernels against the same step on
    their plain versions: same init, same generator seed, 4 + 4 full-width
    clips, dropout 0.5. Gates: metrics rel 1e-4; Adam first moments atol
    3e-5 (gradients 3e-4); BatchNorm running stats 1e-5 (+1e-5 relative)."""
    import numpy as np
    from bsed_tpu_torch.utils import weights

    torch.backends.cudnn.deterministic = True
    try:
        out = {}
        for use_kernels in (True, False):
            _, state, step, batch = train_setup(torch, dev, "float32",
                                                use_kernels, 4)
            metrics = step(state, batch, 7, 30.0)
            torch.cuda.synchronize()
            out[use_kernels] = ({k: float(v) for k, v in metrics.items()},
                                weights.export_train_state(state))
            del state, step, batch
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    (mk, tk), (mp, tp) = out[True], out[False]

    def leaves(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, prefix + (k,))
        else:
            yield prefix, np.asarray(tree)

    def worst(key, rtol):
        want = dict(leaves(tp[key]))
        return max(float((np.abs(v - want[p]) - rtol * np.abs(want[p])).max())
                   for p, v in leaves(tk[key]))
    loss_rel = max(abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-30) for k in mp)
    mu_err = worst("mu", 0.0)
    stats_err = max(worst("batch_stats", 1e-5),
                    worst("ema_batch_stats", 1e-5))
    emit(phase="train_equality", dtype="float32", batch_syn=4, batch_real=4,
         dropout=0.5, metrics_max_rel_err=loss_rel, gate_metrics=1e-4,
         adam_mu_max_abs_err=mu_err, gate_mu=3e-5,
         bn_stats_max_err=stats_err, gate_bn_stats=1e-5,
         loss_kernels=mk["loss"], loss_plain=mp["loss"])
    assert loss_rel <= 1e-4, f"metrics differ by {loss_rel} (relative)"
    assert mu_err <= 3e-5, f"Adam first moments differ by {mu_err}"
    assert stats_err <= 1e-5, f"BN statistics differ by {stats_err}"


N_EVAL_CLIPS = 256                # eval_path's synthetic clips
B_EVAL = 64
EVAL_THRESHOLDS = (0.5,)
EVAL_GATE = 2e-3                  # float32 serving gate (path_equality)


def eval_path(torch, dev, card):
    """Evaluate a checkpoint on the card, as a user does
    (``eval.test_model.evaluate_checkpoint``): preset baseline at full
    width, random weights from seed 0 written with the port's
    ``export_torch_checkpoint``, an ``EvalLoader`` over
    ``SyntheticDataSource(n_items=256, seed=0)`` at B=64, resident on the
    card; once with the kernels (K2 eval three times and K4 twice a batch
    must launch) and once on their plain versions. Gates: posteriors
    within the float32 serving gate; every binarized frame that differs
    has a plain posterior within that gate of the threshold; decoding the
    plain posteriors on the card and on the host gives identical event
    tables."""
    import os
    import tempfile

    import numpy as np
    from bsed_tpu_torch.config import get_config
    from bsed_tpu_torch.data.datasets import SyntheticDataSource
    from bsed_tpu_torch.data.pipeline import EvalLoader
    from bsed_tpu_torch.eval.decode import decode_batch
    from bsed_tpu_torch.eval.test_model import (evaluate_checkpoint,
                                                export_torch_checkpoint)
    from bsed_tpu_torch.ops import gru_kernel, stem_epilogue
    from bsed_tpu_torch.utils.weights import init_params

    cfg = get_config("baseline")
    params, stats = init_params(cfg, 0)
    t0 = time.perf_counter()
    source = SyntheticDataSource(cfg, n_items=N_EVAL_CLIPS, seed=0)
    source.as_arrays()                       # made once, on the host
    data_s = time.perf_counter() - t0
    n_batches = N_EVAL_CLIPS // B_EVAL
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = export_torch_checkpoint(cfg, params, stats,
                                       os.path.join(tmp, "baseline.pt"))
        # kernels (the first use of every op on this path), plain, and
        # kernels again (warm): the gates read the first run
        for run, use_kernels in (("kernels", True), ("plain", False),
                                 ("kernels_warm", True)):
            loader = EvalLoader(source, batch_size=B_EVAL, device=dev)
            torch.cuda.synchronize()
            stem_epilogue.stem_epilogue_fwd.launches = 0
            gru_kernel.gru_bidir_recurrence.launches = 0
            t0 = time.perf_counter()
            res = evaluate_checkpoint(cfg, loader, torch_ckpt=ckpt,
                                      thresholds=EVAL_THRESHOLDS,
                                      device=dev, use_kernels=use_kernels,
                                      keep_posteriors=True)
            wall = time.perf_counter() - t0
            launches = {
                "stem_epilogue": stem_epilogue.stem_epilogue_fwd.launches,
                "gru_kernel": gru_kernel.gru_bidir_recurrence.launches}
            assert loader.prepare()[0].device.type == "cuda"
            runs[run] = (res, wall, launches)
    (rk, wall_k, launches), (rp, wall_p, launches_p), (rw, wall_w, _) = (
        runs["kernels"], runs["plain"], runs["kernels_warm"])
    assert launches == {"stem_epilogue": 3 * n_batches,
                        "gru_kernel": 2 * n_batches}, launches
    assert launches_p == {"stem_epilogue": 0, "gru_kernel": 0}, launches_p
    pk, pp = rk["posteriors"], rp["posteriors"]
    assert pk.shape == (N_EVAL_CLIPS, cfg.n_frames, cfg.nclass), pk.shape
    assert np.isfinite(pk).all() and np.isfinite(pp).all()
    err = float(np.abs(pk - pp).max())
    flips, flip_dist = 0, 0.0
    for th in EVAL_THRESHOLDS:
        diff = (pk > th) != (pp > th)
        flips += int(diff.sum())
        if diff.any():
            flip_dist = max(flip_dist, float(np.abs(pp[diff] - th).max()))
    names = [source.filename(i) for i in range(N_EVAL_CLIPS)]
    on_card = decode_batch(torch.from_numpy(pp).to(dev), names,
                           cfg.bird_list, cfg, thresholds=EVAL_THRESHOLDS)
    on_host = decode_batch(pp, names, cfg.bird_list, cfg,
                           thresholds=EVAL_THRESHOLDS)
    tables_equal = all(on_card[th].rows() == on_host[th].rows()
                       for th in EVAL_THRESHOLDS)
    n_events = sum(len(on_host[th]) for th in EVAL_THRESHOLDS)
    split = decode_split(torch, dev, torch.from_numpy(pp[:B_EVAL]).to(dev),
                         names[:B_EVAL], cfg)

    def scores(r):
        return {"event_f1": r["event_f1"], "psds_f1": r["psds_f1"],
                "per_class_f1": r["per_class_f1"], "seconds": r["seconds"]}
    sec = rk["seconds"]
    emit(phase="eval_path", preset="baseline", compute_dtype="float32",
         clips=N_EVAL_CLIPS, batch=B_EVAL, batches=n_batches,
         thresholds=list(EVAL_THRESHOLDS), data_setup_s=data_s,
         kernels=scores(rk), plain=scores(rp), kernels_warm=scores(rw),
         wall_s=wall_k, wall_s_plain=wall_p, wall_s_warm=wall_w,
         clips_per_s=N_EVAL_CLIPS / wall_k,
         clips_per_s_warm=N_EVAL_CLIPS / wall_w,
         clips_per_s_predict=N_EVAL_CLIPS / sec["predict"],
         decode_split_ms=split,
         launches=launches,
         launches_per_batch={k: v / n_batches for k, v in launches.items()},
         max_abs_err_posteriors=err, gate=EVAL_GATE,
         binarized_frames_differing=flips,
         max_plain_distance_from_threshold=flip_dist,
         events_decoded=n_events, card_host_tables_equal=tables_equal,
         card=card)
    assert err <= EVAL_GATE, f"eval posteriors differ by {err}"
    assert flip_dist <= EVAL_GATE, \
        f"a binarized frame flipped {flip_dist} from the threshold"
    assert tables_equal, "decoding on the card and on the host differ"
    return launches


def decode_split(torch, dev, probs, names, cfg, reps: int = 5):
    """Where one batch's decode goes (ms, median of ``reps``, host clock
    around synchronised steps): binarize + median filter on the card, the
    copy of the binary events to the host, run-length extraction, and the
    event tables."""
    import numpy as np
    from bsed_tpu_torch.eval.decode import extract_events_batch
    from bsed_tpu_torch.ops.median import threshold_and_filter
    from bsed_tpu_torch.utils.tables import EventTable

    times = {"filter_on_card": [], "copy_to_host": [], "extract": [],
             "tables": []}
    sec = cfg.model.pooling_time_ratio / (cfg.audio.sr / cfg.audio.hop_size)
    labels = np.asarray(cfg.bird_list, dtype=object)
    fnames = np.asarray(names, dtype=object)
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        filtered = threshold_and_filter(probs, EVAL_THRESHOLDS,
                                        window=cfg.median_window)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        act = filtered.to(torch.uint8).cpu().numpy()
        t2 = time.perf_counter()
        k_i, b_i, c_i, on_t, off_t = extract_events_batch(act)
        t3 = time.perf_counter()
        EventTable(labels[c_i], on_t * sec, off_t * sec, fnames[b_i])
        t4 = time.perf_counter()
        for key, a, b in (("filter_on_card", t0, t1), ("copy_to_host", t1, t2),
                          ("extract", t2, t3), ("tables", t3, t4)):
            times[key].append((b - a) * 1e3)
    return {k: sorted(v[1:])[reps // 2] for k, v in times.items()}


def loader_train_path(torch, dev, card, random_batch_ms):
    """The flagship train step fed by a ``ThreeStreamLoader`` resident on
    the card (12 SYN + 12 real full-width clips of ``SyntheticDataSource``,
    the unlabelled stream weak-only), the loader's gather inside the
    timing. One state takes 2 warm-up steps of each feed, then four turns
    of 5 steps: loader, random batch, random batch, loader (the random
    batch is ``train_path``'s, whose own ms a step is printed beside).
    Gates: the batches carry exactly the keys, shapes and dtypes
    ``train_path`` feeds, on the card; the losses are finite; K2 launches
    6 and K3 3 times a step."""
    from bsed_tpu_torch.data.datasets import SyntheticDataSource
    from bsed_tpu_torch.data.pipeline import ThreeStreamLoader
    from bsed_tpu_torch.ops import stem_epilogue as se

    cfg, state, step, batch = train_setup(torch, dev, "bfloat16", True,
                                          B_TRAIN)
    n_steps = 2 + 2 * N_TIMED
    t0 = time.perf_counter()
    syn = SyntheticDataSource(cfg, n_items=n_steps * B_TRAIN, seed=1)
    weak = SyntheticDataSource(cfg, n_items=2 * B_TRAIN, seed=2)
    unlab = SyntheticDataSource(cfg, n_items=2 * B_TRAIN, seed=3,
                                weak_only=True)
    for src in (syn, weak, unlab):
        src.as_arrays()
    loader = ThreeStreamLoader(syn, weak, unlab, batch_size=B_TRAIN,
                               seed=0, device=dev)
    batches = loader.epoch(0)
    first = next(batches)
    setup_s = time.perf_counter() - t0
    spec = lambda b: {k: (tuple(v.shape), str(v.dtype), v.device.type)  # noqa
                      for k, v in b.items()}
    assert spec(first) == spec(batch), (spec(first), spec(batch))
    for b in (first, next(batches), batch, batch):
        step(state, b, 1, 30.0)
    torch.cuda.synchronize()

    se.stem_epilogue_fwd.launches = 0
    se.stem_epilogue_bwd.launches = 0
    turns, gather_ms = [], 0.0
    for feed in ("loader", "random", "random", "loader"):
        t0 = time.perf_counter()
        for _ in range(N_TIMED):
            if feed == "loader":
                g0 = time.perf_counter()
                b = next(batches)
                gather_ms += (time.perf_counter() - g0) * 1e3
            else:
                b = batch
            metrics = step(state, b, 1, 30.0)
        torch.cuda.synchronize()
        turns.append((feed, (time.perf_counter() - t0) / N_TIMED * 1e3))
        values = {k: float(v) for k, v in metrics.items()}
        assert all(math.isfinite(v) for v in values.values()), values
    launches = {"stem_epilogue_train": se.stem_epilogue_fwd.launches,
                "stem_epilogue_bwd": se.stem_epilogue_bwd.launches}
    assert launches == {"stem_epilogue_train": 6 * 4 * N_TIMED,
                        "stem_epilogue_bwd": 3 * 4 * N_TIMED}, launches
    mean = lambda f: sum(ms for k, ms in turns if k == f) / 2  # noqa: E731
    emit(phase="loader_train_path", preset="baseline_mt_isp",
         config="perf_config", compute_dtype="bfloat16", batch_syn=B_TRAIN,
         batch_real=B_TRAIN, steps_per_turn=N_TIMED, resident=True,
         data_setup_s=setup_s, turns_ms_per_step=turns,
         ms_per_step=mean("loader"), ms_per_step_random_turns=mean("random"),
         ms_per_step_train_path=random_batch_ms,
         loader_host_ms_per_step=gather_ms / (2 * N_TIMED),
         clips_per_s=2 * B_TRAIN / mean("loader") * 1e3,
         batch_spec=spec(first), launches=launches,
         launches_per_step={k: v / (4 * N_TIMED)
                            for k, v in launches.items()},
         loss=values["loss"], card=card)


N_FIT_SYN = 96                    # trainer_path's -s: SYN clips (+48 + 48 + 24)
FIT_STEPS = N_FIT_SYN // B_TRAIN  # steps an epoch
FIT_VAL_BATCHES = 2               # 24 val clips at B=12


def _counters():
    """The wrappers whose launch counts trainer_path reads: K2 (both
    forms), K3, K4."""
    from bsed_tpu_torch.ops import gru_kernel, stem_epilogue as se
    return (se.stem_epilogue_fwd, se.stem_epilogue_bwd,
            gru_kernel.gru_bidir_recurrence)


def _launch_counts():
    return tuple(c.launches for c in _counters())


class FitRecorder:
    """Wraps ``Trainer.train_epoch``, ``Trainer.evaluate``,
    ``Trainer.resume``, ``CheckpointManager.save`` and the loaders' data
    preparation (``ThreeStreamLoader.epoch_arrays``, ``EvalLoader.prepare``:
    the first call makes the dataset's arrays and moves them to the card)
    for the length of a ``with`` block: each call's wall seconds (the card
    synchronised at its end), the kernel launches it made (K2 forward, K3,
    K4 counters before and after), the run it belongs to, and the object
    it ran on."""

    def __init__(self, torch):
        self.torch = torch
        self.run = None
        self.calls = []
        self._saved = []

    def _wrap(self, owner, name, kind):
        fn = getattr(owner, name)

        def wrapper(obj, *a, **k):
            c0 = _launch_counts()
            t0 = time.perf_counter()
            out = fn(obj, *a, **k)
            self.torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            k2, k3, k4 = (after - before for before, after
                          in zip(c0, _launch_counts()))
            self.calls.append({"run": self.run, "kind": kind, "obj": obj,
                               "s": seconds, "k2": k2, "k3": k3, "k4": k4})
            return out
        self._saved.append((owner, name, fn))
        setattr(owner, name, wrapper)

    def __enter__(self):
        from bsed_tpu_torch.data.pipeline import EvalLoader, ThreeStreamLoader
        from bsed_tpu_torch.train.trainer import Trainer
        from bsed_tpu_torch.utils.checkpoint import CheckpointManager
        for name in ("train_epoch", "evaluate", "resume"):
            self._wrap(Trainer, name, name)
        self._wrap(CheckpointManager, "save", "save")
        self._wrap(ThreeStreamLoader, "epoch_arrays", "train_data")
        self._wrap(EvalLoader, "prepare", "eval_data")
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)

    def of(self, run, kind=None):
        return [c for c in self.calls if c["run"] == run
                and (kind is None or c["kind"] == kind)]

    def epochs(self, run):
        """Per epoch of ``run``: seconds of train, evaluate, checkpoint,
        and the loaders' data preparation inside train and evaluate."""
        out, data = [], {"train_data": 0.0, "eval_data": 0.0}
        for c in self.of(run):
            if c["kind"] in data:
                data[c["kind"]] += c["s"]
            elif c["kind"] == "train_epoch":
                out.append({"train": c["s"], "evaluate": 0.0,
                            "checkpoint": 0.0,
                            "data_in_train": data["train_data"]})
                data["train_data"] = 0.0
            elif out and c["kind"] == "evaluate":
                out[-1]["evaluate"] += c["s"]
                out[-1]["data_in_evaluate"] = data["eval_data"]
                data["eval_data"] = 0.0
            elif out and c["kind"] == "save":
                out[-1]["checkpoint"] += c["s"]
        return out


def read_results(path):
    """results.tsv as a list of {column: float}."""
    import csv
    with open(path, newline="") as fh:
        return [{k: float(v) for k, v in row.items()}
                for row in csv.DictReader(fh, delimiter="\t")]


def row_distance(a: dict, b: dict) -> float:
    """The largest relative distance |a−b| / max(|a|, |b|) over the keys
    of two results rows (0 where both are 0)."""
    assert a.keys() == b.keys(), (sorted(a), sorted(b))
    worst = 0.0
    for k in a:
        x, y = float(a[k]), float(b[k])
        if x != y:
            worst = max(worst, abs(x - y) / max(abs(x), abs(y)))
    return worst


def trace_busy_share(trace_dir):
    """(device busy share, trace file, its bytes) of the one Chrome trace
    in ``trace_dir``: the union of the device's kernel, copy and set
    intervals over the span of every timed event."""
    import glob
    import os
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    assert len(files) == 1, f"expected one trace in {trace_dir}: {files}"
    with open(files[0]) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                    for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy",
                                        "gpu_memset"))
    assert device, "the trace holds no device event"
    busy, end = 0.0, -math.inf
    for a, b in device:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = (max(float(e["ts"]) + float(e["dur"]) for e in events)
            - min(float(e["ts"]) for e in events))
    return busy / span, files[0], os.path.getsize(files[0])


def state_leaves(state_or_trees):
    """Flattened export_train_state trees (or already-exported trees):
    {path: numpy array or scalar}."""
    import numpy as np
    from bsed_tpu_torch.utils.weights import export_train_state
    trees = (state_or_trees if isinstance(state_or_trees, dict)
             else export_train_state(state_or_trees))

    def leaves(tree, prefix=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, prefix + (k,))
        else:
            yield prefix, np.asarray(tree)
    return dict(leaves(trees))


def same_bits(a: dict, b: dict) -> bool:
    import numpy as np
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def trainer_path(torch, dev, card, train_ms):
    """Train, validate, checkpoint and resume on the card through the
    CLI's ``main``, as a user does (``baseline_mt_isp --perf``, full width,
    SyntheticDataSource at -s 96: 96 SYN + 48 weak + 48 unlabelled + 24
    val clips, resident; B = 12 + 6 + 6, so an epoch is 8 steps and
    validation 2 batches of 12). cuDNN runs deterministic algorithms
    (``torch.backends.cudnn.deterministic``) for the phase, so that a
    resumed epoch can be held against the uninterrupted one:

      A: train --preset baseline_mt_isp --perf -s 96 --epochs 2 (its first
         epoch profiled through --profile-dir);
      B: train --store-dir A --resume --epochs 3 (continues at epoch 2);
      C: a fresh train ... --epochs 3 (the uninterrupted epoch 2);
      D: eval --store-dir A, no preset.

    Gates: every train epoch launches K2's train form 48 and K3 24 times,
    every evaluate K2's eval form 6 and K4 4 times; every results.tsv value
    is finite, one row an epoch; A's final state, its epoch_1 file and
    epoch_1 restored into a fresh state are bit for bit the same; the
    card's noise floor (epoch 2 run twice from one restored epoch_1, in the
    phase's setting and again with cuDNN free to choose) and B's epoch-2
    row against C's: within 2× the floor, or bit-identical when the floor
    is 0 (and B's final state C's, bit for bit, where the two runs of the
    floor end in the same bits); D's scores equal the val scores of the
    best epoch (B's one row) to 1e-6; one trace file exists. Returns the
    launches of run A (K2's train and eval forms apart)."""
    import os
    import tempfile

    from bsed_tpu_torch import cli
    from bsed_tpu_torch.config import config_from_dict
    from bsed_tpu_torch.train.steps import create_train_state
    from bsed_tpu_torch.train.trainer import Trainer
    from bsed_tpu_torch.utils.checkpoint import CheckpointManager

    s_flag = ["-s", str(N_FIT_SYN)]
    torch.backends.cudnn.deterministic = True
    rec = FitRecorder(torch)
    try:
        with tempfile.TemporaryDirectory() as tmp, rec:
            a, c = os.path.join(tmp, "a"), os.path.join(tmp, "c")
            trace_dir = os.path.join(tmp, "trace")
            wall = {}
            for run, argv in (
                    ("A", ["train", "--preset", "baseline_mt_isp", "--perf",
                           *s_flag, "--epochs", "2", "--store-dir", a,
                           "--profile-dir", trace_dir]),
                    ("B", ["train", "--store-dir", a, "--resume", *s_flag,
                           "--epochs", "3"]),
                    ("C", ["train", "--preset", "baseline_mt_isp", "--perf",
                           *s_flag, "--epochs", "3", "--store-dir", c]),
                    ("D", ["eval", "--store-dir", a, *s_flag])):
                rec.run = run
                if run == "A":
                    for counter in _counters():
                        counter.launches = 0
                t0 = time.perf_counter()
                out = cli.main(argv)
                torch.cuda.synchronize()
                wall[run] = time.perf_counter() - t0
                if run == "A":
                    totals_a = _launch_counts()
                    rows_a = read_results(os.path.join(a, "results.tsv"))
                    trainer_a = rec.of("A", "train_epoch")[-1]["obj"]
                    final_a = state_leaves(trainer_a.state)
                    busy, trace_file, trace_bytes = trace_busy_share(
                        trace_dir)
                    ckpt = CheckpointManager(a)
                    ckpt_bytes = os.path.getsize(ckpt.state_file("epoch_1"))
                    saved = state_leaves(ckpt.load("epoch_1"))
                    fresh = create_train_state(trainer_a.cfg,
                                               trainer_a.modules, seed=99)
                    t0 = time.perf_counter()
                    ckpt.restore("epoch_1", fresh)
                    torch.cuda.synchronize()
                    restore_s = time.perf_counter() - t0
                    restored = state_leaves(fresh)
                    del fresh
                elif run == "B":
                    rows_b = read_results(os.path.join(a, "results.tsv"))
                elif run == "D":
                    scores_d = out
            rows_c = read_results(os.path.join(c, "results.tsv"))

            # the card's noise floor: epoch 2 twice from restored epoch_1,
            # in the phase's setting and with cuDNN free to choose
            args = cli.build_parser().parse_args(
                ["train", "--store-dir", a, *s_flag])
            cfg = config_from_dict(CheckpointManager(a).load_meta()["config"])
            train_loader, val_loader, _ = cli._dataset_loaders(cfg, args)
            floor_trainer = Trainer(cfg, train_loader, val_loader=val_loader,
                                    store_dir=os.path.join(tmp, "floor"),
                                    device=dev)
            floor_trainer.ckpt = CheckpointManager(a)    # reads A's epoch_1
            floors, floor_states = {}, {}
            for deterministic in (True, False):
                torch.backends.cudnn.deterministic = deterministic
                rec.run = f"floor_{deterministic}"
                rows, states = [], []
                for _ in range(2):
                    floor_trainer.resume(2)
                    row = {"epoch": 2.0, **floor_trainer.train_epoch(2)}
                    row.update({f"val_{k}": v for k, v in
                                floor_trainer.evaluate(val_loader).items()})
                    rows.append(row)
                    states.append(state_leaves(floor_trainer.state))
                floors[deterministic] = row_distance(*rows)
                floor_states[deterministic] = same_bits(*states)
            torch.backends.cudnn.deterministic = True
    finally:
        torch.backends.cudnn.deterministic = False

    launches = check_fit_launches(rec, totals_a)
    # results: finite, one row an epoch
    for rows, epochs in ((rows_a, [0, 1]), (rows_b, [2]),
                         (rows_c, [0, 1, 2])):
        assert [r["epoch"] for r in rows] == epochs, rows
        assert all(math.isfinite(v) for r in rows for v in r.values()), rows
    # the checkpoint round trip, bit for bit
    assert same_bits(saved, final_a), "epoch_1 differs from A's state"
    assert same_bits(restored, saved), "restored epoch_1 differs"
    # resume against the uninterrupted run
    distance = row_distance(rows_b[0], rows_c[2])
    trainer_b = rec.of("B", "train_epoch")[-1]["obj"]
    trainer_c = rec.of("C", "train_epoch")[-1]["obj"]
    states_equal = same_bits(state_leaves(trainer_b.state),
                             state_leaves(trainer_c.state))
    # evaluation of the store against the best epoch's val scores
    best = rows_b[0]      # B's SaveBest is fresh: its one epoch is best
    eval_err = max(abs(scores_d["event_f1"] - best["val_event_f1"]),
                   abs(scores_d["psds_f1"] - best["val_psds_f1"]))

    split_a = rec.epochs("A")
    split_c = rec.epochs("C")
    saves = [c["s"] for c in rec.calls if c["kind"] == "save"]
    step_ms = {run: [(e["train"] - e["data_in_train"]) / FIT_STEPS * 1e3
                     for e in rec.epochs(run)] for run in ("A", "C")}
    floor_ms = {str(k): [c["s"] / FIT_STEPS * 1e3 for c in
                         rec.of(f"floor_{k}", "train_epoch")]
                for k in (True, False)}
    emit(phase="trainer_path", preset="baseline_mt_isp", config="--perf",
         cli="python -m bsed_tpu_torch.cli", clips={
             "syn": N_FIT_SYN, "weak": N_FIT_SYN // 2,
             "unlabeled": N_FIT_SYN // 2, "val": N_FIT_SYN // 4},
         batch={"syn": B_TRAIN, "weak": B_TRAIN // 2,
                "unlabeled": B_TRAIN // 2, "val": B_TRAIN},
         steps_per_epoch=FIT_STEPS, cudnn_deterministic=True,
         epoch_seconds_a=split_a, epoch_seconds_c=split_c,
         ms_per_step_fit=step_ms, ms_per_step_fit_is="train seconds less "
         "the loader's data preparation, over 8 steps",
         ms_per_step_fit_cudnn_free=floor_ms["False"],
         ms_per_step_fit_floor_runs=floor_ms["True"],
         ms_per_step_train_path=train_ms,
         device_busy_share_profiled_epoch=busy, trace_file=os.path.basename(
             trace_file), trace_bytes=trace_bytes,
         checkpoint_bytes=ckpt_bytes, save_ms=[x * 1e3 for x in saves],
         restore_s=restore_s,
         resume_s=[c["s"] for c in rec.of("B", "resume")],
         wall_s=wall,
         launches_run_a=launches,
         launches_per_epoch={"stem_epilogue_train": 6 * FIT_STEPS,
                             "stem_epilogue_bwd": 3 * FIT_STEPS},
         launches_per_evaluate={"stem_epilogue": 3 * FIT_VAL_BATCHES,
                                "gru_kernel": 2 * FIT_VAL_BATCHES},
         noise_floor=floors[True], noise_floor_cudnn_free=floors[False],
         noise_floor_states_bit_identical=floor_states[True],
         noise_floor_states_bit_identical_cudnn_free=floor_states[False],
         resume_distance=distance, resume_state_bit_identical=states_equal,
         eval_scores={"event_f1": scores_d["event_f1"],
                      "psds_f1": scores_d["psds_f1"]},
         eval_vs_results_max_err=eval_err,
         val_scores=[{k: r[k] for k in r if k.startswith("val_")}
                     for r in rows_c],
         loss=[r["loss"] for r in rows_c], card=card)
    floor = floors[True]
    if floor == 0.0:
        assert distance == 0.0, \
            f"resumed epoch 2 differs from the uninterrupted one: {distance}"
    if floor_states[True]:
        assert states_equal, "the resumed run's state differs from the " \
            "uninterrupted run's, where an epoch run twice does not"
    else:
        assert distance <= 2 * floor, \
            f"resume distance {distance} > 2 × the noise floor {floor}"
    assert eval_err <= 1e-6, f"eval --store-dir differs by {eval_err}"
    return launches


def check_fit_launches(rec, totals_a):
    """Every train epoch of every run launched K2's train form 6 and K3 3
    times a step (K4 never), every evaluate K2's eval form 3 and K4 2
    times a batch; run A's counters, set to 0 before it, hold exactly its
    calls' launches. Returns run A's launches by kernel entry."""
    for call in rec.calls:
        if call["kind"] == "train_epoch":
            assert (call["k2"], call["k3"], call["k4"]) == (
                6 * FIT_STEPS, 3 * FIT_STEPS, 0), call
        elif call["kind"] == "evaluate":
            assert (call["k2"], call["k3"], call["k4"]) == (
                3 * FIT_VAL_BATCHES, 0, 2 * FIT_VAL_BATCHES), call
    epochs_a = rec.of("A", "train_epoch")
    evals_a = rec.of("A", "evaluate")
    launches = {
        "stem_epilogue_train": sum(e["k2"] for e in epochs_a),
        "stem_epilogue_bwd": sum(e["k3"] for e in epochs_a),
        "stem_epilogue": sum(e["k2"] for e in evals_a),
        "gru_kernel": sum(e["k4"] for e in evals_a)}
    assert totals_a == (launches["stem_epilogue_train"]
                        + launches["stem_epilogue"],
                        launches["stem_epilogue_bwd"],
                        launches["gru_kernel"]), (totals_a, launches)
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile-dir", default=None,
                        help="write the profile tables here")
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
    PTXAS.update(reports)
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
    torch.cuda.empty_cache()
    eval_launches = eval_path(torch, dev, smi)
    torch.cuda.empty_cache()

    k5 = check_stem_kernel(torch, dev)
    k5["launches"] = fused_stem_path(torch, dev, smi,
                                     args.profile_dir)["stem_kernel"]
    k4 = check_gru_kernel(torch, dev)
    k4["launches"] = launches["gru_kernel"]
    bigru_forms(torch, dev, smi)
    torch.cuda.empty_cache()

    k2t, k3 = check_stem_epilogue_train(torch, dev)
    train_launches, train_ms = train_path(torch, dev, smi, args.profile_dir)
    launches.update(train_launches)
    torch.cuda.empty_cache()
    loader_train_path(torch, dev, smi, train_ms)
    torch.cuda.empty_cache()
    fit_launches = trainer_path(torch, dev, smi, train_ms)
    torch.cuda.empty_cache()
    train_equality(torch, dev)
    torch.cuda.empty_cache()
    k2pg, k3pg = check_stem_epilogue_pg(torch, dev)

    for k in (k1, k2, k2t, k3):
        k["launches"] = launches[k["name"]]
    for k in (k2, k4):           # the eval path's run, 4 batches of 64
        k["launches_eval_path"] = eval_launches[k["name"]]
    for k in (k2, k2t, k3, k4):  # run A of trainer_path: 2 epochs, 2 evals
        k["launches_trainer_path"] = fit_launches[k["name"]]
    kernels_line = [k1, k2, k2t, k3, k5, k4, k2pg, k3pg]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
