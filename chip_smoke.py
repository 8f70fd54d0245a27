"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--profile-dir DIR] [--only PHASE[,PHASE]]

Builds the port's CUDA kernels from ``bsed_tpu_torch/csrc`` (nvcc, at first
use, all sources in parallel) and drives every slice of the port:

  * serving: K1 (mel, an FFT kernel) and K2's eval form against their
    plain PyTorch versions at the serving shapes, K1 also against a
    float64 ``torch.stft`` golden on a few clips, with K1's bound counted
    from the function's work (real FFT, |·|, banded mel); then the serving
    path
    (``make_fast_forward`` on preset ``baseline``, bf16, precision 'high',
    B=64 full 10 s clips, random weights from seed 0), which must launch K1
    once, K2 three times in its lane form (blocks 0-2) and four in its
    group-pool form (blocks 3-6) and K4 twice (the hoisted BiGRU, one call
    a layer) per batch, a profiled batch (device time, busy share,
    launches), and the float32 kernel path against the plain path;
  * HTS-AT's front end (``mel_kernel_htsat``): K1's power-dB form
    (periodic Hann, |X|², Slaney area-normalised bands, unclamped dB) at
    N = 1024, H = 320, 64 mels, B=64 ten-second clips against its plain
    version and a float64 golden, timed beside its bound, its plain
    version and the dense torchlibrosa front end it replaced, with the
    magnitude form re-timed at the CRNN's shape; then ``htsat`` served at
    B=64, whose ``bsed.serve.mel`` span must launch K1 alone, once a
    forward (counters and the profiler's trace), and the forward no
    float32 GEMM;
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
    on the card at B=64, with the kernels (K2 eval seven times and K4
    twice a batch) and on their plain versions: scores, wall seconds by
    phase, clips/s, posteriors within the float32 serving gate, every
    flipped binarized frame within that gate of the threshold, and card
    and host decoding giving identical event tables;
  * raw audio in (``raw_audio_path``): ``python -m bsed_tpu_torch.cli
    predict`` in a subprocess on a 10-minute 44.1 kHz int16 stereo WAV
    and a 3 s ``.npy`` (precision 'high'), and on a 60 s 32 kHz WAV at a
    5 s hop (B = 11) with ``--precision highest`` (TF32 must be off):
    seconds by part, recording-seconds per wall-second, events; then
    ``predict.predict_recordings`` in-process on the same inputs with the
    kernels (K1, K2 eval and K4 exactly 1, 7 and 2 times a forward call)
    and on their plain versions (posteriors within 2e-3, events decoded
    on the card and on the host identical); ``preprocess`` of an
    ENA-layout root (2 domains × 3 annotated 5-minute recordings: dumps a
    second, seconds by part, dumps against a float64 ``torch.stft``
    golden at 1e-3 dB, split counts equal to ``seeded_split``'s); and
    ``synthesize --features-out`` of 64 full-length soundscapes;
  * the loader-fed train step: a ``ThreeStreamLoader`` resident on the
    card feeds the flagship train step (same keys, shapes and dtypes as
    the random batch), ms a step beside the random-batch step's;
  * the trainer (``trainer_path``): ``python -m bsed_tpu_torch.cli train
    --preset baseline_mt_isp --perf -s 96`` through the CLI's ``main`` —
    2 epochs (the first profiled), a resume to a third, a fresh 3-epoch
    run and ``eval --store-dir`` — with K2's train form 48 and K3 24 times
    an epoch and K2's eval form 14 and K4 4 times an evaluate, finite
    results, a bit-exact checkpoint round trip, the resumed epoch against
    the uninterrupted one within the card's measured noise floor, and the
    store's evaluation equal to the best epoch's val scores; seconds an
    epoch by part, ms a step, busy share, checkpoint bytes and save ms;
  * BEATs' gated relative-position attention (``check_rel_attention``,
    ``csrc/rel_attention.cu``) at the serving cell's shape (B=64, 12 heads
    of 64, 496 tokens, bf16, q, k and v as the model's views) against its
    plain version in float32, with a zero bias and a unit gate, its
    float32 body at B=8, no (B, H, L, L) allocation inside the call; its
    time beside the plain version's and, as ``library_ms``, the form the
    port ran before it (g ⊙ P materialised as the mask of
    ``F.scaled_dot_product_attention``, which the port no longer calls);
    BEATs' position convolution with its residual (``pos_conv_times``,
    ``csrc/pos_conv.cu``) at the cell's shape (B=64, 496 tokens, 16
    groups of 48, 128 taps, bf16) against its plain version: its time
    and bound beside cuDNN's TF32 grouped convolution as the port called
    it before, registers and spills; then ``crnn_beats`` served through
    ``make_fast_forward`` at B=64, bf16 'high' (``beats_path``): the
    attention's counter 12 a forward and the position convolution's 1,
    the profiler's launches of each kernel and none of a library
    attention or convolution, clips/s, and the kernels' device ms a batch;
  * K2's and K3's group-pool form against their plain versions at the
    shapes of blocks 3-6 (B=72, G=16/8/4/2), with the body that served
    each dtype (bfloat16: wgmma for both), and K2's eval form as serving
    runs it (B=64, no bits, bf16); then serving's blocks 3-6 as
    ``_RestCNN``'s ConvBlock chain against ``serve.GroupPoolCNN`` (conv +
    K2-pg), bf16 at B=64 and float32 at B=32: ms, device ms and launches
    a forward of each (``group_pool_cnn_path``);
  * every preset that trains without a discriminator (``presets_path``):
    12 SYN + 12 real full-width clips (origin: a combined real batch of
    24), random weights from seed 0, 2 warm-up and 3 timed steps of each
    in its reference-parity form (float32, unfolded, stream by stream:
    no kernel may launch) and of each foldable one in its --perf form,
    bf16 (K2's train form and K3 exactly ``PERF_LAUNCHES`` a step: origin
    18 / 12, the others 6 / 3 or 3 / 3); origin's and scmt's float32
    kernel step against the plain step at ``train_equality``'s gates;
    ``make_predict_fn`` on an FPN tree at B=64 (K4 6 times a batch at
    T = 313, 156 and 78) within 2e-3 of the plain versions; ``train
    --preset origin --perf -s 96`` and ``train --preset
    baseline_fpn_mt_isp -s 48`` for one epoch, each with ``eval
    --store-dir``, with exact launches and finite results;
  * the adaptation stage (``adaptation_path``): the nine runs with a
    discriminator (``DA_RUNS``: GRL pre-step, joint domain loss, ADDA),
    12 SYN + 12 real full-width clips (origin 24), 2 warm-up and 2 timed
    steps (state steps 2 and 3: ADDA's update_step 2 updates, then skips)
    in the reference-parity form (no kernel) and the --perf form (K2's
    train form and K3 exactly ``DA_PERF_LAUNCHES`` / ``DA_SKIP_LAUNCHES``
    a step), with ms a step, finite loss and domain loss and peak device
    memory (run d holds the 2.63 GB randomized map, whose card draw is
    first held bit-equal to the CPU draw at both ends of R_f and all of
    R_g, with each draw's seconds); runs a and h's float32
    kernel step against the plain step; ``train --preset
    baseline_adaptation --perf -s 96``, a resume at the stage boundary
    (the discriminator fresh, the rest from epoch_0) and ``eval
    --store-dir`` through the CLI's ``main``;
  * the weak tagger (``tagger_path``): ResNet-18 and VGG
    (``TaggingTrainer``), each with and without its mean teacher, at 12
    SYN + 12 real full-width clips: the step's operations, 2 warm-up and
    5 timed steps with TF32 off and on, peak memory and one profiled step
    (busy share, launches); ResNet with its teacher and VGG on the card
    against the CPU (2 + 2 clips, TF32 off: posteriors, loss, statistics,
    Adam's moment); then ``tag-train --weights-file`` an ImageNet-shaped
    torchvision state dict and ``pseudo-label`` through the CLI in
    subprocesses (TF32 off, as they print) on a full-width ``--data-root``
    and ``train --preset baseline_mt_isp --perf --pseudo-labels``
    in-process, with K2's train form and K3 exactly 6 and 3 times a step
    and K2's eval form and K4 7 and 2 times a validation batch;
  * the learning gate (``learning_gate``): ``bsed_tpu``'s event-F1 gate
    (``baseline_mt_isp`` at 3.2 kHz, 4 s clips, 128 training clips,
    evaluated every 20 epochs for up to 300: decode-path oracle > 0.9,
    best event F1 >= 0.10) in the reference form, and the --perf form's
    trajectory beside it, the two forms in two processes on the card;
  * the 'crnn' head and recurrent dropout (``crnn_head_path``, item 8c):
    ``baseline_mt_isp`` with the head and with recurrent dropout 0.5, and
    ``baseline_fpn_mt_isp`` with it (three GRUs), at 12 + 12 full-width
    clips in the reference form and (not FPN) the --perf form: ms and
    launches a step (K2's train form 6 and K3 3 a --perf step), the
    head's running statistics moving, the recurrent masks' drop share
    within 4σ of the rate; the float32 --perf step with the head and
    with recurrent dropout, kernels against plain versions at
    ``train_equality``'s gates; the head served by ``make_fast_forward``
    at B=64, float32 (standard branch: K1 once and K4 twice a batch;
    fused stem: K5 once more), against the plain versions; a one-epoch
    ``Trainer.fit`` with both into a store, then ``eval --store-dir`` and
    ``predict`` on it through the CLI in subprocesses;
  * data parallelism (``data_parallel_path``): ``train --mesh auto``
    through torchrun with one NCCL rank, the flagship --perf step on 2
    gloo ranks sharing the card against 1 rank in float32 and bf16 (the
    gaps against ``DP_GATES``), a 2-rank Trainer epoch against the 1-rank
    epoch, and ``make_sharded_forward`` with two replicas of the card at
    B=64 against the single forward, with each one's times and launches.

One JSON line per phase; then the card's name and power limit as
nvidia-smi gives them, the kernels line, and last ``{"ok": true,
"device": {...}}``. Any failure exits non-zero before the last line. Needs
one CUDA device; imports no JAX. ``--profile-dir`` also writes the
torch.profiler tables of one serving batch, one fused-stem batch, one
train step, one step of each of ``PROFILED_PRESETS``, one of
``DA_PROFILED`` and one of each tagger to ``DIR/serve_profile.txt``,
``DIR/fused_stem_profile.txt``, ``DIR/train_profile.txt``,
``DIR/<preset>_<form>_profile.txt``, ``DIR/da_<run>_<form>_profile.txt``
and ``DIR/tagger_<arch>[_mt]_tf32_<off|on>_profile.txt``.
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
K2_LANE, K2_PG = 3, 4             # K2 eval launches a folded eval forward:
K2_EVAL = K2_LANE + K2_PG         # blocks 0-2, then group-pooled 3-6
BF16_GRAD_GATE = 5e-2             # relative Frobenius error, bf16 grads


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def kernels_if(on: bool):
    """A ``with`` context: the kernels as they run by default (``on``), or
    ``kernels.plain_versions()``, every kernel entry on its plain version
    on the card too."""
    import contextlib
    from bsed_tpu_torch import kernels
    return contextlib.nullcontext() if on else kernels.plain_versions()


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
    whose mangled name contains ``needle``, from this run's ptxas report
    or, where another process built the library, the report kept beside
    it: the largest over the template instances, and how many there are.
    None when neither is there."""
    import re
    from bsed_tpu_torch import kernels
    log = PTXAS.get(source) or kernels.ptxas_report(source)
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


def span_device_ops(trace_path: str, span: str):
    """Names of the device operations launched while a ``span``
    (``record_function``) was open on the launching thread, read from a
    torch.profiler chrome trace by each launch's correlation id."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    opened = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"])
              for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation" and e.get("name") == span]
    inside = {e["args"]["correlation"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})
              and any(a <= float(e["ts"]) < b and e["tid"] == t
                      for a, b, t in opened)}
    return [e["name"] for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and e.get("args", {}).get("correlation") in inside]


def mel_kernel_htsat(torch, dev, card):
    """K1's power-dB form at HTS-AT's geometry (N = 1024, H = 320, 64
    Slaney mels, periodic Hann; B=64 ten-second clips, T = 1001) against
    its plain version and a float64 ``torch.stft`` golden (power, Slaney,
    unclamped dB) on a few clips, 1e-3 dB; its time (one call between
    events, pipelined, and device time by the profiler) beside its bound,
    the plain version's and the dense torchlibrosa front end's (the form
    HTS-AT ran before, like for like: both give the log-mel), and the
    launches of one front-end call; the magnitude form re-timed at the
    CRNN's serving shape (``check_mel_kernel``'s); then ``htsat`` served
    at its published widths through ``make_fast_forward`` at B=64, bf16
    'high', weights and audio from the benchmark's harness: K1 once a
    forward in its power-dB form by its counters over ``N_TIMED``
    forwards, and in the profiler's trace of 2 forwards the span
    ``bsed.serve.mel`` launches K1 alone, once a forward, and the forward
    no float32 GEMM."""
    import os
    import tempfile
    import numpy as np
    from torch.profiler import ProfilerActivity, profile as prof
    from bsed_tpu_torch.config import AudioConfig
    from bsed_tpu_torch.ops import mel, mel_kernel
    from bsed_tpu_torch.ops.filterbank import mel_filterbank
    from bsed_tpu_torch.serve import make_fast_forward
    from portbench.harness import htsat as H, synth, weights as Wt
    from portbench.reference import htsat as RH
    from portbench.runners.serve_htsat import port_config

    root = os.path.dirname(os.path.abspath(__file__))
    load = lambda *p: json.load(open(os.path.join(root, "portbench", *p)))  # noqa: E731
    config = load("configs", "htsat.json")
    mix = load("traffic", "serve_htsat_b64.json")
    a = AudioConfig(**{k: v for k, v in config["audio"].items()})
    fb64 = mel_filterbank(a.sr, a.n_window, a.n_mels, a.mel_f_min,
                          a.mel_f_max, dtype=np.float64, norm="slaney")
    kb = mel_kernel.build_mel_kernel_bases(
        a.n_window, a.hop_size, fb64, device=dev,
        window=mel.hann_window(a.n_window), power_db=True)
    audio = synth.clips(25, B_SERVE, config["audio"], mix["audio"], dev)
    args = (kb, a.n_window, a.hop_size, a.n_mels)
    k1 = mel_kernel.fused_block_mel
    before = (k1.launches, k1.launches_db)
    got = mel_kernel.fused_block_mel(audio, *args)
    want = mel_kernel.fused_block_mel_plain(audio, *args)
    win = torch.hann_window(a.n_window, periodic=True, device=dev,
                            dtype=torch.float64)
    spec = torch.stft(audio[:GOLDEN_CLIPS].double(), a.n_window, a.hop_size,
                      window=win, center=True, pad_mode="reflect",
                      return_complex=True)
    power = (spec.real ** 2 + spec.imag ** 2).transpose(1, 2)
    gold = mel.power_to_db(power @ torch.as_tensor(fb64, device=dev),
                           top_db=None)
    dense_fe = mel.MelFrontEnd(a, "dense", dev, torchlibrosa=True)
    dense = dense_fe(audio, log=True)
    torch.cuda.synchronize()
    t = mel.num_frames(a.n_samples, a.hop_size)
    assert got.shape == want.shape == (B_SERVE, t, a.n_mels), got.shape
    assert (k1.launches, k1.launches_db) == (before[0] + 1, before[1] + 1)
    err_db = float((got - want).abs().max())
    err_gold_db = float((got[:GOLDEN_CLIPS].double() - gold).abs().max())
    plain_gold_db = float((want[:GOLDEN_CLIPS].double() - gold).abs().max())
    dense_gold_db = float((dense[:GOLDEN_CLIPS].double() - gold).abs()
                          .max())
    del spec, power, gold, want, dense
    emit(phase="mel_kernel_htsat_check", shape=list(got.shape),
         max_abs_err_db=err_db, golden_clips=GOLDEN_CLIPS,
         max_abs_err_db_vs_f64=err_gold_db,
         plain_max_abs_err_db_vs_f64=plain_gold_db,
         dense_max_abs_err_db_vs_f64=dense_gold_db, gate_db=1e-3)
    assert err_db <= 1e-3, f"K1 power-dB differs by {err_db} dB"
    assert err_gold_db <= 1e-3, f"K1 vs float64 golden: {err_gold_db} dB"

    run = lambda: mel_kernel.fused_block_mel(audio, *args)  # noqa: E731
    ms = time_ms(run, 10)
    ms_pipe = pipelined_ms(run)
    device_ms = kernel_device_ms(torch, run, "mel_fft_kernel")
    plain_ms = time_ms(lambda: mel_kernel.fused_block_mel_plain(
        audio, *args), 3, warmup=1)
    k1_fe = mel.MelFrontEnd(a, "block_kernel", dev, torchlibrosa=True)
    dense_ms = time_ms(lambda: dense_fe(audio, log=True), 10)
    _, _, fe_rows = device_rows(torch, lambda: k1_fe(audio, log=True), 2)
    _, _, dense_rows = device_rows(torch, lambda: dense_fe(audio, log=True),
                                   2)
    fe_rows = [r for r in fe_rows if not r[1].startswith("bsed.")]
    dense_rows = [r for r in dense_rows if not r[1].startswith("bsed.")]
    live = int((kb.bands[:, 0] + kb.bands[:, 1]).max())
    nnz = kb.weights.numel()
    flops = B_SERVE * t * (2.5 * a.n_window * math.log2(a.n_window)
                           + 3 * live + 2 * nnz)
    nbytes = audio.numel() * 4 + got.numel() * 4
    b_ms, b_by = bound(nbytes, {"float32": flops})

    # the magnitude form at the CRNN's serving shape, re-timed
    c = AudioConfig()
    fb_c = mel_filterbank(c.sr, c.n_window, c.n_mels, c.mel_f_min,
                          c.mel_f_max, dtype=np.float64)
    kb_c = mel_kernel.build_mel_kernel_bases(c.n_window, c.hop_size, fb_c,
                                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    audio_c = torch.randn((B_SERVE, c.n_samples), generator=gen, device=dev)
    run_c = lambda: mel_kernel.fused_block_mel(  # noqa: E731
        audio_c, kb_c, c.n_window, c.hop_size, c.n_mels)
    magnitude = {"ms": time_ms(run_c, 10), "ms_pipelined": pipelined_ms(run_c),
                 "device_ms": kernel_device_ms(torch, run_c,
                                               "mel_fft_kernel")}
    del audio_c

    # htsat served: K1 once a forward, the mel span K1 alone
    cfg = port_config(config, mix)
    params = H.make_params(config, 31, dev)
    with torch.no_grad():
        stats = H.bn0_stats(RH.log_mel(audio[:8], config["audio"]))
    forward = make_fast_forward(cfg, Wt.to_numpy(params), Wt.to_numpy(stats),
                                device=dev, precision="high")
    for _ in range(2):                                 # warm-up
        forward(audio)
    torch.cuda.synchronize()
    before = (k1.launches, k1.launches_db)
    t0 = time.perf_counter()
    for _ in range(N_TIMED):
        strong, weak = forward(audio)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = (k1.launches - before[0], k1.launches_db - before[1])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            for _ in range(2):
                forward(audio)
            torch.cuda.synchronize()
        p.export_chrome_trace(path)
        mel_ops = span_device_ops(path, "bsed.serve.mel")
        rows = [r for r in device_rows(torch, lambda: forward(audio), 2)[2]
                if not r[1].startswith("bsed.")]
    f32_gemm = [k for _, k, _ in rows if any(
        w in k.lower() for w in ("gemm", "nvjet")) and any(
        w in k.lower() for w in ("f32f32", "sgemm", "tf32", "_sss_"))]
    rec = {"name": "mel_kernel_power_db", "route": "cuda",
           "source": "bsed_tpu_torch/csrc/mel_kernel.cu",
           "replaces": "none: HTS-AT's torchlibrosa front end (the dense "
                       "float32 DFT the port ran)",
           "shape": list(got.shape), "max_abs_err_db": err_db,
           "max_abs_err_db_vs_f64": err_gold_db, "ms": ms,
           "ms_pipelined": ms_pipe, "device_ms": device_ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": dense_ms,
           "library_call": "MelFrontEnd(dense, torchlibrosa=True): "
                           "frames @ DFT bases, power, mel matmul, dB",
           "front_end_launches": sum(n for _, _, n in fe_rows) / 2,
           "front_end_kernels": [k[:60] for _, k, _ in fe_rows],
           "dense_launches": sum(n for _, _, n in dense_rows) / 2,
           "dense_device_ms": sum(tt for tt, _, _ in dense_rows) / 2e3,
           "gflop_per_call": flops / 1e9, "mb_per_call": nbytes / 1e6,
           "filterbank_nnz": nnz, "live_bins": live,
           "resources": kernel_resources("mel_kernel", "mel_fft_kernel"),
           "magnitude_form": magnitude,
           "htsat_clips_per_s": B_SERVE * N_TIMED / elapsed,
           "htsat_ms_per_batch": elapsed / N_TIMED * 1e3,
           "htsat_launches": launches, "mel_span_ops": mel_ops,
           "float32_gemms": f32_gemm, "card": card,
           "htsat_top": [{"name": k[:70], "ms": tt / 2e3, "calls": n / 2}
                         for tt, k, n in rows[:10]]}
    emit(phase="mel_kernel_htsat", **rec)
    assert strong.shape == (B_SERVE, 1024, cfg.nclass), strong.shape
    assert torch.isfinite(strong).all() and torch.isfinite(weak).all()
    assert launches == (N_TIMED, N_TIMED), launches
    assert len(mel_ops) == 2 and all("mel_fft_kernel" in k
                                     for k in mel_ops), mel_ops
    assert not f32_gemm, f32_gemm
    assert rec["front_end_launches"] == 1, fe_rows
    return rec


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


def serve(dev, compute_dtype):
    from bsed_tpu_torch.config import get_config
    from bsed_tpu_torch.serve import make_fast_forward
    from bsed_tpu_torch.utils.weights import init_params

    cfg = get_config("baseline")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype=compute_dtype))
    params, stats = init_params(cfg, 0)
    return cfg, make_fast_forward(cfg, params, stats, device=dev,
                                  precision="high")


def main_path(torch, dev, card, kernel_ms, profile_dir):
    """The serving path at B=64 full-width clips, bf16, precision 'high';
    K1 must launch once, K2 three times in its lane form (blocks 0-2) and
    four in its group-pool form (blocks 3-6, ``stem_epilogue_pg``), and
    K4 twice (one call a BiGRU layer) per batch."""
    from bsed_tpu_torch.ops import gru_kernel, mel_kernel, stem_epilogue

    cfg, forward = serve(dev, "bfloat16")
    gen = torch.Generator(device=dev).manual_seed(3)
    audio = torch.randn((B_SERVE, cfg.audio.n_samples), generator=gen,
                        device=dev) * 0.1
    for _ in range(2):                                 # warm-up
        forward(audio)
    torch.cuda.synchronize()

    mel_kernel.fused_block_mel.launches = 0
    k2 = stem_epilogue.stem_epilogue_fwd
    k2.launches = k2.launches_pg = 0
    gru_kernel.gru_bidir_recurrence.launches = 0
    t0 = time.perf_counter()
    for _ in range(N_TIMED):
        strong, weak = forward(audio)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"mel_kernel": mel_kernel.fused_block_mel.launches,
                "stem_epilogue": k2.launches - k2.launches_pg,
                "stem_epilogue_pg": k2.launches_pg,
                "gru_kernel": gru_kernel.gru_bidir_recurrence.launches}

    assert strong.shape == (B_SERVE, cfg.n_frames, cfg.nclass), strong.shape
    assert weak.shape == (B_SERVE, cfg.nclass), weak.shape
    assert torch.isfinite(strong).all() and torch.isfinite(weak).all()
    assert launches == {"mel_kernel": N_TIMED,
                        "stem_epilogue": K2_LANE * N_TIMED,
                        "stem_epilogue_pg": K2_PG * N_TIMED,
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
    cfg, fwd = serve(dev, "float32")
    audio = torch.randn((8, cfg.audio.n_samples), generator=gen,
                        device=dev) * 0.1
    sk, wk = fwd(audio)
    with kernels_if(False):
        sp, wp = fwd(audio)
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


def fused_stem_forward(dev, **kw):
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
                                  precision="high", **kw)


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
    with kernels_if(False):
        sp, wp = fused_stem_forward(dev, use_fused_stem=True)[1](audio)
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
        with kernels_if(False):
            want = HoistedBiGRU(module(None))(x)
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
    over blocks 3-6; ``launches_timed`` counts those timed calls. Then
    K2-pg's eval form as serving runs it (``serve.GroupPoolCNN``): B=64,
    no bits, pt=1, pg=2, bf16, GLU and CG against the plain version at the
    bf16 gate, timed for GLU and summed over blocks 3-6 (``eval_form``)."""
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
    ev = {"ms": 0.0, "ms_pipelined": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
          "bound_ms": 0.0, "max_abs_err": 0.0, "blocks": []}
    for blk, g in PG_BLOCKS:
        h = torch.randn((B_SERVE, t_in, g, 128), generator=gen,
                        device=dev).bfloat16()
        w = (torch.randn((128, 128), generator=gen, device=dev)
             / 128 ** 0.5).bfloat16()
        inv = 1.0 + 0.2 * torch.randn(128, generator=gen, device=dev)
        cvec = 0.3 * torch.randn(128, generator=gen, device=dev)
        bvec = 0.1 * torch.randn(128, generator=gen, device=dev)
        for act in ("glu", "cg"):
            args = (h, inv, cvec, w, bvec, act, 1, None)
            got = se.stem_epilogue_fwd(*args, 0, pg=2)
            want = se.stem_epilogue_plain(*args, pg=2)
            torch.cuda.synchronize()
            dfw = (got.float() - want.float()).abs()
            emit(phase="check_stem_epilogue_pg", form="eval", block=blk,
                 G=g, pt=1, pg=2, bits=False, dtype="bfloat16",
                 batch=B_SERVE, act=act, fwd_max_abs_err=float(dfw.max()))
            assert bool((dfw <= 0.06 + 0.06 * want.float().abs()).all()), \
                f"K2-pg eval form, block {blk} {act} B={B_SERVE}"
            ev["max_abs_err"] = max(ev["max_abs_err"], float(dfw.max()))
        args = (h, inv, cvec, w, bvec, "glu", 1, None)
        run = lambda: se.stem_epilogue_fwd(*args, 0, pg=2)  # noqa: E731
        n = h.numel()
        # h read, the pooled map written, w and 3 vectors; 1 bf16 product
        t = {"ms": time_ms(run, 10), "ms_pipelined": pipelined_ms(run),
             "device_ms": kernel_device_ms(torch, run, "epilogue_pg"),
             "plain_ms": time_ms(lambda: se.stem_epilogue_plain(
                 *args, pg=2), 5),
             "bound_ms": bound(n * 2 + got.numel() * 2 + w.numel() * 2
                               + 3 * 512, {"bfloat16": n * 128 * 2})[0]}
        for k, v in t.items():
            ev[k] += v
        ev["blocks"].append({"block": blk, "G": g, **t})
        del h, w, got, want
    emit(phase="stem_epilogue_pg_eval_times", dtype="bfloat16",
         batch=B_SERVE, pt=1, pg=2, **ev)

    def entry(name, src, replaces, t, err, n, fwd):
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "max_abs_err": err,
                "ms": t["ms"], "ms_pipelined": t.get("ms_pipelined"),
                "device_ms": t.get("device_ms"), "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": ("bytes" if t["t_bytes"] >= t["t_ops"]
                             else "operations"),
                "library_ms": None, "launches_timed": n,
                "body": body_report(se, torch, fwd, lane_form=False),
                "blocks": own_blocks(per_block, fwd),
                "times_are": "sum over blocks 3-6 (G=16/8/4/2) of one B=72 "
                             "bf16 forward/backward with dropout bits, "
                             "pt=1, pg=2; ms is one call between two "
                             "CUDA events (as PRs 1-5), ms_pipelined a run "
                             "of back-to-back calls, device_ms the "
                             "kernel's own device time (profiler); "
                             "launches_timed are the calls timed for ms"}
    return (entry("stem_epilogue_pg", "bsed_tpu_torch/csrc/stem_epilogue.cu",
                  "bsed_tpu/ops/stem_epilogue.py:307", tot["fwd"],
                  worst["fwd_bf16"], launches["fwd"], True)
            | {"max_abs_err_f32": worst["fwd_f32"], "eval_form": ev
               | {"times_are": "sum over blocks 3-6 of one B=64 bf16 "
                               "eval-form call (no bits, pt=1, pg=2, GLU), "
                               "as serving runs it"}},
            entry("stem_epilogue_pg_bwd",
                  "bsed_tpu_torch/csrc/stem_epilogue_bwd.cu",
                  "bsed_tpu/ops/stem_epilogue.py:325", tot["bwd"],
                  worst["bwd_f32"], launches["bwd"], False)
            | {"launches": launches["bwd"],      # on no path: the timed calls
               "bound_ms_fma_dw": tot["bwd"]["bound_ms_fma_dw"],
               "max_abs_err_is": "float32 dh",
               "bf16_rel_fro_err": worst["bwd_bf16_rel"],
               "bf16_gate": BF16_GRAD_GATE})


def group_pool_cnn_path(torch, dev, card):
    """Serving's blocks 3-6 (313 frames after the stem, G=16 at block 3,
    preset baseline, weights from seed 0) as ``serve._RestCNN``'s eval-mode
    ConvBlock chain (old) and as ``serve.GroupPoolCNN``, a cuDNN conv and
    one K2-pg call a block (new): bfloat16 at serving's B=64 and float32 at
    predict's B=32 (TF32 off). Gates as tests/test_torch_cuda.py: bf16 2e-2
    of the output's largest magnitude, float32 1e-4. ms a forward from
    CUDA events around back-to-back calls, old and new in turns (old, new,
    new, old); device ms and device launches a forward from torch.profiler
    over 10 forwards; K2-pg launches a forward from its counter."""
    from bsed_tpu_torch import serve as srv
    from bsed_tpu_torch.config import get_config
    from bsed_tpu_torch.models.crnn import compute_dtype
    from bsed_tpu_torch.ops import stem_epilogue as se
    from bsed_tpu_torch.utils import weights
    from bsed_tpu_torch.utils.weights import init_params

    gen = torch.Generator(device=dev).manual_seed(19)
    out = {}
    for name, batch in (("bfloat16", B_SERVE), ("float32", 32)):
        cfg = get_config("baseline")
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    compute_dtype=name))
        params, stats = init_params(cfg, 0)
        dt = compute_dtype(cfg.model)
        rest = srv._RestCNN(cfg, start=3, dtype=dt)
        weights.load_cnn(rest, params["encoder"]["cnn"],
                         stats["encoder"]["cnn"])
        rest.to(dev).eval()
        new = srv.GroupPoolCNN(rest, cfg.model.activation, dt)
        x = (0.5 * torch.randn((batch, GRU_T, 16, 64), generator=gen,
                               device=dev)).to(dt or torch.float32)
        fns = {"old": lambda: rest(x), "new": lambda: new(x)}
        with torch.inference_mode():
            want = fns["old"]()
            n0 = se.stem_epilogue_fwd.launches_pg
            got = fns["new"]()
            torch.cuda.synchronize()
            k2pg = se.stem_epilogue_fwd.launches_pg - n0
            diff = float((got - want).abs().max())
            scale = float(want.abs().max())
            ms = {"old": [], "new": []}
            for k in ("old", "new", "new", "old"):
                ms[k].append(pipelined_ms(fns[k], reps=20))
            prof = {}
            for k, fn in fns.items():
                _, _, rows = device_rows(torch, fn, 10)
                prof[k] = {"device_ms": sum(t for t, _, _ in rows) / 1e4,
                           "device_launches": sum(c for _, _, c in rows)
                           / 10,
                           "top": [{"name": key[:70], "ms": t / 1e4}
                                   for t, key, _ in rows[:6]]}
        gate = 2e-2 * scale if name == "bfloat16" else 1e-4
        out[name] = {"batch": batch, "max_abs_diff": diff, "scale": scale,
                     "gate": gate, "k2pg_launches": k2pg, "ms": ms, **prof}
        emit(phase="group_pool_cnn_path", dtype=name, card=card,
             **out[name])
        assert k2pg == K2_PG, (name, k2pg)
        assert diff <= gate, (name, diff, gate)
        del rest, new, x, want, got
        torch.cuda.empty_cache()
    return out


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


def train_setup(torch, dev, compute_dtype, batch_size):
    """(cfg, state, step, batch) of the flagship train step on ``dev``:
    ``baseline_mt_isp`` + perf_config, random weights from seed 0, a random
    full-width batch made on the card as bench.py:160-171 makes it."""
    from bsed_tpu_torch.config import get_config, perf_config
    from bsed_tpu_torch.train import steps

    cfg = perf_config(get_config("baseline_mt_isp"))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype=compute_dtype))
    modules = steps.build_modules(cfg, device=dev)
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

    cfg, state, step, batch = train_setup(torch, dev, "bfloat16", B_TRAIN)
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
        for kern in (True, False):
            with kernels_if(kern):
                _, state, step, batch = train_setup(torch, dev, "float32", 4)
                metrics = step(state, batch, 7, 30.0)
                torch.cuda.synchronize()
            out[kern] = ({k: float(v) for k, v in metrics.items()},
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
    card; once with the kernels (K2 eval seven times and K4 twice a batch
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
        for run, kern in (("kernels", True), ("plain", False),
                          ("kernels_warm", True)):
            loader = EvalLoader(source, batch_size=B_EVAL, device=dev)
            torch.cuda.synchronize()
            stem_epilogue.stem_epilogue_fwd.launches = 0
            gru_kernel.gru_bidir_recurrence.launches = 0
            t0 = time.perf_counter()
            with kernels_if(kern):
                res = evaluate_checkpoint(cfg, loader, torch_ckpt=ckpt,
                                          thresholds=EVAL_THRESHOLDS,
                                          device=dev, keep_posteriors=True)
            wall = time.perf_counter() - t0
            launches = {
                "stem_epilogue": stem_epilogue.stem_epilogue_fwd.launches,
                "gru_kernel": gru_kernel.gru_bidir_recurrence.launches}
            assert loader.prepare()[0].device.type == "cuda"
            runs[run] = (res, wall, launches)
    (rk, wall_k, launches), (rp, wall_p, launches_p), (rw, wall_w, _) = (
        runs["kernels"], runs["plain"], runs["kernels_warm"])
    assert launches == {"stem_epilogue": K2_EVAL * n_batches,
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


RAW_LONG_S = 600                  # the 10-minute recording: 44.1 kHz int16
RAW_LONG_SR = 44100               # stereo, resampled on read (320/441)
RAW_RAGGED_S = 60                 # 32 kHz; at a 5 s hop: 11 windows, B = 11
RAW_HOP_S = 5.0
RAW_SHORT_S = 3                   # a raw-audio .npy, one padded window
ENA_DOMAINS, ENA_RECORDINGS, ENA_SECONDS = 2, 3, 300
N_ENA_GOLDEN = 3                  # dumps held against the float64 golden
N_SOUNDSCAPES = 64
RAW_GATE = 2e-3                   # float32 serving gate (path_equality)


def _cli_subprocess(argv, tag):
    """``python -m bsed_tpu_torch.cli ARGV`` in a subprocess from the
    checkout's root (its own TF32 settings: the CLI's); (stdout, the JSON
    line it prints last, wall seconds)."""
    import os
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "bsed_tpu_torch.cli",
                           *argv], cwd=root, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{tag} exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout, json.loads(proc.stdout.strip().splitlines()[-1]), \
        wall


def _predict_cli(args, tag):
    """``python -m bsed_tpu_torch.cli predict ARGS`` in a subprocess
    (``_cli_subprocess``); returns the JSON line it prints last, with the
    subprocess's wall seconds."""
    _, out, wall = _cli_subprocess(["predict", *args], f"predict ({tag})")
    out["subprocess_wall_s"] = wall
    out["recording_s_per_wall_s"] = out["audio_seconds"] / \
        out["seconds"]["total"]
    out["recording_s_per_wall_s_process"] = out["audio_seconds"] / wall
    return out


def _raven_table(rng, path, seconds, birds):
    """A Raven selection table of random events over ``seconds``."""
    import csv

    import numpy as np
    n = int(rng.integers(seconds // 10, seconds // 4))
    onsets = np.sort(rng.uniform(0, seconds - 3, n))
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, delimiter="\t", lineterminator="\n")
        w.writerow(["Selection", "View", "Channel", "Begin Time (s)",
                    "End Time (s)", "Low Freq (Hz)", "High Freq (Hz)",
                    "Species"])
        for i, a in enumerate(onsets):
            w.writerow([i + 1, "Spectrogram 1", 1, float(a),
                        float(a + rng.uniform(0.1, 2.5)), 1000.0, 6000.0,
                        birds[int(rng.integers(len(birds)))]])


def raw_audio_path(torch, dev, card):
    """Raw audio in, on the card, as a user runs it (preset baseline at
    full width, random weights from seed 0 exported with the port's
    ``export_torch_checkpoint``):

      * ``python -m bsed_tpu_torch.cli predict`` in a subprocess on a
        10-minute 44.1 kHz int16 stereo WAV and a 3 s ``.npy`` (precision
        'high': K1, K2 and K4), then on a 60 s 32 kHz WAV at
        ``--hop-seconds 5`` (B = 11) with ``--precision highest``, which
        must run with TF32 off: seconds by part, recording-seconds per
        wall-second, events written;
      * in-process on the same inputs, ``predict.predict_recordings`` with
        the kernels (K1, K2 eval and K4 exactly 1, 7 and 2 times a forward
        call) and on their plain versions: posteriors within the serving
        gate, and each recording's events decoded on the card and on the
        host identical;
      * ``preprocess`` of an ENA-layout root (2 domains × 3 annotated
        5-minute recordings at 32 kHz): dumps a second, seconds by part,
        a few dumps against a float64 ``torch.stft`` golden at 1e-3 dB,
        split counts equal to ``seeded_split``'s;
      * ``synthesize --features-out`` of 64 full-length soundscapes.

    Returns the launches of the in-process kernel run by kernel entry."""
    import os
    import tempfile

    import numpy as np
    from scipy.io import wavfile

    from bsed_tpu_torch import cli
    from bsed_tpu_torch.config import get_config
    from bsed_tpu_torch.data.annotations import seeded_split
    from bsed_tpu_torch.data.preprocess import (data_split,
                                                ena_data_preprocess,
                                                read_wav, segment_audio)
    from bsed_tpu_torch.eval.test_model import export_torch_checkpoint
    from bsed_tpu_torch.ops import gru_kernel, mel, mel_kernel, stem_epilogue
    from bsed_tpu_torch.ops.filterbank import mel_filterbank
    from bsed_tpu_torch.predict import decode_events, predict_recordings
    from bsed_tpu_torch.utils.weights import init_params

    t_phase = time.perf_counter()
    cfg = get_config("baseline")
    a = cfg.audio
    params, stats = init_params(cfg, 0)
    counters = {"mel_kernel": mel_kernel.fused_block_mel,
                "stem_epilogue": stem_epilogue.stem_epilogue_fwd,
                "gru_kernel": gru_kernel.gru_bidir_recurrence}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ckpt = export_torch_checkpoint(cfg, params, stats,
                                       os.path.join(tmp, "baseline.pt"))
        rng = np.random.default_rng(0)
        long_wav = os.path.join(tmp, "field_10min.wav")
        wavfile.write(long_wav, RAW_LONG_SR, (rng.standard_normal(
            (RAW_LONG_S * RAW_LONG_SR, 2)) * 3000).astype(np.int16))
        ragged_wav = os.path.join(tmp, "field_1min.wav")
        wavfile.write(ragged_wav, a.sr, (rng.standard_normal(
            RAW_RAGGED_S * a.sr) * 3000).astype(np.int16))
        short_npy = os.path.join(tmp, "clip_3s.npy")
        np.save(short_npy, (rng.standard_normal(RAW_SHORT_S * a.sr) * 0.1
                            ).astype(np.float32))
        inputs_s = time.perf_counter() - t0

        base = ["--preset", "baseline", "--torch-checkpoint", ckpt]
        cli_high = _predict_cli([*base, "--audio", long_wav, short_npy,
                                 "--out-tsv", os.path.join(tmp, "a.tsv")],
                                "high")
        cli_highest = _predict_cli(
            [*base, "--audio", ragged_wav, "--hop-seconds", str(RAW_HOP_S),
             "--precision", "highest", "--out-tsv",
             os.path.join(tmp, "b.tsv")], "highest")
        assert cli_high["tf32"] == cli_highest["tf32"] == \
            {"matmul_tf32": False, "cudnn_tf32": False}, \
            (cli_high["tf32"], cli_highest["tf32"])
        # 60 windows at B = 32 (the second batch padded from 28), one
        # padded window; 11 windows at B = 11
        assert cli_high["batches"] == [[32, 32], [1]], cli_high
        assert cli_highest["batches"] == [[11]], cli_highest

        # in-process: kernels, then the plain versions, on the same inputs
        groups = (([long_wav, short_npy], None), ([ragged_wav], RAW_HOP_S))
        runs = {}
        for kern in (True, False):
            torch.cuda.synchronize()
            for c in counters.values():
                c.launches = 0
            with kernels_if(kern):
                res = [predict_recordings(cfg, params, stats, paths,
                                          device=dev, precision="high",
                                          hop_seconds=hop,
                                          keep_posteriors=True)
                       for paths, hop in groups]
            torch.cuda.synchronize()
            runs[kern] = (res, {k: c.launches for k, c in counters.items()})
        (res_k, launches), (res_p, launches_p) = runs[True], runs[False]
        batches = [b for r in res_k for rec in r["batches"] for b in rec]
        calls = len(batches)
        assert launches == {"mel_kernel": calls,
                            "stem_epilogue": K2_EVAL * calls,
                            "gru_kernel": 2 * calls}, (launches, calls)
        assert launches_p == {k: 0 for k in counters}, launches_p
        post_k = [p for r in res_k for p in r["posteriors"]]
        post_p = [p for r in res_p for p in r["posteriors"]]
        assert all(x.shape == y.shape and np.isfinite(x).all()
                   for x, y in zip(post_k, post_p))
        err = max(float(np.abs(x - y).max()) for x, y in zip(post_k, post_p))
        tables_equal = all(
            decode_events(p, cfg, device=dev) ==
            decode_events(p, cfg, device="cpu") for p in post_k)

        # preprocess: an ENA-layout root, through the functions the CLI
        # calls, with their seconds by part
        root = os.path.join(tmp, "ena")
        t0 = time.perf_counter()
        for d in range(ENA_DOMAINS):
            domain = f"Recording_{d + 1}"
            os.makedirs(os.path.join(root, "wav", domain))
            os.makedirs(os.path.join(root, "annotation", domain))
            for r in range(ENA_RECORDINGS):
                stem = f"rec_{d}_{r}"
                wavfile.write(os.path.join(root, "wav", domain,
                                           stem + ".wav"), a.sr,
                              (rng.standard_normal(ENA_SECONDS * a.sr)
                               * 3000).astype(np.int16))
                _raven_table(rng, os.path.join(root, "annotation", domain,
                                                stem + ".Table.1.txt"),
                              ENA_SECONDS, cfg.bird_list)
        ena_setup_s = time.perf_counter() - t0
        sec = {}
        t0 = time.perf_counter()
        names = ena_data_preprocess(root, cfg, device=dev, seconds=sec)
        pre_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        data_split(root, cfg)
        split_s = time.perf_counter() - t0
        n_dumps = ENA_DOMAINS * ENA_RECORDINGS * int(ENA_SECONDS //
                                                     a.max_len_seconds)
        assert len(names) == n_dumps, (len(names), n_dumps)
        weak, unlab, val = seeded_split(names, cfg.train.dataset_seed)
        split_counts = {
            sub: len(os.listdir(os.path.join(root, sub, "wav")))
            for sub in (cfg.data.train_weak_subdir,
                        cfg.data.train_unlabeled_subdir,
                        cfg.data.val_subdir)}
        assert list(split_counts.values()) == \
            [len(weak), len(unlab), len(val)], split_counts
        # dumps against a float64 torch.stft golden of the same segments
        wav0 = os.path.join(root, "wav", "Recording_1", "rec_0_0.wav")
        segs = segment_audio(read_wav(wav0, a.sr),
                             int(a.max_len_seconds * a.sr))
        pick = [0, len(segs) // 2, len(segs) - 1][:N_ENA_GOLDEN]
        x = torch.from_numpy(segs[pick]).to(dev).double()
        win = torch.hamming_window(a.n_window, periodic=False, device=dev,
                                   dtype=torch.float64)
        fb = torch.as_tensor(mel_filterbank(a.sr, a.n_window, a.n_mels,
                                            a.mel_f_min, a.mel_f_max,
                                            dtype=np.float64), device=dev)
        gold = torch.stft(x, a.n_window, a.hop_size, window=win,
                          center=True, pad_mode="reflect",
                          return_complex=True).abs().transpose(1, 2) @ fb
        dumps = torch.from_numpy(np.stack([np.load(os.path.join(
            root, cfg.data.feature_subdir, "wav", f"rec_0_0_{i}.npy"))
            for i in pick])).to(dev).double()
        db = mel.amplitude_to_db
        golden_err_db = float((db(dumps) - db(gold)).abs().max())
        assert dumps.shape == gold.shape == (len(pick), a.max_frames,
                                             a.n_mels), dumps.shape

        # synthesize --features-out through the CLI
        co = {c: {"proba": float(p), "co-occurences": {
            "max_events": 4, "mean_events": 2,
            "classes": list(cfg.bird_list[:5]),
            "probas": [0.2] * 5}}
            for c, p in zip(cfg.bird_list,
                            rng.dirichlet(np.ones(cfg.nclass)))}
        co_path = os.path.join(tmp, "co.json")
        with open(co_path, "w") as fh:
            json.dump(co, fh)
        t0 = time.perf_counter()
        table = cli.main(["synthesize", "--co-occur", co_path, "--out",
                          os.path.join(tmp, "gen"), "--n-soundscapes",
                          str(N_SOUNDSCAPES), "--features-out",
                          os.path.join(tmp, "feat"), "--seed", "5"])
        syn_s = time.perf_counter() - t0
        feat = sorted(os.listdir(os.path.join(tmp, "feat", "wav")))
        syn_shape = list(np.load(os.path.join(tmp, "feat", "wav",
                                              feat[0])).shape)
        assert len(feat) == N_SOUNDSCAPES and \
            syn_shape == [a.max_frames, a.n_mels], (len(feat), syn_shape)
    emit(phase="raw_audio_path", preset="baseline", compute_dtype="float32",
         inputs={"long_wav": {"seconds": RAW_LONG_S, "sr": RAW_LONG_SR,
                              "dtype": "int16", "channels": 2},
                 "ragged_wav": {"seconds": RAW_RAGGED_S, "sr": a.sr,
                                "hop_seconds": RAW_HOP_S},
                 "short_npy": {"seconds": RAW_SHORT_S}},
         inputs_setup_s=inputs_s,
         cli_predict_high=cli_high, cli_predict_highest=cli_highest,
         forward_batches=batches, forward_calls=calls, launches=launches,
         launches_per_forward_call={k: v / calls
                                    for k, v in launches.items()},
         max_abs_err_posteriors=err, gate=RAW_GATE,
         card_host_tables_equal=tables_equal,
         events_in_process=sum(len(r["rows"]) for r in res_k),
         in_process_seconds=[r["seconds"] for r in res_k],
         in_process_seconds_plain=[r["seconds"] for r in res_p],
         preprocess={"recordings": ENA_DOMAINS * ENA_RECORDINGS,
                     "recording_seconds": ENA_SECONDS, "dumps": len(names),
                     "setup_s": ena_setup_s, "seconds": pre_s,
                     "seconds_by_part": sec, "split_s": split_s,
                     "dumps_per_s": len(names) / pre_s,
                     "split_counts": split_counts,
                     "golden_dumps": len(pick),
                     "max_abs_err_db_vs_f64": golden_err_db},
         synthesize={"soundscapes": N_SOUNDSCAPES, "seconds": syn_s,
                     "soundscapes_per_s": N_SOUNDSCAPES / syn_s,
                     "events": len(table), "dump_shape": syn_shape},
         seconds=time.perf_counter() - t_phase, card=card)
    assert err <= RAW_GATE, f"raw-audio posteriors differ by {err}"
    assert tables_equal, "decoding on the card and on the host differ"
    assert golden_err_db <= 1e-3, \
        f"preprocess dumps vs float64 golden: {golden_err_db} dB"
    return launches


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

    cfg, state, step, batch = train_setup(torch, dev, "bfloat16", B_TRAIN)
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
         launches_per_evaluate={"stem_epilogue": K2_EVAL * FIT_VAL_BATCHES,
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
    times a step (K4 never), every evaluate K2's eval form 7 and K4 2
    times a batch; run A's counters, set to 0 before it, hold exactly its
    calls' launches. Returns run A's launches by kernel entry."""
    for call in rec.calls:
        if call["kind"] == "train_epoch":
            assert (call["k2"], call["k3"], call["k4"]) == (
                6 * FIT_STEPS, 3 * FIT_STEPS, 0), call
        elif call["kind"] == "evaluate":
            assert (call["k2"], call["k3"], call["k4"]) == (
                K2_EVAL * FIT_VAL_BATCHES, 0, 2 * FIT_VAL_BATCHES), call
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


# --- the presets that need no discriminator ------------------------------

TRAIN_PRESETS = ("baseline", "baseline_mt", "baseline_mt_isp",
                 "baseline_ena", "baseline_fpn_mt_isp", "scmt", "scmt_ada",
                 "scmt_ada_origin", "scmt_ada_weak", "sct_ada_weak",
                 "pseudo_labeling", "origin")
# K2's train form and K3 a step of each preset's --perf form. The folded
# stem runs 3 blocks a forward, K2 in every forward and K3 in the backward
# of every student forward; fused streams batch the student into one
# forward and the ISP teacher into one. Teacher forwards: 0 without a mean
# teacher, else 1, plus origin's unlabelled-rows forward for mixup.
# Student forwards: 1, plus origin's three mixups (weak, strong,
# unlabelled). FPN does not fold (no --perf form).
PERF_LAUNCHES = {p: (6, 3) for p in TRAIN_PRESETS}
PERF_LAUNCHES.update({"baseline": (3, 3), "baseline_ena": (3, 3),
                      "origin": (18, 12)})
del PERF_LAUNCHES["baseline_fpn_mt_isp"]
N_PRESET_WARMUP, N_PRESET_TIMED = 2, 3
# (preset, --perf form) whose step is profiled after its timed steps
PROFILED_PRESETS = (("baseline_mt_isp", False), ("origin", False),
                    ("origin", True))
B_FPN = 64
N_FPN_BATCHES = 3


def preset_setup(torch, dev, preset, perf, compute_dtype, batch_size,
                 adaptation=False, model=None):
    """(cfg, state, step, batch) of ``preset`` on ``dev`` in its
    reference-parity form (``perf=False``: float32, unfolded, stream by
    stream) or its --perf form in ``compute_dtype``; random weights from
    seed 0; a random full-width batch made on the card: ``batch_size`` SYN
    and real clips (origin: a combined real batch of twice that), strong
    and weak targets; origin's normalisation statistics are the real
    batch's log-mel mean and std per bin. ``adaptation``: in the
    adaptation stage, with its discriminator. ``model``: model fields set
    last (the 'crnn' head, recurrent dropout)."""
    from bsed_tpu_torch.config import get_config, perf_config
    from bsed_tpu_torch.ops.mel import amplitude_to_db
    from bsed_tpu_torch.train import steps

    cfg = get_config(preset)
    if adaptation:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    stage="adaptation"))
    if perf:
        cfg = perf_config(cfg)
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, compute_dtype=compute_dtype))
    if model:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, **model))
    gen = torch.Generator(device=dev).manual_seed(11)
    t_in, f = cfg.audio.max_frames, cfg.audio.n_mels
    n_real = 2 * batch_size if cfg.train.isp_flavor == "origin" \
        else batch_size

    def strong(n):
        return (torch.rand((n, cfg.n_frames, cfg.nclass), generator=gen,
                           device=dev) > 0.9).float()
    batch = {"syn": torch.randn((batch_size, t_in, f), generator=gen,
                                device=dev).abs(),
             "syn_strong": strong(batch_size),
             "real": torch.randn((n_real, t_in, f), generator=gen,
                                 device=dev).abs(),
             "real_strong": strong(n_real)}
    batch["real_weak"] = batch["real_strong"].amax(dim=1)
    norm = None
    if cfg.train.normalize:
        log = amplitude_to_db(batch["real"]).flatten(0, 1)
        norm = (log.mean(0).cpu().numpy(), log.std(0).cpu().numpy())
    modules = steps.build_modules(cfg, device=dev, norm_stats=norm)
    state = steps.create_train_state(cfg, modules, 0)
    return cfg, state, steps.make_train_step(modules, steps_per_epoch=8), \
        batch


def preset_steps(torch, dev, preset, perf, profile_dir=None):
    """Warm-up and timed steps of one preset at epoch 30 (the exp_step
    presets' cost ramps from their step count): ms a step, finite
    metrics, the kernels' launches in the timed steps; then, for
    ``PROFILED_PRESETS``, one step under the profiler (``profile``)."""
    from bsed_tpu_torch.ops import gru_kernel, stem_epilogue as se

    cfg, state, step, batch = preset_setup(torch, dev, preset, perf,
                                           "bfloat16", B_TRAIN)
    for _ in range(N_PRESET_WARMUP):
        step(state, batch, 1, 30.0)
    torch.cuda.synchronize()
    c0 = (se.stem_epilogue_fwd.launches, se.stem_epilogue_bwd.launches,
          gru_kernel.gru_bidir_recurrence.launches)
    t0 = time.perf_counter()
    for _ in range(N_PRESET_TIMED):
        metrics = step(state, batch, 1, 30.0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / N_PRESET_TIMED * 1e3
    k2, k3, k4 = (b - a for a, b in zip(c0, (
        se.stem_epilogue_fwd.launches, se.stem_epilogue_bwd.launches,
        gru_kernel.gru_bidir_recurrence.launches)))
    values = {k: float(v) for k, v in metrics.items()}
    assert all(math.isfinite(v) for v in values.values()), (preset, values)
    form = "perf" if perf else "reference"
    if perf:
        want = tuple(n * N_PRESET_TIMED for n in PERF_LAUNCHES[preset])
        assert (k2, k3, k4) == want + (0,), (preset, (k2, k3, k4), want)
    else:
        assert (k2, k3, k4) == (0, 0, 0), (preset, (k2, k3, k4))
    out = {"preset": preset, "form": form, "ms_per_step": ms,
           "loss": values["loss"], "n_metrics": len(values),
           "batch_real": int(batch["real"].shape[0]),
           "launches": {"stem_epilogue_train": k2, "stem_epilogue_bwd": k3,
                        "gru_kernel": k4}}
    if (preset, perf) in PROFILED_PRESETS:
        profile(torch, lambda: step(state, batch, 1, 30.0), ms / 1e3,
                profile_dir, "preset_profile", f"{preset}_{form}_profile.txt",
                preset=preset, form=form)
    del state, step, batch
    torch.cuda.empty_cache()
    return out


def preset_equality(torch, dev, preset, model=None):
    """The float32 --perf step of ``preset`` (``model``: as
    ``preset_setup``'s) with the kernels against the same step on their
    plain versions, 4 + 4 full-width clips (origin's combined batch 8),
    dropout 0.5 with the same bits, cuDNN deterministic: train_equality's
    gates."""
    import numpy as np
    from bsed_tpu_torch.utils import weights

    torch.backends.cudnn.deterministic = True
    try:
        out = {}
        for kern in (True, False):
            with kernels_if(kern):
                _, state, step, batch = preset_setup(
                    torch, dev, preset, True, "float32", 4, model=model)
                metrics = step(state, batch, 7, 30.0)
                torch.cuda.synchronize()
            out[kern] = ({k: float(v) for k, v in metrics.items()},
                         state_leaves(weights.export_train_state(state)))
            del state, step, batch
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    (mk, tk), (mp, tp) = out[True], out[False]
    loss_rel = max(abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-30) for k in mp)

    def worst(key, rtol):
        return max(float((np.abs(tk[p] - v) - rtol * np.abs(v)).max())
                   for p, v in tp.items() if p[0] == key)
    mu_err = worst("mu", 0.0)
    stats_err = max(worst("batch_stats", 1e-5),
                    worst("ema_batch_stats", 1e-5))
    assert loss_rel <= 1e-4, (preset, loss_rel)
    assert mu_err <= 3e-5, (preset, mu_err)
    assert stats_err <= 1e-5, (preset, stats_err)
    return {"preset": preset, "metrics_max_rel_err": loss_rel,
            "adam_mu_max_abs_err": mu_err, "bn_stats_max_err": stats_err}


def fpn_predict(torch, dev):
    """``make_predict_fn`` on an FPN tree (preset baseline_fpn_mt_isp,
    float32, random weights from seed 0) at B=64 full-width clips: the
    three BiGRUs hoisted on K4, 6 launches a batch (T = 313, 156, 78),
    against the plain versions within 2e-3."""
    from bsed_tpu_torch.config import get_config
    from bsed_tpu_torch.ops import gru_kernel
    from bsed_tpu_torch.train import steps
    from bsed_tpu_torch.utils.weights import init_params

    cfg = get_config("baseline_fpn_mt_isp")
    params, stats = init_params(cfg, 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    mel = torch.randn((B_FPN, cfg.audio.max_frames, cfg.audio.n_mels),
                      generator=gen, device=dev).abs()
    kern = steps.make_predict_fn(steps.TrainModules(cfg, dev))
    kern(params, stats, mel, inference=True)            # build, warm up
    torch.cuda.synchronize()
    gru_kernel.gru_bidir_recurrence.launches = 0
    t0 = time.perf_counter()
    for _ in range(N_FPN_BATCHES):
        sk, wk = kern(params, stats, mel, inference=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / N_FPN_BATCHES * 1e3
    launches = gru_kernel.gru_bidir_recurrence.launches
    with kernels_if(False):
        sp, wp = kern(params, stats, mel, inference=True)
    torch.cuda.synchronize()
    err = max(float((sk - sp).abs().max()), float((wk - wp).abs().max()))
    assert launches == 6 * N_FPN_BATCHES, launches
    assert sk.shape == (B_FPN, cfg.n_frames, cfg.nclass), sk.shape
    assert torch.isfinite(sk).all() and torch.isfinite(wk).all()
    assert err <= 2e-3, f"FPN kernel posteriors differ by {err}"
    return {"batch": B_FPN, "batches": N_FPN_BATCHES, "ms_per_batch": ms,
            "clips_per_s": B_FPN / ms * 1e3, "gru_kernel": launches,
            "gru_lengths": [cfg.n_frames, cfg.n_frames // 2,
                            cfg.n_frames // 4],
            "max_abs_err_posteriors": err, "gate": 2e-3}


def preset_cli_runs(torch):
    """``train --preset origin --perf -s 96 --epochs 1`` and ``train
    --preset baseline_fpn_mt_isp -s 48 --epochs 1`` through the CLI's
    ``main``, each followed by ``eval --store-dir``. origin: 8 steps of 18
    K2-train and 12 K3 launches, one evaluate of 2 val batches (K2 eval 7
    and K4 2 a batch), the store's evaluation the same; FPN (unfolded
    float32): 4 steps with no kernel, evaluate and the store's evaluation
    of 1 batch with K4 6 times. Results finite; the FPN store's
    evaluation equals its best row (origin validates with the val-fitted
    scaler, which ``eval`` does not apply)."""
    import os
    import tempfile

    from bsed_tpu_torch import cli

    out, totals = {}, {"stem_epilogue_train": 0, "stem_epilogue_bwd": 0,
                       "stem_epilogue": 0, "gru_kernel": 0}
    runs = (("origin", ["--preset", "origin", "--perf", "-s", "96"],
             (18 * 8, 12 * 8, 0), (2 * K2_EVAL, 0, 4)),
            ("fpn", ["--preset", "baseline_fpn_mt_isp", "-s", "48"],
             (0, 0, 0), (0, 0, 6)))
    rec = FitRecorder(torch)
    with tempfile.TemporaryDirectory() as tmp, rec:
        for name, argv, want_train, want_eval in runs:
            store = os.path.join(tmp, name)
            rec.run = name
            t0 = time.perf_counter()
            best = cli.main(["train", *argv, "--epochs", "1",
                             "--store-dir", store])
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            rows = read_results(os.path.join(store, "results.tsv"))
            c0 = _launch_counts()
            t0 = time.perf_counter()
            scores = cli.main(["eval", "--store-dir", store, *argv[-2:]])
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
            store_eval = tuple(b - a for a, b in zip(c0, _launch_counts()))
            (epoch,), (evaluate,) = rec.of(name, "train_epoch"), \
                rec.of(name, "evaluate")
            assert (epoch["k2"], epoch["k3"], epoch["k4"]) == want_train, \
                (name, epoch)
            assert (evaluate["k2"], evaluate["k3"], evaluate["k4"]) == \
                want_eval, (name, evaluate)
            assert store_eval == want_eval, (name, store_eval)
            assert [r["epoch"] for r in rows] == [0], rows
            assert all(math.isfinite(v) for v in rows[0].values()), rows
            assert math.isfinite(scores["event_f1"]) and \
                math.isfinite(scores["psds_f1"]), scores
            err = max(abs(scores["event_f1"] - rows[0]["val_event_f1"]),
                      abs(scores["psds_f1"] - rows[0]["val_psds_f1"]))
            if name == "fpn":
                assert err <= 1e-6, f"FPN eval --store-dir differs by {err}"
            totals["stem_epilogue_train"] += epoch["k2"]
            totals["stem_epilogue_bwd"] += epoch["k3"]
            totals["stem_epilogue"] += evaluate["k2"] + store_eval[0]
            totals["gru_kernel"] += evaluate["k4"] + store_eval[2]
            out[name] = {"argv": argv, "train_s": train_s, "eval_s": eval_s,
                         "epoch_train_s": epoch["s"],
                         "ms_per_step": epoch["s"] * 1e3 / (
                             8 if name == "origin" else 4),
                         "loss": rows[0]["loss"],
                         "val_event_f1": rows[0]["val_event_f1"],
                         "eval_scores": {"event_f1": scores["event_f1"],
                                         "psds_f1": scores["psds_f1"]},
                         "eval_vs_best_row": err,
                         "launches_epoch": want_train,
                         "launches_evaluate": want_eval,
                         "best_epoch": best["epoch"]}
    return out, totals


def presets_path(torch, dev, card, profile_dir=None):
    """Every preset that trains without a discriminator, on the card
    (``preset_steps``): each in its reference-parity form (no kernel may
    launch) and each foldable one in its --perf form, bf16 (the exact K2
    and K3 launches of ``PERF_LAUNCHES``); the float32 kernel step against
    the plain step for origin and scmt; FPN serving through
    ``make_predict_fn``; and two short CLI runs with their store's
    evaluation (``preset_cli_runs``); one step of each of
    ``PROFILED_PRESETS`` is profiled. Returns the launches of the phase's
    driven runs (the timed --perf steps, the FPN batches and the CLI
    runs; not the comparisons') by kernel entry."""
    from bsed_tpu_torch.ops import gru_kernel, stem_epilogue as se

    t_phase = time.perf_counter()
    reference = [preset_steps(torch, dev, p, False, profile_dir)
                 for p in TRAIN_PRESETS]
    perf = [preset_steps(torch, dev, p, True, profile_dir)
            for p in TRAIN_PRESETS if p in PERF_LAUNCHES]
    equality = [preset_equality(torch, dev, p) for p in ("origin", "scmt")]
    torch.cuda.empty_cache()
    se.stem_epilogue_fwd.launches = 0
    se.stem_epilogue_bwd.launches = 0
    gru_kernel.gru_bidir_recurrence.launches = 0
    fpn = fpn_predict(torch, dev)
    torch.cuda.empty_cache()
    cli_runs, cli_launches = preset_cli_runs(torch)
    launches = {
        "stem_epilogue_train": sum(r["launches"]["stem_epilogue_train"]
                                   for r in perf)
        + cli_launches["stem_epilogue_train"],
        "stem_epilogue_bwd": sum(r["launches"]["stem_epilogue_bwd"]
                                 for r in perf)
        + cli_launches["stem_epilogue_bwd"],
        "stem_epilogue": cli_launches["stem_epilogue"],
        "gru_kernel": fpn["gru_kernel"] + cli_launches["gru_kernel"]}
    emit(phase="presets_path", batch_syn=B_TRAIN, batch_real=B_TRAIN,
         batch_real_origin=2 * B_TRAIN, epoch=30.0,
         warmup_steps=N_PRESET_WARMUP, timed_steps=N_PRESET_TIMED,
         perf_compute_dtype="bfloat16", reference_form=reference,
         perf_form=perf,
         perf_launches_per_step={p: {"stem_epilogue_train": a,
                                     "stem_epilogue_bwd": b}
                                 for p, (a, b) in PERF_LAUNCHES.items()},
         f32_kernels_vs_plain=equality,
         equality_gates={"metrics": 1e-4, "mu": 3e-5, "bn_stats": 1e-5},
         fpn_predict=fpn, cli=cli_runs, launches=launches,
         seconds=time.perf_counter() - t_phase, card=card)
    return launches


# --- the adaptation stage -------------------------------------------------

# the nine runs: each DA mode and lineage bsed_tpu trains in the adaptation
# stage (a-c are adaptation presets, d-i a pretrain preset's DA settings)
DA_RUNS = {"a": "baseline_adaptation", "b": "scmt_ada_weak_separate_2crnn",
           "c": "scmt_ada_weak_separate", "d": "pseudo_labeling",
           "e": "sct_ada_weak", "f": "scmt_ada", "g": "scmt", "h": "origin",
           "i": "scmt_ada_origin"}
# K2's train form and K3 a --perf step that runs its DA update: the
# pretrain step's (every run has a mean teacher: (6, 3); origin (18, 12))
# plus a GRL pre-step's 2 forwards, each backpropagated (+6, +6: a, b, f),
# or ADDA's 2 discriminator-step forwards with no encoder gradient and its
# confusion forward with one (+9, +3: g, h, i); a joint domain loss reads
# the main forwards (c, d, e: +0). ADDA with update_step 2 (g, h) skips
# its update on odd steps: the pretrain step's count there.
DA_PERF_LAUNCHES = {"a": (12, 9), "b": (12, 9), "c": (6, 3), "d": (6, 3),
                    "e": (6, 3), "f": (12, 9), "g": (15, 6), "h": (27, 15),
                    "i": (15, 6)}
DA_SKIP_LAUNCHES = {"g": (6, 3), "h": (18, 12)}
DA_PROFILED = ("a", True)         # (run, --perf form) profiled for one step
N_DA_TIMED = 2                    # state steps 2 (ADDA update) and 3 (skip)
DA_EVAL_LAUNCHES = (2 * K2_EVAL, 0, 4)  # K2 (eval), K3, K4: 2 val batches
N_DA_FIT_STEPS = N_FIT_SYN // B_TRAIN


def da_step_launches(run, step):
    skip = run in DA_SKIP_LAUNCHES and step % 2
    return DA_SKIP_LAUNCHES[run] if skip else DA_PERF_LAUNCHES[run]


def da_steps(torch, dev, run, perf, profile_dir=None):
    """2 warm-up and 2 timed steps (state steps 2 and 3: ADDA's
    update_step 2 updates on 2, skips 3) of run ``run`` in its reference-parity
    form (no kernel may launch) or its --perf form, bf16 (the exact
    launches of ``da_step_launches``): ms a step, finite loss and
    domain_loss, peak device memory from the setup on; ``DA_PROFILED``'s
    step is profiled once more after them."""
    from bsed_tpu_torch.ops import gru_kernel, stem_epilogue as se

    torch.cuda.reset_peak_memory_stats()
    cfg, state, step, batch = preset_setup(torch, dev, DA_RUNS[run], perf,
                                           "bfloat16", B_TRAIN,
                                           adaptation=True)
    for _ in range(N_PRESET_WARMUP):
        step(state, batch, 1, 30.0)
    torch.cuda.synchronize()
    first = state.step
    counts = lambda: (se.stem_epilogue_fwd.launches,  # noqa: E731
                      se.stem_epilogue_bwd.launches,
                      gru_kernel.gru_bidir_recurrence.launches)
    c0 = counts()
    t0 = time.perf_counter()
    history = [step(state, batch, 1, 30.0) for _ in range(N_DA_TIMED)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / N_DA_TIMED * 1e3
    k2, k3, k4 = (b - a for a, b in zip(c0, counts()))
    values = [{k: float(v) for k, v in m.items()} for m in history]
    assert all(math.isfinite(v) for m in values for v in m.values()), \
        (run, values)
    form = "perf" if perf else "reference"
    if perf:
        want = tuple(sum(da_step_launches(run, s)[i] for s in
                         range(first, first + N_DA_TIMED))
                     for i in range(2))
        assert (k2, k3, k4) == want + (0,), (run, (k2, k3, k4), want)
    else:
        assert (k2, k3, k4) == (0, 0, 0), (run, (k2, k3, k4))
    out = {"run": run, "preset": DA_RUNS[run], "form": form,
           "da_mode": cfg.da.mode, "level": cfg.da.level,
           "discriminator": type(state.discriminator).__name__,
           "ms_per_step": ms, "loss": [m["loss"] for m in values],
           "domain_loss": [m["domain_loss"] for m in values],
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "batch_real": int(batch["real"].shape[0]),
           "launches": {"stem_epilogue_train": k2, "stem_epilogue_bwd": k3,
                        "gru_kernel": k4}}
    if (run, perf) == DA_PROFILED:
        profile(torch, lambda: step(state, batch, 1, 30.0), ms / 1e3,
                profile_dir, "adaptation_profile", f"da_{run}_{form}_"
                "profile.txt", da_run=run, preset=DA_RUNS[run], form=form)
    del state, step, batch
    torch.cuda.empty_cache()
    return out


def da_equality(torch, dev, run):
    """The float32 --perf step of run ``run`` with the kernels against the
    same step on their plain versions, 4 + 4 full-width clips (origin's
    combined batch 8), dropout 0.5 with the same bits, cuDNN
    deterministic: train_equality's gates (metrics 1e-4 relative, every
    Adam first moment 3e-5, BatchNorm statistics 1e-5 + 1e-5 relative),
    extended to the discriminator's and the encoder's aux optimizers'
    moments and the discriminator's statistics, and the discriminator's
    params at 1e-5 beyond the Adam step (2.2·lr) of an element whose
    gradient is below 1e-6, which takes an arbitrary sign. Such an element
    is each block's conv bias (it feeds a BatchNorm): the aux optimizer's
    step moves it before the main forwards, whose batch mean takes it one
    to one, so the encoder's running means get 0.99 · 2.2 · lr more where
    the aux gradient of their conv bias is below 1e-6."""
    import numpy as np

    torch.backends.cudnn.deterministic = True
    try:
        out = {}
        for kern in (True, False):
            with kernels_if(kern):
                cfg, state, step, batch = preset_setup(
                    torch, dev, DA_RUNS[run], True, "float32", 4,
                    adaptation=True)
                metrics = step(state, batch, 7, 30.0)
                torch.cuda.synchronize()
            out[kern] = ({k: float(v) for k, v in metrics.items()},
                         state_leaves(state))
            del state, step, batch
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    (mk, tk), (mp, tp) = out[True], out[False]
    loss_rel = max(abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-30) for k in mp)

    def worst(prefix, rtol, allow=None):
        errs = [float((np.abs(tk[p] - v) - rtol * np.abs(v)
                       - (allow(p) if allow else 0.0)).max())
                for p, v in tp.items() if p[:len(prefix)] == prefix]
        return max(errs) if errs else 0.0
    aux_lr = cfg.train.max_learning_rate * cfg.da.aux_lr_factor

    def noise(mu):
        if mu is None:                 # SGD: no sign-amplified step
            return 0.0
        return np.where(np.abs(mu / 0.1) < 1e-6, 2.2 * aux_lr, 0.0)

    def disc_noise(path):
        return noise(tp.get(("disc_opt_state", "mu") + path[1:]))

    def mean_noise(path):
        if path[-1] != "mean":
            return 0.0
        return 0.99 * noise(tp.get(("enc_opt_state", "mu", "cnn", path[3],
                                    "conv", "bias")))
    mu_err = max(worst(("mu",), 0.0), worst(("enc_opt_state", "mu"), 0.0),
                 worst(("disc_opt_state", "mu"), 0.0))
    stats_err = max(worst(("batch_stats",), 1e-5, mean_noise),
                    worst(("ema_batch_stats",), 1e-5),
                    worst(("disc_batch_stats",), 1e-5))
    disc_err = worst(("disc_params",), 0.0, disc_noise)
    assert mk.keys() == mp.keys() and "domain_loss" in mk
    assert loss_rel <= 1e-4, (run, loss_rel)
    assert mu_err <= 3e-5, (run, mu_err)
    assert stats_err <= 1e-5, (run, stats_err)
    assert disc_err <= 1e-5, (run, disc_err)
    return {"run": run, "preset": DA_RUNS[run],
            "metrics_max_rel_err": loss_rel, "adam_mu_max_abs_err": mu_err,
            "bn_stats_max_err": stats_err,
            "disc_params_max_err_beyond_allowance": disc_err,
            "domain_loss_kernels": mk["domain_loss"],
            "domain_loss_plain": mp["domain_loss"]}


def da_cli_cycle(torch):
    """``train --preset baseline_adaptation --perf -s 96 --epochs 1``,
    then ``--resume --epochs 2`` on its store (a resume at the adaptation
    stage's boundary, epoch 1: the discriminator, its statistics and its
    optimizer keep the resumed Trainer's fresh init, the rest comes from
    epoch_0), then ``eval --store-dir``, through the CLI's ``main``. Each
    epoch 8 steps of 12 K2-train and 9 K3 launches, each evaluate 2 val
    batches (K2 eval 7 and K4 2 a batch); results finite; the store's
    evaluation equal to the best row."""
    import os
    import tempfile

    import numpy as np

    from bsed_tpu_torch import cli
    from bsed_tpu_torch.train.trainer import Trainer
    from bsed_tpu_torch.utils.checkpoint import CheckpointManager

    s_flag = ["-s", str(N_FIT_SYN)]
    seen = {}
    resume = Trainer.resume

    def recorded_resume(trainer, epoch):
        seen["fresh"] = state_leaves(trainer.state)
        resume(trainer, epoch)
        seen["resumed"] = state_leaves(trainer.state)
        seen["epoch"] = epoch

    per_epoch = tuple(n * N_DA_FIT_STEPS for n in DA_PERF_LAUNCHES["a"])
    out, totals = {}, {"stem_epilogue_train": 0, "stem_epilogue_bwd": 0,
                       "stem_epilogue": 0, "gru_kernel": 0}
    rec = FitRecorder(torch)
    Trainer.resume = recorded_resume
    try:
        with tempfile.TemporaryDirectory() as tmp, rec:
            store = os.path.join(tmp, "adaptation")
            runs = (("A", ["train", "--preset", "baseline_adaptation",
                           "--perf", *s_flag, "--epochs", "1",
                           "--store-dir", store]),
                    ("B", ["train", "--store-dir", store, "--resume",
                           *s_flag, "--epochs", "2"]),
                    ("D", ["eval", "--store-dir", store, *s_flag]))
            for name, argv in runs:
                rec.run = name
                c0 = _launch_counts()
                t0 = time.perf_counter()
                result = cli.main(argv)
                torch.cuda.synchronize()
                k2, k3, k4 = (b - a for a, b in zip(c0, _launch_counts()))
                out[name] = {"argv": argv,
                             "seconds": time.perf_counter() - t0}
                if name == "A":
                    epoch0 = state_leaves(
                        CheckpointManager(store).load("epoch_0"))
                if name == "D":
                    scores = result
                    assert (k2, k3, k4) == DA_EVAL_LAUNCHES, (k2, k3, k4)
                    totals["stem_epilogue"] += k2
                    totals["gru_kernel"] += k4
                for c in rec.of(name, "train_epoch"):
                    assert (c["k2"], c["k3"], c["k4"]) == per_epoch + (0,), c
                    totals["stem_epilogue_train"] += c["k2"]
                    totals["stem_epilogue_bwd"] += c["k3"]
                for c in rec.of(name, "evaluate"):
                    assert (c["k2"], c["k3"], c["k4"]) == DA_EVAL_LAUNCHES, c
                    totals["stem_epilogue"] += c["k2"]
                    totals["gru_kernel"] += c["k4"]
            rows = read_results(os.path.join(store, "results.tsv"))
    finally:
        Trainer.resume = resume
    assert seen["epoch"] == 1, seen.get("epoch")
    fresh, resumed = seen["fresh"], seen["resumed"]
    disc_keys = ("disc_params", "disc_batch_stats", "disc_opt_state")
    for path, v in resumed.items():
        want = fresh[path] if path[0] in disc_keys else epoch0[path]
        assert np.array_equal(v, want), path
    changed = sum(not np.array_equal(epoch0[p], fresh[p])
                  for p in fresh if p[0] == "disc_params")
    assert changed > 0, "epoch_0's discriminator equals a fresh one"
    assert [r["epoch"] for r in rows] == [1], rows
    assert all(math.isfinite(v) for r in rows for v in r.values()), rows
    assert "domain_loss" in rows[0]
    err = max(abs(scores["event_f1"] - rows[0]["val_event_f1"]),
              abs(scores["psds_f1"] - rows[0]["val_psds_f1"]))
    assert err <= 1e-6, f"eval --store-dir differs from the best row by {err}"
    out.update(resumed_at_epoch=1, disc_fresh_after_resume=True,
               encoder_from_epoch_0=True, eval_vs_best_row=err,
               domain_loss=rows[0]["domain_loss"], loss=rows[0]["loss"],
               launches_epoch=per_epoch, launches_evaluate=DA_EVAL_LAUNCHES,
               epoch_train_s=[c["s"] for c in rec.calls
                              if c["kind"] == "train_epoch"])
    return out, totals


N_MAP_ROWS = 64                   # R_f rows checked at each end


def randomized_map_check(torch, dev):
    """Run d's frame-CDAN randomized map (R_f (80128, 8192) float32,
    2.63 GB, and R_g) drawn for the card against the same draw for the
    CPU: the first and last ``N_MAP_ROWS`` rows of R_f and all of R_g
    bit-equal; the seconds of each draw (one CPU generator either way)."""
    from bsed_tpu_torch.config import get_config
    from bsed_tpu_torch.train import da

    cfg = get_config(DA_RUNS["d"])
    dims = (2 * cfg.model.n_rnn_cell * cfg.n_frames, cfg.nclass,
            cfg.da.randomized_dim)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rf, rg = da.make_randomized_maps(*dims, seed=cfg.train.seed, device=dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rf_c, rg_c = da.make_randomized_maps(*dims, seed=cfg.train.seed,
                                         device="cpu")
    cpu_s = time.perf_counter() - t0
    n = N_MAP_ROWS
    equal = (torch.equal(rf[:n].cpu(), rf_c[:n])
             and torch.equal(rf[-n:].cpu(), rf_c[-n:])
             and torch.equal(rg.cpu(), rg_c))
    out = {"run": "d", "r_f": list(rf.shape), "r_g": list(rg.shape),
           "gib": (rf.numel() + rg.numel()) * 4 / 2 ** 30,
           "rows_checked_each_end": n, "bit_equal": equal,
           "draw_s_for_card": card_s, "draw_s_for_cpu": cpu_s}
    del rf, rg, rf_c, rg_c
    torch.cuda.empty_cache()
    assert equal, "run d's randomized map differs between card and CPU"
    return out


def adaptation_path(torch, dev, card, profile_dir=None):
    """The adaptation stage on the card: run d's randomized map drawn for
    the card against the CPU draw (``randomized_map_check``), the nine
    runs in the reference form (no kernel) and the --perf form (exact
    K2-train / K3 launches),
    runs a and h's float32 kernel step against the plain step, and the
    CLI's train / resume at the stage boundary / eval cycle. Returns the
    launches of the phase's driven runs (the timed --perf steps and the
    CLI cycle; not the comparisons') by kernel entry."""
    t_phase = time.perf_counter()
    rand_map = randomized_map_check(torch, dev)
    reference = [da_steps(torch, dev, r, False, profile_dir)
                 for r in DA_RUNS]
    perf = [da_steps(torch, dev, r, True, profile_dir) for r in DA_RUNS]
    equality = [da_equality(torch, dev, r) for r in ("a", "h")]
    torch.cuda.empty_cache()
    cli_cycle, cli_launches = da_cli_cycle(torch)
    launches = dict(cli_launches)
    for key in ("stem_epilogue_train", "stem_epilogue_bwd"):
        launches[key] += sum(r["launches"][key] for r in perf)
    emit(phase="adaptation_path", batch_syn=B_TRAIN, batch_real=B_TRAIN,
         batch_real_origin=2 * B_TRAIN, epoch=30.0,
         warmup_steps=N_PRESET_WARMUP, timed_steps=N_DA_TIMED,
         timed_state_steps=[N_PRESET_WARMUP + i
                            for i in range(N_DA_TIMED)],
         perf_compute_dtype="bfloat16", reference_form=reference,
         perf_form=perf,
         perf_launches_per_update_step={
             r: {"stem_epilogue_train": a, "stem_epilogue_bwd": b}
             for r, (a, b) in DA_PERF_LAUNCHES.items()},
         perf_launches_per_skipped_step={
             r: {"stem_epilogue_train": a, "stem_epilogue_bwd": b}
             for r, (a, b) in DA_SKIP_LAUNCHES.items()},
         f32_kernels_vs_plain=equality,
         equality_gates={"metrics": 1e-4, "mu": 3e-5, "bn_stats": 1e-5,
                         "disc_params": 1e-5},
         cli=cli_cycle, launches=launches, randomized_map=rand_map,
         seconds=time.perf_counter() - t_phase, card=card)
    return launches


TAGGER_RUNS = (("resnet", False), ("resnet", True), ("vgg", False),
               ("vgg", True))
N_TAG_WARMUP, N_TAG_TIMED = 2, 5
TAG_CPU_CLIPS = 2                 # SYN and real clips of card-vs-CPU
TAG_GATES = {"posteriors_abs": 1e-4, "loss_rel": 1e-4, "bn_stats_rel": 1e-4,
             "mu_rel": 2e-2}
TF32_FLOPS = 495e12               # dense TF32 tensor-core rate
# the cycle's fixture: SYN, weak, unlabeled and validation clips
CYCLE_CLIPS = {"syn": 48, "weak": 24, "unlabeled": 96, "val": 24}


def tagger_batch(torch, cfg, dev, n, seed):
    """``n`` SYN and ``n`` real full-width linear-mel clips with weak
    targets, made on ``dev`` from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (n, cfg.audio.max_frames, cfg.audio.n_mels)

    def weak():
        return (torch.rand((n, cfg.nclass), generator=gen, device=dev)
                > 0.8).float()
    return {"syn": torch.randn(shape, generator=gen, device=dev).abs(),
            "syn_weak": weak(),
            "real": torch.randn(shape, generator=gen, device=dev).abs(),
            "real_weak": weak()}


def tagger_steps(torch, dev, arch, mean_teacher, profile_dir=None):
    """One tagger (``TaggingTrainer`` on the card, preset baseline's
    parity config, 12 + 12 clips): the step's operations
    (``FlopCounterMode``), 2 warm-up and 5 timed steps with TF32 off and
    then on (``utils/device.float32_precision``), peak memory, and one
    profiled step of each (device time, busy share, launches)."""
    from torch.utils.flop_counter import FlopCounterMode

    from bsed_tpu_torch.config import get_config
    from bsed_tpu_torch.train.tagging_trainer import TaggingTrainer
    from bsed_tpu_torch.utils.device import float32_precision

    cfg = get_config("baseline")
    trainer = TaggingTrainer(cfg, arch=arch, mean_teacher=mean_teacher,
                             device=dev)
    batch = tagger_batch(torch, cfg, dev, B_TRAIN, 21)
    gen = torch.Generator(device=dev).manual_seed(0)
    with FlopCounterMode(display=False) as counter:
        trainer.train_step(batch, gen)
    flops = counter.get_total_flops()
    name = f"{arch}{'_mt' if mean_teacher else ''}"
    out = {"arch": arch, "mean_teacher": mean_teacher,
           "step_gflop": flops / 1e9,
           "bound_ms_f32": flops / H100_FLOPS["float32"] * 1e3,
           "bound_ms_tf32": flops / TF32_FLOPS * 1e3}
    for tag, precision in (("tf32_off", "highest"), ("tf32_on", "fast")):
        with float32_precision(precision) as tf32:
            for _ in range(N_TAG_WARMUP):
                trainer.train_step(batch, gen)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(N_TAG_TIMED):
                loss = trainer.train_step(batch, gen)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / N_TAG_TIMED * 1e3
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            events, attr, rows = device_rows(
                torch, lambda: trainer.train_step(batch, gen))
            write_table(events, attr, profile_dir,
                        f"tagger_{name}_{tag}_profile.txt")
        device_ms = sum(t for t, _, _ in rows) / 1e3
        assert math.isfinite(float(loss)), (name, tag, float(loss))
        out[tag] = {"ms_per_step": ms, "peak_gib": peak,
                    "device_ms": device_ms, "busy_share": device_ms / ms,
                    "launches": sum(n for _, _, n in rows),
                    "loss": float(loss), "tf32": tf32,
                    "top": [{"name": k[:60], "ms": t / 1e3, "calls": n}
                            for t, k, n in rows[:5]]}
    del trainer, batch
    torch.cuda.empty_cache()
    return out


def tagger_card_vs_cpu(torch, dev, arch, mean_teacher):
    """One forward (eval mode) and one step of the same fresh tagger on
    the card and on the CPU, TF32 off, ``TAG_CPU_CLIPS`` + ``TAG_CPU_CLIPS``
    full-width clips; the teacher's noise and VGG's keep mask drawn once
    and fed to both. Relative Frobenius distances (the Adam moment is
    0.1·g after one step); the gradients carry the ReLU and max-pool
    decisions that float32 roundings turn (tests/
    test_torch_tagging_trainer.py), hence their looser gate."""
    import numpy as np

    from bsed_tpu_torch.config import get_config
    from bsed_tpu_torch.train.tagging_trainer import TaggingTrainer
    from bsed_tpu_torch.utils import weights
    from bsed_tpu_torch.utils.device import float32_precision

    cfg = get_config("baseline")
    cpu = torch.device("cpu")
    batch = tagger_batch(torch, cfg, cpu, TAG_CPU_CLIPS, 31)
    gen = torch.Generator().manual_seed(2)
    draws = {}
    if mean_teacher:
        draws["noise"] = torch.randn(batch["real"].shape, generator=gen)
    if arch == "vgg":
        draws["keep"] = torch.rand((TAG_CPU_CLIPS, 4096), generator=gen) < 0.5
    res = {}
    with float32_precision("highest"):
        for where in (dev, cpu):
            t = TaggingTrainer(cfg, arch=arch, mean_teacher=mean_teacher,
                               device=where)
            post = t.predict_weak(batch["syn"])
            t0 = time.perf_counter()
            loss = t.train_step({k: v.to(where) for k, v in batch.items()},
                                torch.Generator(device=where).manual_seed(0),
                                {k: v.to(where) for k, v in draws.items()})
            loss = float(loss)
            seconds = time.perf_counter() - t0
            _, stats = weights.export_named(t.model)
            mu = weights._export_opt(
                t.optimizer, weights.named_param_map(t.model))["mu"]
            res[where.type] = (post, loss, stats, mu, seconds)
            del t
    flat = lambda tree: torch.from_numpy(np.concatenate([  # noqa: E731
        np.ravel(v) for _, v in sorted(state_leaves(tree).items())]))
    (p_c, l_c, s_c, m_c, sec_c), (p_h, l_h, s_h, m_h, sec_h) = \
        res["cuda"], res["cpu"]
    out = {"arch": arch, "mean_teacher": mean_teacher,
           "clips": TAG_CPU_CLIPS,
           "posteriors_max_abs": float(np.abs(p_c - p_h).max()),
           "posteriors_rel_fro": rel_fro(torch.from_numpy(p_c),
                                         torch.from_numpy(p_h)),
           "loss_rel": abs(l_c - l_h) / abs(l_h),
           "bn_stats_rel_fro": rel_fro(flat(s_c), flat(s_h)),
           "mu_rel_fro": rel_fro(flat(m_c), flat(m_h)),
           "step_s_card": sec_c, "step_s_cpu": sec_h}
    g = TAG_GATES
    assert (out["posteriors_max_abs"] <= g["posteriors_abs"]
            and out["loss_rel"] <= g["loss_rel"]
            and out["bn_stats_rel_fro"] <= g["bn_stats_rel"]
            and out["mu_rel_fro"] <= g["mu_rel"]), out
    return out


def _imagenet_resnet18_state(torch, seed):
    """A torchvision-key resnet18 state dict of ImageNet's shapes (a
    3-channel stem, a 1000-class fc) with random tensors from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, o, i, k):
        sd[name + ".weight"] = torch.randn((o, i, k, k), generator=gen) * \
            math.sqrt(2.0 / (i * k * k))

    def bn(name, c):
        sd[name + ".weight"] = 1.0 + 0.1 * torch.randn(c, generator=gen)
        sd[name + ".bias"] = 0.1 * torch.randn(c, generator=gen)
        sd[name + ".running_mean"] = 0.1 * torch.randn(c, generator=gen)
        sd[name + ".running_var"] = 0.5 + torch.rand(c, generator=gen)
        sd[name + ".num_batches_tracked"] = torch.tensor(0)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for s, f in enumerate((64, 128, 256, 512)):
        for b in range(2):
            p = f"layer{s + 1}.{b}"
            conv(p + ".conv1", f, cin if b == 0 else f, 3)
            bn(p + ".bn1", f)
            conv(p + ".conv2", f, f, 3)
            bn(p + ".bn2", f)
            if b == 0 and s > 0:
                conv(p + ".downsample.0", f, cin, 1)
                bn(p + ".downsample.1", f)
        cin = f
    sd["fc.weight"] = 0.01 * torch.randn((1000, 512), generator=gen)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def _write_cycle_root(root, cfg, seed=41):
    """The ``--data-root`` layout (``CYCLE_CLIPS``): full-width npy dumps,
    event tables written with ``csv``; the unlabeled split has none."""
    import csv
    import os

    import numpy as np

    rng = np.random.default_rng(seed)
    d = cfg.data
    splits = {"syn": os.path.join(d.synth_root, d.synth_feature_subdir),
              "weak": os.path.join(d.dataset_root, d.train_weak_subdir),
              "unlabeled": os.path.join(d.dataset_root,
                                        d.train_unlabeled_subdir),
              "val": os.path.join(d.dataset_root, d.val_subdir)}
    for split, sub in splits.items():
        wav = os.path.join(root, sub, "wav")
        ann = os.path.join(root, sub, "annotation")
        os.makedirs(wav, exist_ok=True)
        os.makedirs(ann, exist_ok=True)
        for i in range(CYCLE_CLIPS[split]):
            name = f"{split}_{i:03d}"
            np.save(os.path.join(wav, name + ".npy"), np.abs(
                rng.standard_normal((cfg.audio.max_frames,
                                     cfg.audio.n_mels))).astype(np.float32))
            if split == "unlabeled":
                continue
            with open(os.path.join(ann, name + ".txt"), "w",
                      newline="") as fh:
                w = csv.writer(fh, delimiter="\t", lineterminator="\n")
                w.writerow(["event_label", "onset", "offset"])
                for _ in range(int(rng.integers(1, 4))):
                    onset = float(rng.uniform(0.0, 8.0))
                    w.writerow([cfg.bird_list[int(rng.integers(cfg.nclass))],
                                onset, min(onset + float(rng.uniform(0.3,
                                                                     2.0)),
                                           10.0)])
    return os.path.join(root, splits["unlabeled"])


def tagger_cycle(torch):
    """The pseudo-labeling cycle through the CLI on a full-width
    ``--data-root`` (``CYCLE_CLIPS``): ``tag-train --epochs 2
    --weights-file`` an ImageNet-shaped torchvision state dict (the stem
    and fc skipped) ``--save``, then ``pseudo-label`` over the unlabeled
    split, both in subprocesses (TF32 off, as they print), then ``train
    --preset baseline_mt_isp --perf --pseudo-labels --epochs 1``
    in-process with its launches by kind: K2 train and K3 in
    ``train_epoch`` (6 and 3 a step), K2 eval and K4 in ``evaluate`` (7
    and 2 a val batch). Returns (summary, launches)."""
    import csv
    import os
    import tempfile

    from bsed_tpu_torch import cli
    from bsed_tpu_torch.config import get_config
    from bsed_tpu_torch.data.codec import ManyHotEncoder
    from bsed_tpu_torch.data.datasets import PseudoLabeledDataset

    cfg = get_config("baseline")
    out, rec = {}, FitRecorder(torch)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "root")
        t0 = time.perf_counter()
        unlab_dir = _write_cycle_root(root, cfg)
        out["fixture_s"] = time.perf_counter() - t0
        init = os.path.join(tmp, "imagenet_resnet18.pt")
        torch.save(_imagenet_resnet18_state(torch, 3), init)
        weights = os.path.join(tmp, "tagger.pt")
        stdout, last, wall = _cli_subprocess(
            ["tag-train", "--data-root", root, "--epochs", "2",
             "--weights-file", init, "--save", weights], "tag-train")
        epochs = [line for line in stdout.splitlines()
                  if line.startswith("{'epoch'")]
        assert len(epochs) == 2 and os.path.exists(weights), stdout[-2000:]
        kept = [line for line in stdout.splitlines()
                if "kept fresh init for" in line]
        assert kept and "stem_conv" in kept[0] and "fc" in kept[0], kept
        assert last["tf32"] == {"matmul_tf32": False, "cudnn_tf32": False}
        out["tag_train"] = {"epochs": epochs, "epoch_s": last["epoch_seconds"],
                            "subprocess_wall_s": wall, "tf32": last["tf32"],
                            "pretrained_skipped": kept[0].split("for ")[-1]}
        pl_tsv = os.path.join(tmp, "pl.tsv")
        stdout, last, wall = _cli_subprocess(
            ["pseudo-label", "--data-root", root, "--weights", weights,
             "--out-tsv", pl_tsv], "pseudo-label")
        assert last["tf32"] == {"matmul_tf32": False, "cudnn_tf32": False}
        with open(pl_tsv, newline="") as fh:
            rows = list(csv.reader(fh, delimiter="\t"))[1:]
        assert len(rows) == last["clips"] == CYCLE_CLIPS["unlabeled"], last
        codec = ManyHotEncoder(cfg.bird_list)
        n_read = len(PseudoLabeledDataset(unlab_dir, pl_tsv, codec, cfg)
                     ._weak)
        assert n_read == len(rows), (n_read, len(rows))
        out["pseudo_label"] = {
            "rows": len(rows), "rows_labeled": sum(bool(r[1]) for r in rows),
            "labels": sum(len(r[1].split(",")) for r in rows if r[1]),
            "seconds": last["seconds"],
            "clips_per_s": last["clips"] / last["seconds"],
            "subprocess_wall_s": wall, "tf32": last["tf32"]}
        rec.run = "pl_train"
        store = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        with rec:
            best = cli.main(["train", "--data-root", root, "--preset",
                             "baseline_mt_isp", "--perf", "--epochs", "1",
                             "--pseudo-labels", pl_tsv, "--store-dir",
                             store])
            torch.cuda.synchronize()
        out["train_pseudo_labels_s"] = time.perf_counter() - t0
    steps = CYCLE_CLIPS["syn"] // B_TRAIN
    val_batches = -(-CYCLE_CLIPS["val"] // B_TRAIN)
    launches = {"stem_epilogue_train": 0, "stem_epilogue_bwd": 0,
                "stem_epilogue": 0, "gru_kernel": 0}
    for c in rec.of("pl_train", "train_epoch"):
        assert (c["k2"], c["k3"], c["k4"]) == (6 * steps, 3 * steps, 0), c
        launches["stem_epilogue_train"] += c["k2"]
        launches["stem_epilogue_bwd"] += c["k3"]
    for c in rec.of("pl_train", "evaluate"):
        assert (c["k2"], c["k3"], c["k4"]) == (K2_EVAL * val_batches, 0,
                                               2 * val_batches), c
        launches["stem_epilogue"] += c["k2"]
        launches["gru_kernel"] += c["k4"]
    assert all(launches.values()), launches
    assert math.isfinite(best["loss"]), best
    out["train_pseudo_labels"] = {
        "loss": best["loss"], "steps": steps, "val_batches": val_batches,
        "launches": launches}
    return out, launches


def tagger_path(torch, dev, card, profile_dir=None):
    """The weak tagger on the card: the four taggers' steps
    (``tagger_steps``), the card against the CPU (``tagger_card_vs_cpu``)
    for ResNet with its teacher and VGG, and the pseudo-labeling cycle
    through the CLI (``tagger_cycle``). Returns the cycle's last step's
    launches by kernel entry."""
    t_phase = time.perf_counter()
    runs = [tagger_steps(torch, dev, a, mt, profile_dir)
            for a, mt in TAGGER_RUNS]
    vs_cpu = [tagger_card_vs_cpu(torch, dev, a, mt)
              for a, mt in (("resnet", True), ("vgg", False))]
    torch.cuda.empty_cache()
    cycle, launches = tagger_cycle(torch)
    emit(phase="tagger_path", batch_syn=B_TRAIN, batch_real=B_TRAIN,
         warmup_steps=N_TAG_WARMUP, timed_steps=N_TAG_TIMED, steps=runs,
         card_vs_cpu=vs_cpu, card_vs_cpu_gates=TAG_GATES, cycle=cycle,
         cycle_clips=CYCLE_CLIPS, seconds=time.perf_counter() - t_phase,
         card=card)
    return launches


# --- the 'crnn' head and recurrent dropout (item 8c) -----------------------

HEAD = {"predictor_head": "crnn"}
REC_RATE = 0.5
REC_DROP = {"dropout_recurrent": REC_RATE}
# (name, preset, --perf form, model fields) of crnn_head_path's step runs
HEAD_RUNS = (("head", "baseline_mt_isp", False, HEAD),
             ("head", "baseline_mt_isp", True, HEAD),
             ("recurrent_dropout", "baseline_mt_isp", False, REC_DROP),
             ("recurrent_dropout", "baseline_mt_isp", True, REC_DROP),
             ("recurrent_dropout", "baseline_fpn_mt_isp", False, REC_DROP))
N_HEAD_TIMED = 3
HEAD_FIT_CLIPS = 24               # SYN clips of the store's epoch (2 steps)


def _k_counters():
    """Every kernel entry's launch counter: K1, K2 (both forms), K3, K4,
    K5."""
    from bsed_tpu_torch.ops import (gru_kernel, mel_kernel, stem_epilogue,
                                    stem_kernel)
    return {"mel_kernel": mel_kernel.fused_block_mel,
            "stem_epilogue_fwd": stem_epilogue.stem_epilogue_fwd,
            "stem_epilogue_bwd": stem_epilogue.stem_epilogue_bwd,
            "gru_kernel": gru_kernel.gru_bidir_recurrence,
            "stem_kernel": stem_kernel.fused_stem_block}


class Tally:
    """Launches of the driven parts of a phase: ``with tally.part():``
    sets every counter to 0 just before the part and adds what it reads
    just after; ``last`` holds the part's own counts."""

    def __init__(self):
        self.total = dict.fromkeys(_k_counters(), 0)
        self.last = {}

    def part(self):
        import contextlib

        @contextlib.contextmanager
        def counted():
            counters = _k_counters()
            for c in counters.values():
                c.launches = 0
            yield
            self.last = {k: c.launches for k, c in counters.items()}
            for k, v in self.last.items():
                self.total[k] += v
        return counted()


def _gru_masks(torch, model):
    """Record the keep masks every BidirectionalGRU of ``model`` draws for
    its inter-layer dropout (the same draw, from the same generator)."""
    from bsed_tpu_torch.models.rnn import BidirectionalGRU
    from bsed_tpu_torch.ops import dropout as dropout_mod

    masks = []
    for mod in model.modules():
        if isinstance(mod, BidirectionalGRU) and mod.dropout.rate > 0:
            drop = mod.dropout

            def forward(x, gen=None, keep=None, _drop=drop):
                if _drop.training and keep is None:
                    keep = dropout_mod.keep_mask(gen, x.shape, _drop.rate,
                                                 x.device)
                    masks.append(keep)
                return type(_drop).forward(_drop, x, gen, keep=keep)
            drop.forward = forward
    return masks


def head_steps(torch, dev, tally, name, preset, perf, model):
    """2 warm-up and N_HEAD_TIMED timed steps (epoch 30, 12 + 12
    full-width clips, bf16 in the --perf form) of ``preset`` with
    ``model``'s fields: ms a step, launches a step (K2's train form 6 and
    K3 3 in the --perf form, nothing in the reference form), finite
    metrics; with the head, its running statistics must move; with
    recurrent dropout, the GRUs' masks of the timed steps must drop within
    4σ of the rate."""
    cfg, state, step, batch = preset_setup(torch, dev, preset, perf,
                                           "bfloat16", B_TRAIN,
                                           model=model)
    for _ in range(N_PRESET_WARMUP):
        step(state, batch, 1, 30.0)
    torch.cuda.synchronize()
    head0 = [b.clone() for b in state.model.predictor.buffers()]
    masks = _gru_masks(torch, state.model)
    with tally.part():
        t0 = time.perf_counter()
        for _ in range(N_HEAD_TIMED):
            metrics = step(state, batch, 1, 30.0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / N_HEAD_TIMED * 1e3
    launched = tally.last
    values = {k: float(v) for k, v in metrics.items()}
    assert all(math.isfinite(v) for v in values.values()), (name, values)
    want = ({"stem_epilogue_fwd": 6 * N_HEAD_TIMED,
             "stem_epilogue_bwd": 3 * N_HEAD_TIMED} if perf else {})
    assert {k: v for k, v in launched.items() if v} == want, \
        (name, perf, launched)
    out = {"run": name, "preset": preset, "form": "perf" if perf
           else "reference", "ms_per_step": ms, "loss": values["loss"],
           "launches_per_step": {k: v / N_HEAD_TIMED
                                 for k, v in launched.items() if v}}
    if "predictor_head" in model:
        moved = max(float((a - b).abs().max()) for a, b in
                    zip(head0, state.model.predictor.buffers()))
        assert moved > 0, "the head's running statistics did not move"
        out["head_stats_max_move"] = moved
        out["head_buffers"] = len(head0)
    if "dropout_recurrent" in model:
        n = sum(m.numel() for m in masks)
        share = 1.0 - sum(float(m.float().sum()) for m in masks) / n
        sigma = math.sqrt(REC_RATE * (1 - REC_RATE) / n)
        assert abs(share - REC_RATE) <= 4 * sigma, (share, sigma)
        out.update(recurrent_masks=len(masks),
                   recurrent_masks_per_step=len(masks) / N_HEAD_TIMED,
                   recurrent_drop_share=share, recurrent_4_sigma=4 * sigma)
    del state, step, batch
    torch.cuda.empty_cache()
    return out


def head_serving(torch, dev, tally, fused_stem):
    """make_fast_forward with the head on preset baseline, float32, B=64
    full-width clips (random weights from seed 0): the head turns the
    folded stem off, so the standard branch runs K1 once and K4 twice a
    batch (with ``fused_stem``, K5 once too) and K2 never; N_TIMED timed
    batches, then the plain versions' posteriors on the same clips."""
    from bsed_tpu_torch.config import get_config
    from bsed_tpu_torch.serve import make_fast_forward
    from bsed_tpu_torch.utils.weights import init_params

    cfg = get_config("baseline")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **HEAD))
    params, stats = init_params(cfg, 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    audio = torch.randn((B_SERVE, cfg.audio.n_samples), generator=gen,
                        device=dev) * 0.1
    kw = dict(device=dev, precision="high", use_fused_stem=fused_stem)
    forward = make_fast_forward(cfg, params, stats, **kw)
    for _ in range(2):
        forward(audio)
    torch.cuda.synchronize()
    with tally.part():
        t0 = time.perf_counter()
        for _ in range(N_TIMED):
            strong, weak = forward(audio)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / N_TIMED * 1e3
    launched = {k: v for k, v in tally.last.items() if v}
    want = {"mel_kernel": N_TIMED, "gru_kernel": 2 * N_TIMED}
    if fused_stem:
        want["stem_kernel"] = N_TIMED
    assert launched == want, (fused_stem, launched)
    assert strong.shape == (B_SERVE, cfg.n_frames, cfg.nclass), strong.shape
    with kernels_if(False):
        ps, pw = make_fast_forward(cfg, params, stats, **kw)(audio)
    torch.cuda.synchronize()
    gap = max(float((strong - ps).abs().max()), float((weak - pw).abs().max()))
    assert torch.isfinite(strong).all() and gap <= EVAL_GATE, gap
    return {"fused_stem": fused_stem, "dtype": "float32", "batch": B_SERVE,
            "batches": N_TIMED, "ms_per_batch": ms,
            "clips_per_s": B_SERVE / ms * 1e3,
            "launches_per_batch": {k: v / N_TIMED
                                   for k, v in launched.items()},
            "max_abs_err_vs_plain": gap, "gate": EVAL_GATE}


def head_store(torch, dev, tally, store):
    """A one-epoch ``Trainer.fit`` of baseline_mt_isp --perf with the head
    and recurrent dropout into ``store`` (HEAD_FIT_CLIPS SYN, half as many
    weak and unlabelled, 24 val clips, batch 12: 2 steps, 2 val batches),
    then the port's CLI ``eval --store-dir`` and ``predict`` on the store
    in subprocesses, which rebuild the configuration from its meta."""
    import ast
    import os

    import numpy as np

    from bsed_tpu_torch.config import get_config, perf_config
    from bsed_tpu_torch.data.datasets import SyntheticDataSource
    from bsed_tpu_torch.data.pipeline import EvalLoader, ThreeStreamLoader
    from bsed_tpu_torch.train.trainer import Trainer
    from bsed_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = perf_config(get_config("baseline_mt_isp"))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **HEAD,
                                                **REC_DROP))
    n = HEAD_FIT_CLIPS
    loader = ThreeStreamLoader(
        SyntheticDataSource(cfg, n_items=n, seed=1),
        SyntheticDataSource(cfg, n_items=n // 2, seed=2),
        SyntheticDataSource(cfg, n_items=n // 2, seed=3),
        batch_size=B_TRAIN, seed=cfg.train.seed, device=dev)
    val = EvalLoader(SyntheticDataSource(cfg, n_items=24, seed=4),
                     batch_size=B_TRAIN, device=dev)
    trainer = Trainer(cfg, loader, val_loader=val, store_dir=store,
                      mesh="off", device=dev)
    with tally.part():
        t0 = time.perf_counter()
        trainer.fit(n_epochs=1)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    fit_launches = {k: v for k, v in tally.last.items() if v}
    # 2 steps: K2 train 6 and K3 3 a step; 2 val batches: K4 2 a batch
    assert fit_launches == {"stem_epilogue_fwd": 12, "stem_epilogue_bwd": 6,
                            "gru_kernel": 4}, fit_launches
    row = trainer.history[0]
    assert all(math.isfinite(v) for v in row.values()
               if isinstance(v, float)), row
    meta = CheckpointManager(store).load_meta()
    assert meta["config"]["model"]["predictor_head"] == "crnn", meta
    assert meta["config"]["model"]["dropout_recurrent"] == REC_RATE, meta
    trees = CheckpointManager(store).load("best")
    assert "predictor" in trees["batch_stats"]

    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "bsed_tpu_torch.cli",
                           "eval", "--store-dir", store, "-s", str(n)],
                          cwd=root, capture_output=True, text=True,
                          timeout=600)
    eval_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"eval --store-dir exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    scores = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    rec = os.path.join(store, "recording.npy")
    np.save(rec, np.random.default_rng(8).standard_normal(
        3 * cfg.audio.n_samples).astype(np.float32) * 0.1)
    tsv = os.path.join(store, "events.tsv")
    pred = _predict_cli(["--store-dir", store, "--audio", rec,
                         "--out-tsv", tsv], "crnn head store")
    with open(tsv) as fh:
        assert fh.readline().split() == ["filename", "event_label",
                                         "onset", "offset"]
    return {"clips": {"syn": n, "weak": n // 2, "unlabeled": n // 2,
                      "val": 24}, "fit_seconds": fit_s,
            "fit_launches": fit_launches,
            "val_event_f1": row.get("val_event_f1"),
            "eval_store_dir": {"rc": proc.returncode,
                               "event_f1": scores["event_f1"],
                               "psds_f1": scores["psds_f1"],
                               "subprocess_wall_s": eval_wall},
            "predict": {"rc": 0, "events": pred["events"],
                        "batches": pred["batches"],
                        "subprocess_wall_s": pred["subprocess_wall_s"]}}


def crnn_head_path(torch, dev, card):
    """Phase ``crnn_head_path`` (item 8c): ``HEAD_RUNS``' steps at full
    width (``head_steps``); the f32 --perf step with the head and with
    recurrent dropout, kernels against plain versions at train_equality's
    gates (``preset_equality``: the comparisons' launches do not count);
    the head served through make_fast_forward, standard and fused-stem
    branches (``head_serving``); a store trained with the head and
    recurrent dropout, then ``eval --store-dir`` and ``predict`` on it
    (``head_store``). Returns the launches of the driven parts (the timed
    steps, the timed batches and the fit) by kernel entry."""
    import tempfile

    t_phase = time.perf_counter()
    tally = Tally()
    runs = [head_steps(torch, dev, tally, *r) for r in HEAD_RUNS]
    equality = {name: preset_equality(torch, dev, "baseline_mt_isp", model)
                for name, model in (("head", HEAD),
                                    ("recurrent_dropout", REC_DROP))}
    torch.cuda.empty_cache()
    serving = [head_serving(torch, dev, tally, fused)
               for fused in (False, True)]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        store = head_store(torch, dev, tally, tmp)
    t = tally.total
    launches = {"mel_kernel": t["mel_kernel"],
                "stem_epilogue_train": t["stem_epilogue_fwd"],
                "stem_epilogue_bwd": t["stem_epilogue_bwd"],
                "gru_kernel": t["gru_kernel"],
                "stem_kernel": t["stem_kernel"]}
    emit(phase="crnn_head_path", batch_syn=B_TRAIN, batch_real=B_TRAIN,
         epoch=30.0, warmup_steps=N_PRESET_WARMUP, timed_steps=N_HEAD_TIMED,
         perf_compute_dtype="bfloat16", recurrent_rate=REC_RATE,
         steps=runs, f32_kernels_vs_plain=equality,
         equality_gates={"metrics": 1e-4, "mu": 3e-5, "bn_stats": 1e-5},
         serving=serving, store=store, launches=launches,
         seconds=time.perf_counter() - t_phase, card=card)
    return launches


GATE_EVAL_EVERY = 20              # epochs between evaluations
GATE_MAX_EPOCHS = 300
GATE_STOP_F1 = 0.15               # early stop, as bsed_tpu's gate
GATE_MIN_F1 = 0.10                # the gate: best event F1 at least this
GATE_MIN_ORACLE = 0.9             # and the decode-path oracle above this


def learning_gate(device="cuda", perf=False, log=print):
    """The event-F1 learning gate (the port of ``tests/f1_gate_worker.py``
    and its parent test, ``tests/test_trainer.py::
    test_training_reaches_event_f1_on_plantable_signal``):
    ``baseline_mt_isp`` at sr 3200, hop 80, 4 s clips, dropout 0.1,
    batch 8, constant lr 2e-3; ``SyntheticDataSource`` streams of 128 / 32
    / 32 clips (seeds 1 / 2 / 3, event rate 0.10, cue boost 8) and 32 val
    clips (seed 4); the port's ``Trainer`` on ``device``, evaluated every
    20 epochs for up to 300, stopping once the best event F1 reaches 0.15.
    ``perf=True`` trains the ``--perf`` form (``perf_config``: bf16, the
    folded train stem with K2's train form and K3 in every step, fused
    streams). The decode-path oracle feeds the val set's ground-truth frame
    targets through ``decode_batch`` and the event matcher.

    Returns {oracle_f1, best_f1, f1_by_epoch, epochs, steps, seconds,
    steps_per_s} plus the kernel launches of the training epochs and of
    the evaluations (K2 forward, K3, K4). The gate, as ``bsed_tpu``'s:
    oracle > 0.9 and best F1 >= 0.10; the caller holds it."""
    import tempfile

    import numpy as np
    import torch

    from bsed_tpu_torch.config import AudioConfig, get_config, perf_config
    from bsed_tpu_torch.data.datasets import SyntheticDataSource
    from bsed_tpu_torch.data.pipeline import EvalLoader, ThreeStreamLoader
    from bsed_tpu_torch.eval.decode import (decode_batch,
                                            groundtruth_df_from_events,
                                            merge_prediction_dfs)
    from bsed_tpu_torch.eval.sed_scores import event_based_f1
    from bsed_tpu_torch.train.trainer import Trainer

    cfg = get_config("baseline_mt_isp").replace(
        audio=AudioConfig(sr=3200, hop_size=80, max_len_seconds=4.0))
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, dropout=0.1),
        train=dataclasses.replace(cfg.train, batch_size=8, adjust_lr=False,
                                  max_learning_rate=2e-3))
    if perf:
        cfg = perf_config(cfg)

    def mk(n, seed):
        return SyntheticDataSource(cfg, n_items=n, seed=seed,
                                   event_rate=0.10, signal_boost=8.0)

    loader = ThreeStreamLoader(mk(128, 1), mk(32, 2), mk(32, 3),
                               batch_size=8, seed=cfg.train.seed,
                               device=device)
    val_ds = mk(32, 4)
    val = EvalLoader(val_ds, batch_size=8, device=device)

    pred_dfs = []
    for _, target, names, nv in val:
        t = np.asarray(target)[:nv].astype(np.float32)
        pred_dfs.append(decode_batch(t, names[:nv], cfg.bird_list, cfg,
                                     thresholds=(0.5,)))
    gt = {val_ds.filename(i): list(val_ds.events(i))
          for i in range(len(val_ds))}
    oracle = event_based_f1(groundtruth_df_from_events(gt),
                            merge_prediction_dfs(pred_dfs)[0.5])

    counters = _counters()
    train_launches = [0, 0, 0]
    eval_launches = [0, 0, 0]

    def tally(into, before):
        for i, c in enumerate(counters):
            into[i] += c.launches - before[i]

    with tempfile.TemporaryDirectory() as store:
        trainer = Trainer(cfg, loader, val_loader=val, store_dir=store,
                          mesh="off", scan_epoch="auto", device=device)
        best, epochs, f1_by_epoch = 0.0, 0, {}
        t0 = time.perf_counter()
        for e in range(GATE_MAX_EPOCHS):
            before = _launch_counts()
            trainer.train_epoch(e)
            tally(train_launches, before)
            epochs = e + 1
            if epochs % GATE_EVAL_EVERY == 0:
                before = _launch_counts()
                f1 = trainer.evaluate(trainer.val_loader)["event_f1"]
                tally(eval_launches, before)
                f1_by_epoch[epochs] = f1
                best = max(best, f1)
                log(f"learning_gate {'perf' if perf else 'reference'}: "
                    f"epoch {epochs} event F1 {f1:.4f} (best {best:.4f}, "
                    f"{time.perf_counter() - t0:.1f} s)")
                if best >= GATE_STOP_F1:
                    break
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    steps = epochs * len(loader)
    keys = ("stem_epilogue_fwd", "stem_epilogue_bwd", "gru_kernel")
    return {"form": "perf" if perf else "reference",
            "oracle_f1": float(oracle), "best_f1": float(best),
            "f1_by_epoch": f1_by_epoch, "epochs": epochs, "steps": steps,
            "seconds": seconds, "steps_per_s": steps / seconds,
            "launches_train": dict(zip(keys, train_launches)),
            "launches_eval": dict(zip(keys, eval_launches))}


def _log_stderr(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def _gate_worker(group):
    """Rank 0 runs the gate's reference form, rank 1 its --perf form."""
    return learning_gate(group.device, perf=group.rank == 1,
                         log=_log_stderr)


def learning_gate_phase(torch, dev, card):
    """Phase ``learning_gate``: the gate in the reference form (gated:
    oracle > 0.9, best event F1 >= 0.10 within 300 epochs) and the
    ``--perf`` form (its trajectory printed, not gated). Both forms are
    host-bound at the recipe's tiny shapes, so they run side by side, one
    process each on the card (``parallel.launch.spawn`` gives them the
    process's TF32 settings and a time limit; they share no tensor), and
    the phase takes the slower one's time. Training launches no kernel in
    either form: the reference form is unfolded, and the --perf form's
    folded stem runs its epilogue unfused at the recipe's dropout 0.1,
    whose keep probability 0.9 is not k/256 (``folded_stem._ep_ok``, the
    rule of ``bsed_tpu``'s ``folded_stem.py:288-293``). Every evaluation
    runs K2's eval form 7 and K4 2 times a val batch. Returns the
    launches by kernel entry."""
    from bsed_tpu_torch.parallel.launch import spawn

    t0 = time.perf_counter()
    forms = spawn(_gate_worker, 2, backend="gloo", device="cuda:0",
                  timeout=1000)
    seconds = time.perf_counter() - t0
    for form in forms:
        emit(phase="learning_gate", **form, phase_seconds=seconds,
             card=card)
    for form in forms:
        assert form["launches_train"] == {"stem_epilogue_fwd": 0,
                                          "stem_epilogue_bwd": 0,
                                          "gru_kernel": 0}, form
    ref = forms[0]
    assert ref["form"] == "reference", ref["form"]
    assert ref["oracle_f1"] > GATE_MIN_ORACLE, ref
    assert ref["best_f1"] >= GATE_MIN_F1, ref
    evals = sum(f["epochs"] // GATE_EVAL_EVERY for f in forms)
    launches = {k: sum(f["launches_eval"][c] for f in forms)
                for k, c in (("stem_epilogue", "stem_epilogue_fwd"),
                             ("gru_kernel", "gru_kernel"))}
    # 32 val clips at batch 8
    assert launches == {"stem_epilogue": 4 * K2_EVAL * evals,
                        "gru_kernel": 8 * evals}, launches
    return launches


DP_WORLD = 2                      # ranks sharing the one card over gloo
DP_TIMED = 3                      # timed steps after the compared one
DP_FIT_CLIPS = 24                 # SYN clips of the Trainer epoch (2 steps)
DP_SERVE_B = 64
# gaps the 2-rank step may show against the 1-rank step on the card. In
# float32 only the order of sums and cuDNN's algorithms at B/2 differ (the
# CPU holds the step at rtol 1e-5, tests/test_torch_parallel.py; its
# gradients 2.2e-5 apart in relative Frobenius at the tiny size). In bf16
# the folded stem's activations and K3's bf16 dW passes round another
# batch split: 1.6e-2 on the CPU at the tiny size, 5.9e-2 on an H100
# (80GB HBM3, 700 W) at full width
DP_GATES = {"float32": {"metrics_rel": 1e-4, "grad_rel_fro": 1e-3,
                        "bn_stats_rel": 1e-4},
            "bfloat16": {"metrics_rel": 1e-2, "grad_rel_fro": 0.12,
                         "bn_stats_rel": 1e-2},
            "fit_rows_rel": 1e-2, "serve_abs": 1e-4}


def _structural_zero(path) -> bool:
    """Leaves whose exact gradient is 0 (a conv bias feeding a BatchNorm,
    the attention head's softmax bias): their values are noise."""
    name = "/".join(path)
    return (name.endswith("bias") and "conv" in name
            or name.endswith("dense_softmax/bias"))


def _dp_counts():
    return dict(zip(("stem_epilogue_fwd", "stem_epilogue_bwd",
                     "gru_kernel"), _launch_counts()))


def _dp_step(torch, dev, group, dtype="bfloat16"):
    """The flagship --perf step (``train_setup``: 12 + 12 full-width clips,
    ``dtype``, seed 0) on the global batch, or under ``group`` on this rank's
    rows: (metrics, state leaves after one step, the K2 / K3 / K4
    launches of that step and of all 1 + DP_TIMED steps, ms a step over
    the DP_TIMED)."""
    from bsed_tpu_torch.parallel.mesh import shard_batch
    from bsed_tpu_torch.train import steps

    cfg, state, step, batch = train_setup(torch, dev, dtype, B_TRAIN)
    if group is not None:
        modules = steps.build_modules(cfg, device=dev, group=group)
        state = steps.create_train_state(cfg, modules, 0)
        step = steps.make_train_step(modules)
        batch = shard_batch(group, batch)
    c0 = _dp_counts()
    metrics = step(state, batch, 1, 30.0)
    torch.cuda.synchronize()
    first = {k: v - c0[k] for k, v in _dp_counts().items()}
    out = ({k: float(v) for k, v in metrics.items()}, state_leaves(state))
    t0 = time.perf_counter()
    for _ in range(DP_TIMED):
        step(state, batch, 1, 30.0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / DP_TIMED * 1e3
    return out + (first, {k: v - c0[k] for k, v in _dp_counts().items()},
                  ms)


def _dp_step_worker(group, dtype):
    import torch
    return _dp_step(torch, group.device, group, dtype)


def _dp_trainer(torch, dev, store, group):
    """A --perf baseline_mt_isp Trainer on full-width synthetic clips:
    DP_FIT_CLIPS SYN, half as many weak and unlabelled, 24 val (batch 12:
    2 steps and 2 val batches). Under ``group`` (``mesh='auto'`` joins it)
    the rank reads its loader strided over the ranks at B_TRAIN / ranks
    clips a step, as the CLI builds it; without, one process reads the
    ranks' batches assembled in rank order."""
    import dataclasses

    from bsed_tpu_torch.config import get_config, perf_config
    from bsed_tpu_torch.data.datasets import SyntheticDataSource
    from bsed_tpu_torch.data.pipeline import (AssembledLoader, EvalLoader,
                                              ThreeStreamLoader)
    from bsed_tpu_torch.train.trainer import Trainer

    cfg = perf_config(get_config("baseline_mt_isp"))
    bs = B_TRAIN // DP_WORLD
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=bs))
    n = DP_FIT_CLIPS

    def strided(rank):
        return ThreeStreamLoader(
            SyntheticDataSource(cfg, n_items=n, seed=1),
            SyntheticDataSource(cfg, n_items=n // 2, seed=2),
            SyntheticDataSource(cfg, n_items=n // 2, seed=3),
            batch_size=bs, seed=cfg.train.seed, process_index=rank,
            process_count=DP_WORLD, device=dev)
    loader = (strided(group.rank) if group is not None
              else AssembledLoader([strided(r) for r in range(DP_WORLD)]))
    val = EvalLoader(SyntheticDataSource(cfg, n_items=24, seed=4),
                     batch_size=B_TRAIN, device=dev)
    return Trainer(cfg, loader, val_loader=val, store_dir=store,
                   mesh="auto", device=dev)


def _dp_fit(torch, dev, store, group=None):
    """(the epoch's row, the K2 / K3 / K4 launches of its train_epoch and
    of its evaluate, measured apart by a FitRecorder, seconds, and the
    seconds of its train, evaluate and checkpoint parts) of one Trainer
    epoch."""
    trainer = _dp_trainer(torch, dev, store, group)
    t0 = time.perf_counter()
    with FitRecorder(torch) as rec:
        rec.run = "fit"
        trainer.fit(n_epochs=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {}
    for kind in ("train_epoch", "evaluate"):
        calls = rec.of("fit", kind)
        launches[kind] = {name: sum(c[key] for c in calls) for name, key in
                          (("stem_epilogue_fwd", "k2"),
                           ("stem_epilogue_bwd", "k3"),
                           ("gru_kernel", "k4"))}
    return trainer.history[0], launches, seconds, rec.epochs("fit")[0]


def _dp_fit_worker(group, store):
    import torch
    return _dp_fit(torch, group.device, store, group)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def dp_step_gap(np, ref, got):
    """The 2-rank step's gaps to the 1-rank step: metrics (relative), the
    gradient through Adam's first moment (relative Frobenius per leaf,
    structural zeros left out), BatchNorm statistics (relative to each
    leaf's largest element), params (in units of lr)."""
    (m1, s1), (m2, s2) = ref[:2], got[:2]
    gaps = {"metrics_rel": max(_rel(m2[k], m1[k]) for k in m1)}
    fro = [(float(np.linalg.norm(s2[p] - s1[p])
                  / max(np.linalg.norm(s1[p]), 1e-30)), p,
            float(np.linalg.norm(s1[p]) / 0.1))
           for p in s1 if p[0] == "mu" and not _structural_zero(p)]
    gaps["grad_rel_fro"] = max(v for v, _, _ in fro)
    gaps["grad_worst_leaves"] = [{"leaf": "/".join(p), "rel_fro": v,
                                  "norm": n} for v, p, n in sorted(fro)[-3:]]
    gaps["bn_stats_rel"] = max(
        float(np.abs(s2[p] - s1[p]).max() / max(np.abs(s1[p]).max(), 1e-30))
        for p in s1 if p[0] in ("batch_stats", "ema_batch_stats"))
    gaps["params_max_abs_over_lr"] = max(
        float(np.abs(s2[p] - s1[p]).max()) for p in s1
        if p[0] == "params") / m1["lr"]
    return gaps


def data_parallel_path(torch, dev, card):
    """Phase ``data_parallel_path``: data parallelism on the one card.

      * a 1-rank NCCL group: ``train --preset baseline_mt_isp --perf -s
        24 --epochs 1`` through torchrun (``python -m
        torch.distributed.run --standalone --nproc-per-node 1``), so
        ``--mesh auto`` joins the job's group;
      * 2 ranks sharing the card over gloo (``parallel.launch.spawn``):
        the flagship --perf step (12 + 12 full-width clips) in float32 and
        in bf16 against the 1-rank step on the same global batch
        (``dp_step_gap`` against ``DP_GATES``), and a 2-rank ``Trainer``
        epoch (bf16, ``mesh='auto'``, each rank reading its strided
        loader) against the 1-rank epoch on the assembled batches, row by
        row, with the K2 / K3 / K4 launches of each rank's train_epoch
        and evaluate counted apart;
      * ``make_sharded_forward`` on ["cuda:0", "cuda:0"] at B=64 (float32,
        'high': each replica runs K1 once, K2 seven times and K4 twice a
        batch) against the single forward.

    Times by the host clock around synchronised work. Returns the
    launches of the 2-rank runs and the sharded forward by kernel entry
    (the ranks' counts summed)."""
    import os
    import tempfile

    import numpy as np

    from bsed_tpu_torch.config import get_config
    from bsed_tpu_torch.ops import mel_kernel
    from bsed_tpu_torch.parallel.launch import spawn
    from bsed_tpu_torch.serve import make_fast_forward, make_sharded_forward
    from bsed_tpu_torch.utils.weights import init_params

    t_phase = time.perf_counter()
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "nccl1")
        argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "1", "-m", "bsed_tpu_torch.cli", "train",
                "--preset", "baseline_mt_isp", "--perf", "-s", "24",
                "--epochs", "1", "--store-dir", store]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=600)
        rows = (read_results(os.path.join(store, "results.tsv"))
                if proc.returncode == 0 else None)
        report["nccl_1rank_train"] = {
            "rc": proc.returncode, "seconds": time.perf_counter() - t0,
            "rows": rows}
        if proc.returncode != 0 or not rows or not all(
                math.isfinite(v) for v in rows[0].values()):
            raise RuntimeError("torchrun train failed:\n"
                               + proc.stdout[-3000:] + proc.stderr[-3000:])

        report["step"], step_runs = {}, {}
        for dtype in ("float32", "bfloat16"):
            ref = _dp_step(torch, dev, None, dtype)
            t0 = time.perf_counter()
            ranks = spawn(_dp_step_worker, DP_WORLD, backend="gloo",
                          device="cuda:0", args=(dtype,), timeout=600)
            spawn_s = time.perf_counter() - t0
            step_runs[dtype] = (ref, ranks)
            report["step"][dtype] = {
                "ms_1rank": ref[4], "ms_2rank": [r[4] for r in ranks],
                "seconds_spawned": spawn_s, "launches_1rank": ref[3],
                "launches_2rank": [r[3] for r in ranks],
                "gaps": [dp_step_gap(np, ref, r) for r in ranks],
                "loss_1rank": ref[0]["loss"],
                "loss_2rank": ranks[0][0]["loss"]}
            torch.cuda.empty_cache()

        row1, fit_launches_1, fit_s1, fit_parts_1 = _dp_fit(
            torch, dev, os.path.join(tmp, "fit1"))
        t0 = time.perf_counter()
        fits = spawn(_dp_fit_worker, DP_WORLD, backend="gloo",
                     device="cuda:0", args=(os.path.join(tmp, "fit2"),),
                     timeout=600)
        fit_spawn_s = time.perf_counter() - t0
        # the train metrics; the val scores at random weights turn on
        # posteriors at the threshold and are reported, not gated
        fit_gap = max(_rel(f[0][k], row1[k]) for f in fits for k in row1
                      if k != "epoch" and not k.startswith("val_")
                      and abs(row1[k]) > 1e-6)
        report["fit"] = {
            "seconds_1rank": fit_s1, "seconds_2rank": [f[2] for f in fits],
            "parts_1rank": fit_parts_1, "parts_2rank": [f[3] for f in fits],
            "seconds_spawned": fit_spawn_s,
            "launches_1rank": fit_launches_1,
            "launches_2rank": [f[1] for f in fits],
            "rows_max_rel_gap": fit_gap,
            "loss_1rank": row1["loss"], "loss_2rank": fits[0][0]["loss"],
            "val_1rank": {k: v for k, v in row1.items()
                          if k.startswith("val_")},
            "val_2rank": {k: v for k, v in fits[0][0].items()
                          if k.startswith("val_")}}
    torch.cuda.empty_cache()

    cfg = get_config("baseline")
    params, stats = init_params(cfg, 0)
    audio = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (DP_SERVE_B, cfg.audio.n_samples)).astype(np.float32) * 0.1)
    single = make_fast_forward(cfg, params, stats, device=dev,
                               precision="high")
    sharded = make_sharded_forward(cfg, params, stats, [dev, dev],
                                   precision="high")
    serve_ms = {}
    for name, fwd in (("single", single), ("sharded", sharded),
                      ("sharded_again", sharded), ("single_again", single)):
        fwd(audio)
        torch.cuda.synchronize()
        c0 = _dp_counts()
        k1 = mel_kernel.fused_block_mel.launches
        t0 = time.perf_counter()
        for _ in range(N_TIMED):
            out = fwd(audio)
        torch.cuda.synchronize()
        serve_ms[name] = (time.perf_counter() - t0) / N_TIMED * 1e3
        if name == "sharded":
            serve_launches = {k: v - c0[k] for k, v in _dp_counts().items()}
            serve_launches["mel_kernel"] = (mel_kernel.fused_block_mel.launches
                                            - k1)
    want, got = single(audio), sharded(audio)
    serve_gap = max(float((a - b).abs().max()) for a, b in zip(got, want))
    report["serve"] = {"batch": DP_SERVE_B, "replicas": [str(dev)] * 2,
                       "ms": serve_ms, "launches_sharded": serve_launches,
                       "max_abs_gap": serve_gap}

    emit(phase="data_parallel_path", world=DP_WORLD, backend="gloo",
         gates=DP_GATES, seconds=time.perf_counter() - t_phase, card=card,
         **report)
    step_launch = {"stem_epilogue_fwd": 6, "stem_epilogue_bwd": 3,
                   "gru_kernel": 0}
    for dtype, (ref, ranks) in step_runs.items():
        assert ref[2] == step_launch, ref[2]
        assert all(r[2] == step_launch for r in ranks), [r[2] for r in ranks]
        for g in report["step"][dtype]["gaps"]:
            for k, gate in DP_GATES[dtype].items():
                assert g[k] <= gate, (dtype, k, g)
    assert fit_gap <= DP_GATES["fit_rows_rel"], fit_gap
    # an epoch of 2 steps (K2 train 6, K3 3 a step) and 2 val batches (K2
    # eval 7, K4 2 a batch), of which each of the 2 ranks evaluates one
    n_steps = DP_FIT_CLIPS // B_TRAIN
    fit_train = {"stem_epilogue_fwd": 6 * n_steps,
                 "stem_epilogue_bwd": 3 * n_steps, "gru_kernel": 0}
    assert fit_launches_1 == {"train_epoch": fit_train, "evaluate": {
        "stem_epilogue_fwd": 2 * K2_EVAL, "stem_epilogue_bwd": 0,
        "gru_kernel": 4}}, fit_launches_1
    assert all(f[1] == {"train_epoch": fit_train, "evaluate": {
        "stem_epilogue_fwd": K2_EVAL, "stem_epilogue_bwd": 0,
        "gru_kernel": 2}}
        for f in fits), [f[1] for f in fits]
    assert serve_launches == {"stem_epilogue_fwd": 2 * K2_EVAL * N_TIMED,
                              "stem_epilogue_bwd": 0,
                              "gru_kernel": 4 * N_TIMED,
                              "mel_kernel": 2 * N_TIMED}, serve_launches
    assert serve_gap <= DP_GATES["serve_abs"], serve_gap
    launches = {"mel_kernel": serve_launches["mel_kernel"],
                "stem_epilogue": serve_launches["stem_epilogue_fwd"],
                "stem_epilogue_train": sum(r[3]["stem_epilogue_fwd"]
                                           for _, rs in step_runs.values()
                                           for r in rs),
                "stem_epilogue_bwd": sum(r[3]["stem_epilogue_bwd"]
                                         for _, rs in step_runs.values()
                                         for r in rs),
                "gru_kernel": serve_launches["gru_kernel"]}
    for f in fits:               # the 2-rank epoch: train and its evaluate
        train, ev = f[1]["train_epoch"], f[1]["evaluate"]
        launches["stem_epilogue_train"] += train["stem_epilogue_fwd"]
        launches["stem_epilogue_bwd"] += train["stem_epilogue_bwd"]
        launches["stem_epilogue"] += ev["stem_epilogue_fwd"]
        launches["gru_kernel"] += train["gru_kernel"] + ev["gru_kernel"]
    return launches


ATTN_SHAPE = (B_SERVE, 12, 496, 64)   # BEATs at B=64: (B, H, L, D)
ATTN_GATE = 1e-2                      # of max |out|: see check_rel_attention


def attention_inputs(torch, dev, b, h, n, dtype, seed):
    """q, k, v as the model passes them (views (B, H, L, D) of (B, L, H·D)
    projections), gate in (1, 2) and a unit-normal bias (H, L, L)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = ATTN_SHAPE[3]
    q, k, v = (torch.randn((b, n, h * d), generator=gen, device=dev)
               .to(dtype).view(b, n, h, d).transpose(1, 2)
               for _ in range(3))
    gate = (1 + torch.rand((b, h, n, 1), generator=gen, device=dev)).to(dtype)
    bias = torch.randn((h, n, n), generator=gen, device=dev).to(dtype)
    return q, k, v, gate, bias


def check_rel_attention(torch, dev):
    """BEATs' gated relative-position attention (``csrc/rel_attention.cu``)
    at the cell's shape (B=64, 12 heads of 64, 496 tokens, bf16, q, k and
    v as the model's views) against its plain version in float32 on the
    same inputs: within 1e-2 of the output's largest magnitude (the
    weights and the output are each rounded to bf16 once, 2^-9 a value);
    the float32 body at B=8 within 2e-5 of it. Times: the kernel (CUDA
    events, and its device time from the profiler), the plain version,
    and as ``library_ms`` the form the port ran before it: g ⊙ P
    materialised in bf16 as the mask of
    ``F.scaled_dot_product_attention``, which the port never calls. The
    bound counts the work as ``serve.beats_attn_roofline`` does: q, k, v
    and the output once, the gate and the (320, 12) table, 4·B·H·L²·D
    operations in bf16."""
    import torch.nn.functional as F
    from bsed_tpu_torch.config import BeatsConfig
    from bsed_tpu_torch.ops import rel_attention as RA

    b, h, n, d = ATTN_SHAPE
    args = attention_inputs(torch, dev, b, h, n, torch.bfloat16, 31)
    before = RA.gated_rel_attention.launches
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = RA.gated_rel_attention(*args)
    torch.cuda.synchronize()
    peak_extra = torch.cuda.max_memory_allocated() - base
    want = RA.gated_rel_attention_plain(*args)
    err = float((got.float() - want).abs().max())
    scale = float(want.abs().max())
    zero_bias = (args[3], torch.zeros_like(args[4]))
    unit_gate = (torch.ones_like(args[3]), args[4])
    fault_errs = []
    for gate, bias in (zero_bias, unit_gate):
        w = RA.gated_rel_attention_plain(*args[:3], gate, bias)
        g = RA.gated_rel_attention(*args[:3], gate, bias)
        fault_errs.append(float((g.float() - w).abs().max()))
    del want, w
    a32 = attention_inputs(torch, dev, 8, h, n, torch.float32, 32)
    want32 = RA.gated_rel_attention_plain(*a32)
    err32 = float((RA.gated_rel_attention(*a32) - want32).abs().max())
    scale32 = float(want32.abs().max())
    torch.cuda.synchronize()
    launches = RA.gated_rel_attention.launches - before
    emit(phase="check_rel_attention", shape=list(ATTN_SHAPE),
         max_abs_err=err, max_abs_out=scale, gate=ATTN_GATE * scale,
         fault_inputs_max_abs_err=fault_errs, max_abs_err_f32_b8=err32,
         gate_f32=2e-5 * scale32, peak_extra_bytes=peak_extra,
         mask_bytes=b * h * n * n * 2, launches_check=launches,
         out_transposed_contiguous=got.transpose(1, 2).is_contiguous())
    assert launches == 4, launches
    assert err <= ATTN_GATE * scale, f"attention kernel differs by {err}"
    assert all(e <= ATTN_GATE * scale for e in fault_errs), fault_errs
    assert err32 <= 2e-5 * scale32, err32
    assert got.transpose(1, 2).is_contiguous()
    assert peak_extra < b * h * n * n * 2, peak_extra   # no mask written

    fn = lambda: RA.gated_rel_attention(*args)       # noqa: E731
    ms = time_ms(fn, 20)
    ms_pipe = pipelined_ms(fn, reps=20)
    dev_ms = kernel_device_ms(torch, fn, "rel_attention_mma")
    plain_ms = time_ms(lambda: RA.gated_rel_attention_plain(*args), 3,
                       warmup=1)
    q, k, v, gate, bias = args

    def library():
        mask = gate * bias
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    lib_err = float((library().float() - got.float()).abs().max())
    library_ms = time_ms(library, 10)
    ms32 = time_ms(lambda: RA.gated_rel_attention(*a32), 5)
    buckets = BeatsConfig().num_buckets
    nbytes = (4 * b * h * n * d + b * h * n + buckets * h) * 2
    flops = 4.0 * b * h * n * n * d
    b_ms, b_by = bound(nbytes, {"bfloat16": flops})
    rec = {"name": "rel_attention", "route": "cuda",
           "source": "bsed_tpu_torch/csrc/rel_attention.cu",
           "replaces": None, "max_abs_err": err,
           "ms": ms, "ms_pipelined": ms_pipe, "device_ms": dev_ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "roofline_pct": 100.0 * b_ms / dev_ms,
           "library_ms": library_ms, "library_max_abs_diff": lib_err,
           "library_call": "gate * bias (bf16 mask) -> "
                           "F.scaled_dot_product_attention",
           "ms_f32_b8": ms32,
           "resources": kernel_resources("rel_attention",
                                         "rel_attention_mma"),
           "gflop_per_call": flops / 1e9, "mb_per_call": nbytes / 1e6,
           "launches_check": launches}
    emit(phase="rel_attention_times", **rec)
    return rec


POS_CONV = (B_SERVE, 496, 768, 16, 128)   # BEATs at B=64: (B, L, d, g, K)
POS_CONV_GATE = (2e-3, 1e-2)     # of the norm, of max |out|: see below


def pos_conv_times(torch, dev):
    """BEATs' position convolution with its residual
    (``csrc/pos_conv.cu``) at the cell's shape (B=64, 496 tokens, d = 768
    in 16 groups of 48, 128 taps, bf16, x in the model's (B, L, d)
    layout, the weights re-laid once) against its plain version on the
    same inputs: within 2e-3 of the output's norm and 1e-2 of its largest
    magnitude (both sum in float32 and round once; another order of sums
    moves a rounding here and there). Times: the kernel (CUDA events, and
    its device time from the profiler), the plain version, and as
    ``library_ms`` cuDNN's TF32 grouped convolution on the same input as
    the port called it before (x transposed to float32 channels-first),
    ``library_chain_ms`` with the GELU, the cast and the add it took
    beside, ``library_device_ms`` the device time the profiler gives its
    kernels (named ``fprop``). The bound counts the work as
    ``portbench/harness/beats.py`` counts ``pos_conv``, 2·B·L·d·(d/g)·K
    operations in bf16, and x, the output and the weights moved once. The
    float32 body at B=8 beside."""
    import torch.nn.functional as F
    from bsed_tpu_torch import kernels
    from bsed_tpu_torch.ops import pos_conv as PC

    b, n, d, groups, taps = POS_CONV
    cg = d // groups
    gen = torch.Generator(device=dev).manual_seed(41)
    x = torch.randn((b, n, d), generator=gen, device=dev).bfloat16()
    w = (torch.randn((d, cg, taps), generator=gen, device=dev)
         / math.sqrt(cg * taps)).bfloat16()
    bias = (0.1 * torch.randn((d,), generator=gen, device=dev)).bfloat16()
    packed = PC.pack_weight(w, groups)
    before = PC.pos_conv_residual.launches
    got = PC.pos_conv_residual(x, w, bias, groups, packed)
    with kernels.plain_versions():
        want = PC.pos_conv_residual(x, w, bias, groups).float()
    torch.cuda.synchronize()
    launches = PC.pos_conv_residual.launches - before
    rel = float((got.float() - want).norm() / want.norm())
    err = float((got.float() - want).abs().max())
    scale = float(want.abs().max())
    emit(phase="check_pos_conv", shape=list(POS_CONV), rel_err=rel,
         max_abs_err=err, max_abs_out=scale, launches_check=launches)
    assert launches == 1, launches
    assert rel <= POS_CONV_GATE[0], rel
    assert err <= POS_CONV_GATE[1] * scale, err
    del want

    fn = lambda: PC.pos_conv_residual(x, w, bias, groups, packed)  # noqa: E731
    ms = time_ms(fn, 20)
    ms_pipe = pipelined_ms(fn, reps=20)
    dev_ms = kernel_device_ms(torch, fn, "pos_conv_mma")
    with kernels.plain_versions():
        plain_ms = time_ms(fn, 5)
    w32, b32 = w.float(), bias.float()

    def library():
        return F.conv1d(x.transpose(1, 2).float(), w32, b32,
                        padding=taps // 2, groups=groups)

    def library_chain():
        c = library()[..., :-1]
        return x + F.gelu(c).transpose(1, 2).to(x.dtype)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        lib_diff = float((library_chain().float() - got.float()).abs().max())
        library_ms = time_ms(library, 10)
        library_chain_ms = time_ms(library_chain, 10)
        library_device_ms = kernel_device_ms(torch, library, "fprop")
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    x8, w8, b8 = x[:8].float(), w32, b32
    ms32 = time_ms(lambda: PC.pos_conv_residual(x8, w8, b8, groups), 5)
    flops = 2.0 * b * n * d * cg * taps
    nbytes = 2 * b * n * d * 2 + d * cg * taps * 2 + d * 2
    b_ms, b_by = bound(nbytes, {"bfloat16": flops})
    rec = {"name": "pos_conv", "route": "cuda",
           "source": "bsed_tpu_torch/csrc/pos_conv.cu",
           "replaces": None, "rel_err": rel, "max_abs_err": err,
           "ms": ms, "ms_pipelined": ms_pipe, "device_ms": dev_ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "roofline_pct": 100.0 * b_ms / dev_ms,
           "tflop_per_s": flops / dev_ms / 1e9,
           "library_ms": library_ms, "library_chain_ms": library_chain_ms,
           "library_device_ms": library_device_ms,
           "library_max_abs_diff": lib_diff,
           "library_call": "F.conv1d(x.transpose(1, 2).float(), w, b, "
                           "padding=64, groups=16), TF32 (cuDNN)",
           "ms_f32_b8": ms32,
           "resources": kernel_resources("pos_conv", "pos_conv_mma"),
           "gflop_per_call": flops / 1e9, "mb_per_call": nbytes / 1e6,
           "launches_check": launches}
    emit(phase="pos_conv_times", **rec)
    return rec


def beats_path(torch, dev, card):
    """``crnn_beats`` served as the cell ``serve_beats_crnn_b64`` serves
    it: the baseline CRNN fused with BEATs at its published widths
    (``BeatsConfig()``: 12 layers of 12 heads, 496 tokens a 10 s clip)
    through ``make_fast_forward``, B=64, bf16 'high'; CRNN weights from
    seed 0, BEATs' from its modules' own initialisation (seed 20), the
    fusion's small. The attention's counter must read 12 a forward over
    ``N_TIMED`` forwards and the position convolution's 1; torch.profiler
    over 2 forwards must see the attention kernel launched 12 times a
    forward and no library attention (no kernel named flash, fmha or
    sdpa), and over 2 calls of the encoder alone the position
    convolution's kernel once a call and no library convolution (no
    kernel named fprop, convolve or cudnn). Returns the attention
    counter's launches and the position convolution's."""
    from bsed_tpu_torch.config import BeatsConfig, get_config
    from bsed_tpu_torch.models.beats import BEATs
    from bsed_tpu_torch.ops import pos_conv as PC
    from bsed_tpu_torch.ops import rel_attention as RA
    from bsed_tpu_torch.serve import make_fast_forward
    from bsed_tpu_torch.utils.weights import init_params

    bc = BeatsConfig()
    cfg = get_config("baseline")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16", beats=bc))
    params, stats = init_params(cfg, 0)
    torch.manual_seed(20)
    params["beats"] = BEATs(bc).state_dict()
    c = cfg.model.nb_filters[-1]
    gen = torch.Generator().manual_seed(20)
    params["encoder"]["cat_tf"] = {
        "kernel": torch.randn((c + bc.encoder_embed_dim, c), generator=gen)
        / math.sqrt(c + bc.encoder_embed_dim),
        "bias": torch.zeros(c)}
    forward = make_fast_forward(cfg, params, stats, device=dev,
                                precision="high")
    gen = torch.Generator(device=dev).manual_seed(20)
    audio = torch.randn((B_SERVE, cfg.audio.n_samples), generator=gen,
                        device=dev) * 0.1
    for _ in range(2):                                 # warm-up
        forward(audio)
    torch.cuda.synchronize()

    RA.gated_rel_attention.launches = 0
    PC.pos_conv_residual.launches = 0
    t0 = time.perf_counter()
    for _ in range(N_TIMED):
        strong, weak = forward(audio)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = RA.gated_rel_attention.launches
    pc_launches = PC.pos_conv_residual.launches
    _, _, rows = device_rows(torch, lambda: forward(audio), 2)
    rows = [r for r in rows if not r[1].startswith("bsed.")]  # spans
    kernel = [(t, n) for t, key, n in rows if "rel_attention_mma" in key]
    library = [key for _, key, _ in rows
               if any(w in key.lower() for w in ("flash", "fmha", "sdpa"))]
    with torch.inference_mode():
        fb = forward.beats.fbank(audio)
        _, _, enc_rows = device_rows(
            torch, lambda: forward.beats.encoder(fb), 2)
    pc_kernel = [(t, n) for t, key, n in enc_rows if "pos_conv_mma" in key]
    library_conv = [key for _, key, _ in enc_rows if any(
        w in key.lower() for w in ("fprop", "convolve", "cudnn"))]
    emit(phase="beats_path", preset="baseline", beats="BeatsConfig()",
         compute_dtype="bfloat16", precision="high", batch=B_SERVE,
         batches=N_TIMED, clips_per_s=B_SERVE * N_TIMED / elapsed,
         ms_per_batch=elapsed / N_TIMED * 1e3, attention_launches=launches,
         kernel_launches_per_forward=sum(n for _, n in kernel) / 2,
         kernel_device_ms_per_forward=sum(t for t, _ in kernel) / 2e3,
         pos_conv_launches=pc_launches,
         pos_conv_kernel_launches_per_forward=sum(
             n for _, n in pc_kernel) / 2,
         pos_conv_device_ms_per_forward=sum(t for t, _ in pc_kernel) / 2e3,
         library_convolution_kernels=library_conv,
         device_ms_per_forward=sum(t for t, _, _ in rows) / 2e3,
         library_attention_kernels=library, card=card,
         top=[{"name": key[:70], "ms": t / 2e3, "calls": n / 2}
              for t, key, n in rows[:8]])
    assert strong.shape == (B_SERVE, cfg.n_frames, cfg.nclass), strong.shape
    assert torch.isfinite(strong).all() and torch.isfinite(weak).all()
    assert launches == 12 * N_TIMED, launches
    assert sum(n for _, n in kernel) == 2 * 12, kernel
    assert not library, library
    assert pc_launches == N_TIMED, pc_launches
    assert sum(n for _, n in pc_kernel) == 2, pc_kernel
    assert not library_conv, library_conv
    return launches, pc_launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile-dir", default=None,
                        help="write the profile tables here")
    parser.add_argument("--only", default=None,
                        help="comma-separated phases to run alone after the "
                             "build (learning_gate, data_parallel_path, "
                             "crnn_head_path, main_path, "
                             "check_stem_epilogue_pg, group_pool_cnn_path, "
                             "check_rel_attention, pos_conv_times, "
                             "beats_path, mel_kernel_htsat); "
                             "prints their lines and the card's, not the "
                             "kernels line or the last line")
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
    if args.only:
        alone = {"learning_gate": learning_gate_phase,
                 "data_parallel_path": data_parallel_path,
                 "crnn_head_path": crnn_head_path,
                 "main_path": lambda t, d, c: main_path(
                     t, d, c, {}, args.profile_dir),
                 "check_stem_epilogue_pg": lambda t, d, c:
                     check_stem_epilogue_pg(t, d),
                 "group_pool_cnn_path": group_pool_cnn_path,
                 "check_rel_attention": lambda t, d, c:
                     check_rel_attention(t, d),
                 "pos_conv_times": lambda t, d, c: pos_conv_times(t, d),
                 "beats_path": beats_path,
                 "mel_kernel_htsat": mel_kernel_htsat}
        for phase in args.only.split(","):
            alone[phase](torch, dev, smi)
        print(smi, flush=True)
        return 0

    k1 = check_mel_kernel(torch, dev)
    k1_db = mel_kernel_htsat(torch, dev, smi)
    torch.cuda.empty_cache()
    k2 = check_stem_epilogue(torch, dev)
    launches = main_path(torch, dev, smi,
                         {k["name"]: k["ms"] for k in (k1, k2)},
                         args.profile_dir)
    path_equality(torch, dev)
    torch.cuda.empty_cache()
    eval_launches = eval_path(torch, dev, smi)
    torch.cuda.empty_cache()
    raw_launches = raw_audio_path(torch, dev, smi)
    torch.cuda.empty_cache()

    k5 = check_stem_kernel(torch, dev)
    k5["launches"] = fused_stem_path(torch, dev, smi,
                                     args.profile_dir)["stem_kernel"]
    k4 = check_gru_kernel(torch, dev)
    k4["launches"] = launches["gru_kernel"]
    bigru_forms(torch, dev, smi)
    torch.cuda.empty_cache()
    attn = check_rel_attention(torch, dev)
    torch.cuda.empty_cache()
    pconv = pos_conv_times(torch, dev)
    torch.cuda.empty_cache()
    attn["launches"], pconv["launches"] = beats_path(torch, dev, smi)
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
    torch.cuda.empty_cache()
    group_pool_cnn_path(torch, dev, smi)
    torch.cuda.empty_cache()
    preset_launches = presets_path(torch, dev, smi, args.profile_dir)
    torch.cuda.empty_cache()
    da_launches = adaptation_path(torch, dev, smi, args.profile_dir)
    torch.cuda.empty_cache()
    tag_launches = tagger_path(torch, dev, smi, args.profile_dir)
    torch.cuda.empty_cache()
    head_launches = crnn_head_path(torch, dev, smi)
    torch.cuda.empty_cache()
    gate_launches = learning_gate_phase(torch, dev, smi)
    torch.cuda.empty_cache()
    dp_launches = data_parallel_path(torch, dev, smi)

    for k in (k1, k2, k2t, k3, k2pg):  # k2 / k2pg: the main path's forms
        k["launches"] = launches[k["name"]]
    k2["launches_of_phases_are"] = (
        "every call of stem_epilogue_fwd in the phase, the group-pool "
        "form's 4 a folded eval forward (blocks 3-6) included")
    for k in (k2, k4):           # the eval path's run, 4 batches of 64
        k["launches_eval_path"] = eval_launches[k["name"]]
    for k in (k1, k2, k4):       # raw_audio_path's in-process kernel run
        k["launches_raw_audio_path"] = raw_launches[k["name"]]
    for k in (k2, k2t, k3, k4):  # run A of trainer_path: 2 epochs, 2 evals
        k["launches_trainer_path"] = fit_launches[k["name"]]
    for k in (k2, k2t, k3, k4):  # presets_path's driven runs
        k["launches_presets_path"] = preset_launches[k["name"]]
    for k in (k2, k2t, k3, k4):  # adaptation_path's driven runs
        k["launches_adaptation_path"] = da_launches[k["name"]]
    for k in (k2, k2t, k3, k4):  # tagger_path: train --pseudo-labels
        k["launches_tagger_path"] = tag_launches[k["name"]]
    for k in (k2, k4):           # learning_gate: the evaluations
        k["launches_learning_gate"] = gate_launches[k["name"]]
    for k in (k1, k2, k2t, k3, k4):  # data_parallel_path: ranks summed
        k["launches_data_parallel_path"] = dp_launches[k["name"]]
    for k in (k1, k2t, k3, k4, k5):  # crnn_head_path's driven parts
        k["launches_crnn_head_path"] = head_launches[k["name"]]
    kernels_line = [k1, k1_db, k2, k2t, k3, k5, k4, k2pg, k3pg, attn,
                    pconv]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
