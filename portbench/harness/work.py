"""The yardstick: published peaks of the card, the work of each kernel's
function counted from the shapes of its call, and model FLOPs counted from
a configuration's shapes.

The peaks, ``bound`` and the per-kernel operation and byte counts are
copied from ``chip_smoke.py`` (``bound``, ``check_mel_kernel``,
``check_stem_epilogue``, ``check_stem_epilogue_train``,
``check_gru_kernel``). Each count is the work of the algorithm at the
call's shapes: input bytes read once, output bytes written once, and the
operations of the function, whatever kernel computes it.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np

# NVIDIA H100 SXM data sheet: dense rates without sparsity, at 700 W
H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}

Work = Tuple[float, Dict[str, float]]       # (bytes, {precision: operations})


def bound_s(bytes_moved: float, ops: Mapping[str, float]) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak of their type."""
    t_bytes = bytes_moved / H100_BYTES_PER_S
    t_ops = sum(v / H100_FLOPS[k] for k, v in ops.items())
    return max(t_bytes, t_ops)


def _n(shape) -> int:
    return int(np.prod(shape))


def _it(dtype: str) -> int:
    return 2 if dtype in ("bfloat16", "float16") else 4


# --- kernels: the work of one call ----------------------------------------

def mel_filterbank_support(fb: np.ndarray) -> Tuple[int, int]:
    """(live bins, nonzeros) of a (bins, mels) filterbank: the bins up to
    the highest one any filter uses, and the filters' nonzero weights."""
    nz = np.nonzero(fb)
    return int(nz[0].max()) + 1, int(len(nz[0]))


def k1_mel(audio_shape, out_shape, n_window: int, live: int,
           nnz: int) -> Work:
    """Audio → linear mel: a real FFT a frame (2.5·N·log2 N), |·| over the
    live bins (3 FLOP each), the mel over the filterbank's nonzeros (2
    FLOP each); float32 audio in, float32 mel out."""
    frames = _n(out_shape[:-1])
    flops = frames * (2.5 * n_window * math.log2(n_window) + 3 * live
                      + 2 * nnz)
    return (_n(audio_shape) + _n(out_shape)) * 4.0, {"float32": flops}


def k2_stem(h_shape, out_shape, w_shape, dtype: str,
            train: bool) -> Work:
    """One folded block's epilogue, bias → GLU → (dropout) → pools: one
    (rows, L) × (L, L) product in the compute dtype and the elementwise
    chain in float32; h (and the train form's uint8 bits) read, the
    pooled output written."""
    rows = _n(h_shape[:-1])
    lanes = h_shape[-1]
    n = rows * lanes
    mm = rows * lanes * lanes * 2
    it = _it(dtype)
    if train:
        nbytes = n * it + n + _n(out_shape) * it + _n(w_shape) * it + 3 * 512
        return nbytes, {dtype: mm, "float32": n * 10}
    nbytes = (n + _n(out_shape) + _n(w_shape)) * it + 3 * 512
    return nbytes, {dtype: mm, "float32": n * 8 + _n(out_shape) * 3}


def k3_stem_bwd(gz_shape, h_shape, w_shape, dtype: str) -> Work:
    """The epilogue's backward: gz, h and the bits read, dh written, the
    parameter gradients; the products at the tensor-core rate with dW as
    two bf16 passes (``chip_smoke.check_stem_epilogue_train``'s count)."""
    lanes = h_shape[-1]
    n = _n(h_shape)
    mm = n * lanes * 2
    it = _it(dtype)
    nbytes = (_n(gz_shape) * it + n * it + n + n * it + _n(w_shape) * it
              + lanes * lanes * 4 + 7 * 512)
    return nbytes, {dtype: 4 * mm, "float32": n * 20}


def k4_gru(xp2_shape, out_shape, w_shape, b_shape, dtype: str) -> Work:
    """Both directions' GRU recurrences over T steps: the (H, 3H) hidden
    product a step and direction, 16 FLOP of gates an element; the
    projections read and the states written."""
    _, bsz, t, g3 = xp2_shape
    hid = g3 // 3
    mm = 2 * bsz * t * hid * g3 * 2
    ew = 2 * bsz * t * hid * 16
    it = _it(dtype)
    nbytes = (_n(xp2_shape) + _n(out_shape) + _n(w_shape)) * it \
        + _n(b_shape) * 4
    ops = ({"float32": mm + ew} if dtype == "float32"
           else {dtype: mm, "float32": ew})
    return nbytes, ops


# --- model FLOPs ----------------------------------------------------------

def n_frames(audio: Mapping) -> int:
    """STFT frames of a clip: 1 + samples // hop (1255 at 32 kHz, 10 s,
    hop 255), the linear mel's frames in training too."""
    return 1 + int(audio["sr"] * audio["max_len_seconds"]) // audio["hop_size"]


def _conv_stack(model: Mapping, t: int, f: int) -> Tuple[float, int, int]:
    """(FLOPs, frames, bins) of the conv blocks on a (t, f) map: each 3×3
    conv and each GLU / context-gating product, 2 FLOP a multiply-add."""
    flops, cin = 0.0, model["n_in_channel"]
    k = model["kernel_size"]
    for cout, (pt, pf) in zip(model["nb_filters"], model["pooling"]):
        flops += 2.0 * k * k * cin * cout * t * f
        if model["activation"] in ("glu", "cg"):
            flops += 2.0 * cout * cout * t * f
        t, f, cin = t // pt, f // pf, cout
    return flops, t, f


def _bigru(model: Mapping, t: int, n_in: int) -> float:
    hid = model["n_rnn_cell"]
    flops = 0.0
    for _ in range(model["n_layers_rnn"]):
        flops += 2 * (2.0 * t * n_in * 3 * hid + 2.0 * t * hid * 3 * hid)
        n_in = 2 * hid
    return flops


def forward_flops(config: Mapping, with_mel: bool) -> Dict[str, float]:
    """FLOPs of one clip's forward by part (``mel``, ``cnn``, ``rnn``,
    ``head``), from the configuration file's shapes."""
    a, m = config["audio"], config["model"]
    frames = n_frames(a)
    out = {}
    if with_mel:
        from portbench.reference.frontend import mel_filterbank
        live, nnz = mel_filterbank_support(mel_filterbank(a))
        out["mel"] = k1_mel((a["n_window"],), (frames, a["n_mels"]),
                            a["n_window"], live, nnz)[1]["float32"]
    cnn, t, _ = _conv_stack(m, frames, a["n_mels"])
    c = m["nb_filters"][-1]
    hid2 = 2 * m["n_rnn_cell"]
    rnn = _bigru(m, t, c)
    head = 0.0
    if m["use_fpn"]:
        k = m["kernel_size"]
        t2, t4 = t // 2, t // 4
        for tt in (t, t2):            # block_down, applied twice
            cnn += 2.0 * k * k * c * c * tt + 2.0 * c * c * tt
        rnn += _bigru(m, t2, c) + _bigru(m, t4, c)
        head += 2.0 * t2 * t4 * hid2 + 2.0 * t * t2 * hid2   # upsampling
        head += 2.0 * (t2 + t) * 2 * hid2 * hid2            # fuse_2, fuse_4
    head += 2 * 2.0 * t * hid2 * m["nclass"]             # two dense heads
    out.update(cnn=cnn, rnn=rnn, head=head)
    return out


def train_step_flops(config: Mapping, teacher_clips: int,
                     student_clips: int) -> float:
    """FLOPs of a train step: the teacher's forwards, and the student's
    forwards with their backwards at twice a forward's FLOPs, less the
    input gradient of the first conv, which no step needs; no recompute.
    The input is the linear mel, so no mel front end."""
    fwd = forward_flops(config, with_mel=False)
    per_clip = sum(fwd.values())
    m, a = config["model"], config["audio"]
    frames = n_frames(a)
    first = 2.0 * m["kernel_size"] ** 2 * m["n_in_channel"] \
        * m["nb_filters"][0] * frames * a["n_mels"]
    return teacher_clips * per_clip + student_clips * (3 * per_clip - first)

