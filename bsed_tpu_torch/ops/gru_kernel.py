"""Kernel K4: the bidirectional GRU recurrence of one layer in one CUDA
kernel.

Replaces the TPU kernel ``bsed_tpu/ops/gru_kernel.py:gru_bidir_recurrence``
(body ``_gru_kernel``). The CUDA source is ``csrc/gru_kernel.cu``.

Contract (as the JAX kernel's): xp2 (2, B, T, 3H) holds the input
projections plus b_ih of both directions, direction 1 already flipped in
time; w_hh2 (2, 3H, H); b_hh2 (2, 3H). Per step, in torch's gate order and
linear-before-reset form,

    hp = round_dt(h) @ round_dt(W_hhᵀ) + b_hh     (float32 accumulation)
    r = σ(xr + hr),  z = σ(xz + hz),  n = tanh(xn + r·hn)
    h = (1 − z)·n + z·h                           (carried in float32)

and the output (2, B, T, H) is h rounded to xp2's dtype, direction 1 still
flipped. In float32 this is ``models/rnn.gru_scan_bidir``; in bfloat16 it
is not, because the scan carries h in bfloat16.

Bound on the H100: the products, 2·B·T·H·3H·2 FLOP per layer (3.9 GFLOP at
B=64, T=313) against ~82 MB of traffic in float32, but the real floor is
the chain of T dependent steps: each needs the previous h, so what counts
is one step's latency. Design: a cluster of 2 thread blocks serves one
(direction, group of RB batch rows) for all T steps. Each block owns 64
hidden units and their r, z, n columns of W_hhᵀ, held in registers for the
whole run (24,576 weights a block), so no step re-reads the weights. Per
step a block starts the product on its own half of h while the peer's
half arrives, applies the gates to its units and writes the new h into
both blocks through distributed shared memory; each block waits only on
its own mbarrier, which the peer's writers arrive on (h is
double-buffered; no cluster-wide barrier inside the loop).
``cluster_shape`` picks RB
so that both directions' 2·⌈B/RB⌉ clusters run in one wave; the card's
count of resident clusters comes from ``cudaOccupancyMaxActiveClusters``
(66 clusters of 2 on an NVIDIA H100 80GB HBM3, 700 W).

The plain PyTorch version (``recurrence_plain``) repeats the kernel's
arithmetic step by step; the wrapper takes it where
``kernels.launches_on`` says not to launch (CPU tensors). A
caller that runs the same weights on every call lays them out once
(``prepare_weights``: W_hhᵀ in the compute dtype, b_hh in float32) and
calls ``recurrence`` / ``recurrence_plain`` on them; the public contract
``gru_bidir_recurrence(xp2, w_hh2, b_hh2)`` does that layout per call.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from bsed_tpu_torch import kernels

H = 128
CLUSTER = 2            # thread blocks per cluster (csrc/gru_kernel.cu)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROWS = (1, 2, 4, 8)   # batch rows per cluster (csrc/gru_kernel.cu)


class RecurrenceWeights(NamedTuple):
    """W_hh and b_hh of both directions in the layout K4 reads: ``w_t2``
    (2, H, 3H) = W_hhᵀ rounded to the compute dtype, ``b2`` (2, 3H)
    float32, both contiguous. Made once per layer where a caller runs the
    same weights many times (``models/rnn.HoistedBiGRU``)."""
    w_t2: torch.Tensor
    b2: torch.Tensor


def prepare_weights(w_hh2: torch.Tensor, b_hh2: torch.Tensor,
                    dtype: torch.dtype) -> RecurrenceWeights:
    """(2, 3H, H) W_hh and (2, 3H) b_hh → K4's layout for ``dtype``."""
    if (w_hh2.ndim != 3 or w_hh2.shape[0] != 2
            or w_hh2.shape[1] != 3 * w_hh2.shape[2]
            or b_hh2.shape != (2, w_hh2.shape[1])):
        raise ValueError(f"GRU recurrence weights must be (2, 3H, H) and "
                         f"(2, 3H); got {tuple(w_hh2.shape)}, "
                         f"{tuple(b_hh2.shape)}")
    return RecurrenceWeights(w_hh2.transpose(1, 2).to(dtype).contiguous(),
                             b_hh2.float().contiguous())


def recurrence_plain(xp2: torch.Tensor,
                     weights: RecurrenceWeights) -> torch.Tensor:
    """K4's plain version: the kernel's numerics (operands rounded to xp2's
    dtype, float32 accumulation, gates and carried state) as a loop over
    time."""
    dt = xp2.dtype
    w_t2 = weights.w_t2.to(dt).float()                   # (2, H, 3H)
    b2 = weights.b2[:, None, :]
    h = torch.zeros(xp2.shape[:2] + (w_t2.shape[1],), device=xp2.device)
    ys = []
    for t in range(xp2.shape[2]):
        hp = torch.bmm(h.to(dt).float(), w_t2) + b2
        xr, xz, xn = xp2[:, :, t].float().chunk(3, dim=-1)
        hr, hz, hn = hp.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        ys.append(h.to(dt))
    return torch.stack(ys, dim=2)


def gru_bidir_recurrence_plain(xp2: torch.Tensor, w_hh2: torch.Tensor,
                               b_hh2: torch.Tensor) -> torch.Tensor:
    """``recurrence_plain`` on the weights as the public contract takes
    them."""
    return recurrence_plain(xp2, prepare_weights(w_hh2, b_hh2, xp2.dtype))


_FN = []


def _bound():
    """The C entry of K4, bound once."""
    if not _FN:
        fn = kernels.load("gru_kernel").bsed_gru_bidir
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        _FN.append(fn)
    return _FN[0]


def cluster_shape(batch: int, sms: int,
                  clusters: Optional[int] = None) -> Tuple[int, int]:
    """(RB, C): batch rows per cluster and blocks per cluster. RB is the
    fewest rows whose 2·⌈B/RB⌉ clusters (both directions) run at once;
    ``clusters`` is how many the card runs at once (one block per SM:
    ``sms // C`` unless the caller knows better), at most 8 rows."""
    if clusters is None:
        clusters = sms // CLUSTER
    for rows in _ROWS:
        if 2 * -(-batch // rows) <= clusters:
            return rows, CLUSTER
    return _ROWS[-1], CLUSTER


def _attribute(dtype: torch.dtype, rows: int, which: int) -> int:
    fn = kernels.load("gru_kernel").bsed_gru_attribute
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3
    n = fn(_DTYPES[dtype], rows, which)
    kernels.check(min(n, 0), "GRU kernel attributes")
    return n


def registers_per_thread(dtype: torch.dtype, rows: int) -> int:
    """Registers per thread of K4's instantiation for (dtype, RB), as the
    CUDA runtime reports them (builds the library if needed)."""
    return _attribute(dtype, rows, 0)


_resident: Dict[int, int] = {}
_sms: Dict[int, int] = {}


def resident_clusters(device: torch.device) -> int:
    """How many of K4's clusters the card runs at once
    (``cudaOccupancyMaxActiveClusters``; the same for every RB: one block
    per SM)."""
    index = torch.device(device).index or 0
    if index not in _resident:
        with torch.cuda.device(index):
            _resident[index] = _attribute(torch.float32, 1, 1)
    return _resident[index]


def _multiprocessors(device: torch.device) -> int:
    index = device.index or 0
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sms[index]


def gru_bidir_recurrence(xp2: torch.Tensor, w_hh2: torch.Tensor,
                         b_hh2: torch.Tensor) -> torch.Tensor:
    """(2, B, T, 3H) projections → (2, B, T, H) in xp2's dtype (see the
    module docstring): kernel K4 (float32 or bfloat16, H = 128) where
    ``kernels.launches_on`` says so, else the plain version."""
    return recurrence(xp2, prepare_weights(w_hh2, b_hh2, xp2.dtype))


def recurrence(xp2: torch.Tensor, weights: RecurrenceWeights) -> torch.Tensor:
    """``gru_bidir_recurrence`` on weights already in K4's layout
    (``prepare_weights``): the wrapper that launches the kernel. Its
    launches count on ``gru_bidir_recurrence.launches``."""
    if not kernels.launches_on(xp2.device):
        return recurrence_plain(xp2, weights)
    if xp2.device.type != "cuda":
        raise ValueError(f"GRU kernel runs on CUDA, got {xp2.device}")
    if xp2.dtype not in _DTYPES:
        raise ValueError(f"GRU kernel takes float32/bfloat16, got "
                         f"{xp2.dtype}")
    w_t2, b2 = weights
    if (xp2.ndim != 4 or xp2.shape[0] != 2 or xp2.shape[3] != 3 * H
            or w_t2.shape != (2, H, 3 * H) or b2.shape != (2, 3 * H)):
        raise ValueError(f"GRU kernel is specialised to H={H}: xp2 (2, B, "
                         f"T, {3 * H}), W_hhᵀ (2, {H}, {3 * H}), b_hh "
                         f"(2, {3 * H}); got {tuple(xp2.shape)}, "
                         f"{tuple(w_t2.shape)}, {tuple(b2.shape)}")
    if (w_t2.dtype != xp2.dtype or b2.dtype != torch.float32
            or not (w_t2.is_contiguous() and b2.is_contiguous())):
        raise ValueError("GRU kernel weights must be contiguous, W_hhᵀ in "
                         "xp2's dtype and b_hh float32 (prepare_weights)")
    if w_t2.device != xp2.device or b2.device != xp2.device:
        raise ValueError("GRU kernel inputs must share xp2's device")
    _, bsz, t, _ = xp2.shape
    xp2 = xp2.contiguous()
    out = torch.empty((2, bsz, t, H), device=xp2.device, dtype=xp2.dtype)
    rows, cluster = cluster_shape(bsz, _multiprocessors(xp2.device),
                                  resident_clusters(xp2.device))
    stream = torch.cuda.current_stream(xp2.device).cuda_stream
    err = _bound()(xp2.data_ptr(), w_t2.data_ptr(), b2.data_ptr(),
                   out.data_ptr(), _DTYPES[xp2.dtype], bsz, t, rows,
                   cluster, H, stream)
    kernels.check(err, "GRU kernel")
    gru_bidir_recurrence.launches += 1
    return out


gru_bidir_recurrence.launches = 0
