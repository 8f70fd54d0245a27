"""Kernels K2 and K3: the fused folded-stem epilogue, forward and backward.

Replaces the TPU kernel ``bsed_tpu/ops/stem_epilogue.py:make_fused_epilogue``
in both of its frequency-pool forms: ``_run_fwd`` (body ``_fwd_kernel``) is
K2, ``csrc/stem_epilogue.cu``; ``_run_bwd`` (body ``_bwd_kernel``) is K3,
``csrc/stem_epilogue_bwd.cu``; the ``custom_vjp`` is ``StemEpilogueFn``.

For a conv output h (B, T, G, L=128) without bias it computes

    y = h·inv + c;  GLU z = (y@w + b)·σ(y)  or  CG z = y·σ(y@w + b);
    dropout z = bits < k ? z·256/k : 0   (train form; bits uint8, h's layout);
    time avg-pool pt ∈ {1, 2} (VALID, the odd last row dropped);
    frequency pool, one of
      folded blocks (G = 16):  z @ pool_w                → (B, T//pt, G, L/2)
      group pool pg ∈ {1, 2}:  mean of pg adjacent groups → (B, T//pt, G//pg, L)

with elementwise math in float32, matmul operands in the input dtype and
float32 accumulation, and the output in the input dtype, as the TPU kernel
does. In the serving stem inv = 1 and c is the conv bias (the eval-mode
BatchNorm is folded into the conv); in training inv = γ·rsqrt(var+ε) and
c = (bias − mean)·inv + β from the batch statistics, which autograd
differentiates around the kernels. The backward recomputes y, lin and σ
from h (the forward saves only its inputs) and returns dh and the
parameter reductions dinv = Σdy·h, dc = Σdy, dW = yᵀ·dlin (float32
operands), db = Σdlin, summed deterministically.

Bound on the H100: bytes. K2 reads h (and the bits) once and writes the
output once (~0.74 GB per batch-64 bf16 forward over blocks 0-2); K3 reads
gz, h and the bits and writes dh. Design: persistent blocks hold w in
shared memory and walk over contiguous panels of 64 rows (t, g) × 128
lanes. Each kernel has two bodies, chosen by dtype (``kernel_body``):
bfloat16 runs its 128×128 products on the tensor cores (``wgmma`` on
core-matrix tiles, A fragments formed in registers, panels staged by
``cp.async``; K3's dW keeps float32-grade operands as inv·(hᵀ·dlin) +
c·dbᵀ with h exact in bf16 and dlin split into bf16 hi and lo parts,
``split_product``; the group pool takes its pool pair through the
fragment-row map, ``pool_output_row``); float32 keeps FMA products on
unrounded operands. See the sources for the fragment layout
(``fragment_panel_row``) and the shared-memory budget
(``kernel_shared_memory``).

``pool_w`` must be the folded stem's pair-averaging matrix
(``ops/folded_stem._freq_pool_matrix(f, 2, c)``): the kernels compute that
matmul as the pair average it is. The group-pool form (``pool_w=None``,
the standard-layout blocks 3-6 with G = 16, 8, 4, 2) takes any G that
divides 64 (with 64/G a multiple of pt and G of pg); ``bsed_tpu`` builds it
but wires it into no path (``folded_stem.py:351-360``). The port serves
blocks 3-6 on its eval form (``serve.GroupPoolCNN``), with the eval-mode
BatchNorm's inv and c from the running statistics.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional

import numpy as np
import torch

from bsed_tpu_torch import kernels
from bsed_tpu_torch.ops.dropout import _u8_threshold
from bsed_tpu_torch.ops.pooling import fast_avg_pool

L = 128
LANE_G = 16          # groups of the folded blocks (the pool_w form)
PANEL_ROWS = 64      # rows (t, g) per kernel panel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"glu": 0, "cg": 1}


SMEM_LIMIT = 232_448     # bytes of shared memory a block may use (H100)
_TSB, _BSB = 272, 144    # shared-memory row strides of csrc/stem_common.cuh


def fragment_panel_row(f: int, pt: int, groups: int, pg: int = 1) -> int:
    """The panel row (tl·groups + g) held by fragment row ``f`` of the
    tensor-core bodies (``panel_row`` in ``csrc/stem_common.cuh``).
    Fragment row f = 16·mb + i is row i of the panel's m16 tile mb (warp
    mb of a warpgroup); a thread (lane) holds rows i = lane//4 and
    lane//4 + 8, pair q = 8·mb + lane//4. For pt = 2 these two are the time
    pair (2·tp, g), (2·tp + 1, g), q = tp·groups + g, so the time pool
    stays inside the thread (and with pg = 2 the pool's other pair, g ^ 1,
    is pair q ^ 1: the thread 4 lanes away); for pt = 1 and pg = 2 they are
    the group pair (tl, 2·g'), (tl, 2·g' + 1), rows 2q and 2q + 1; for
    pt = pg = 1 the map is the identity."""
    if not 0 <= f < PANEL_ROWS:
        raise ValueError(f"fragment row {f} outside the {PANEL_ROWS}-row "
                         f"panel")
    q = (f // 16) * 8 + f % 8                 # pair index, < 32
    if pt == 2:
        return (2 * (q // groups) + (f % 16) // 8) * groups + q % groups
    if pg == 2:
        return 2 * q + (f % 16) // 8
    return f


def core_matrix_offset(row: int, col: int) -> int:
    """Byte offset of element (row, col) of a 128-column bf16 tile in the
    unswizzled core-matrix layout ``wgmma`` reads (``blocked`` in
    ``csrc/stem_common.cuh``): 8 × 8 blocks of 128 contiguous bytes, column
    blocks 128 bytes apart, row blocks 2048 bytes apart."""
    return (row // 8) * 2048 + (col // 8) * 128 + (row % 8) * 16 \
        + (col % 8) * 2


def lane_pool_source(out_lane: int, pool_c: int) -> int:
    """The first of the two input lanes that the pair-averaging ``pool_w``
    of ``pool_c`` channels pools into ``out_lane``; the second is
    ``pool_c`` lanes further (``in_col`` in ``csrc/stem_epilogue.cu``)."""
    return (out_lane // pool_c) * 2 * pool_c + out_lane % pool_c


def panel_fragment_row(p: int, pt: int, groups: int, pg: int = 1) -> int:
    """The inverse of ``fragment_panel_row``: the fragment row that holds
    panel row ``p`` (``fragment_row`` in ``csrc/stem_common.cuh``). K3
    stages h in this order, so that the staged panel is the tensor-core
    operand of dW as it lies."""
    if not 0 <= p < PANEL_ROWS:
        raise ValueError(f"panel row {p} outside the {PANEL_ROWS}-row panel")
    if pt == 2:
        tl = p // groups                       # time row in the panel
        q = (tl // 2) * groups + p % groups    # pair index
        return (q // 8) * 16 + (tl % 2) * 8 + q % 8
    if pg == 2:
        return (p // 16) * 16 + (p % 2) * 8 + (p // 2) % 8
    return p


def pool_output_row(f: int, pt: int, pg: int) -> Optional[int]:
    """The row of the pooled output panel that the thread holding fragment
    row ``f`` writes in K2's bf16 group-pool body, or None if it writes
    none: each pooled row once, by the thread with the even pair index
    when the pool's two pairs sit 4 lanes apart (pt = pg = 2)."""
    q = (f // 16) * 8 + f % 8
    if pt * pg == 1:
        return f
    if f % 16 >= 8:                     # the second row of the thread's pair
        return None
    if pt * pg == 4:
        return q // 2 if q % 2 == 0 else None
    return q


def split_product(h: torch.Tensor, inv: torch.Tensor, c: torch.Tensor,
                  dlin: torch.Tensor) -> torch.Tensor:
    """dW = yᵀ·dlin for y = h·inv + c as K3's bfloat16 body computes it,
    with float32-grade operands on bf16 tensor cores: since inv and c are
    per lane, yᵀ·dlin = inv·(hᵀ·dlin) + c·dbᵀ with db = Σ dlin, and h
    (rows, L) is exact in bf16. dlin is split into hi = bf16(x) and lo =
    bf16(x − hi); hᵀ·dl + hᵀ·dh is summed in float32 and the affine part
    applied once at the end. bf16 keeps 8 significant bits, so
    |x − hi − lo| ≤ 2⁻¹⁶·|x|, and the result is within
    ``SPLIT_PRODUCT_RTOL``·(|h·inv|ᵀ·|dlin| + |c|·Σ|dlin|) of the exact
    one, the float32 accumulation's own error included."""
    if h.dtype != torch.bfloat16:
        raise ValueError("split_product takes h in bfloat16, the dtype in "
                         "which it is exact")
    hi = dlin.float().bfloat16().float()
    lo = (dlin.float() - hi).bfloat16().float()
    hf = h.float()
    hdl = hf.T @ lo + hf.T @ hi
    db = dlin.float().sum(0)
    return inv.float()[:, None] * hdl + c.float()[:, None] * db[None, :]


SPLIT_PRODUCT_RTOL = 2.0 ** -15


def kernel_body(dtype: torch.dtype, lane_form: bool = True,
                pool_c: int = 16) -> Dict[str, str]:
    """Which body of K2 and K3 serves a form: ``mma`` (bfloat16, tensor
    cores) or ``fma`` (float32; K2 also for the 4-channel lane pool, whose
    lane pairs fall inside one 8-column fragment block). Mirrors the
    dispatch in the two sources."""
    bf16 = dtype == torch.bfloat16
    return {"fwd": "mma" if bf16 and (not lane_form or pool_c >= 8)
            else "fma",
            "bwd": "mma" if bf16 else "fma"}


def kernel_shared_memory(kernel: str, dtype: torch.dtype,
                         lane_form: bool = True) -> Dict[str, int]:
    """Dynamic shared memory (bytes) of one block of ``kernel`` ('fwd' =
    K2, in its lane-pool form or, with ``lane_form=False``, its group-pool
    form; 'bwd' = K3) for ``dtype``, and the blocks per SM the source
    claims for it; mirrors the layouts in the two sources (the C entries
    ``bsed_stem_epilogue[_pg|_bwd]_smem_bytes`` report the same numbers on
    the card)."""
    stage_h, bits = PANEL_ROWS * _TSB, PANEL_ROWS * _BSB
    tile, wbytes = PANEL_ROWS * L * 2, L * L * 2
    if dtype == torch.bfloat16:
        if kernel == "bwd":     # w, dlin hi/lo, inv/c/b, 2 × (h, gz, bits)
            nbytes, blocks = wbytes + 2 * tile + 3 * L * 4 \
                + 2 * (tile + stage_h + bits), 1
        else:                   # w, inv/c/b, 2 × (h, bits), the output panel
            nbytes, blocks = wbytes + 3 * L * 4 + 2 * (stage_h + bits) \
                + (bits if lane_form else stage_h), 2
    elif kernel == "bwd":       # w (padded), y and dlin in float32
        nbytes, blocks = (L * (L + 1) + 2 * PANEL_ROWS * L) * 4, 1
    else:                       # w and round(y) in float32
        nbytes, blocks = (L * L + PANEL_ROWS * L) * 4, 2
    return {"bytes": nbytes, "blocks_per_sm": blocks}


def stem_epilogue_plain(h, inv, c, w, b, act: str, pt: int,
                        pool_w: Optional[torch.Tensor], bits=None,
                        keep_k: int = 0, pg: int = 1) -> torch.Tensor:
    """The plain PyTorch version: the unfused chain, every op in h's dtype
    (as the unfused folded stem composes it). ``bits`` (B, T·G, L) uint8
    and ``keep_k`` give the train form's dropout; ``pool_w=None`` is the
    group-pool form (``fast_avg_pool`` over (pt, pg))."""
    dt = h.dtype
    y = h * inv.to(dt) + c.to(dt)
    lin = y @ w.to(dt) + b.to(dt)
    z = lin * torch.sigmoid(y) if act == "glu" else y * torch.sigmoid(lin)
    if bits is not None:
        keep = bits.reshape(h.shape) < keep_k
        z = torch.where(keep, z * (256.0 / keep_k),
                        torch.zeros((), dtype=dt, device=h.device))
    if pool_w is None:
        return fast_avg_pool(z, (pt, pg))
    if pt > 1:
        z = fast_avg_pool(z, (pt, 1))
    return z @ pool_w.to(dt)


def stem_epilogue_bwd_plain(gz, h, inv, c, w, b, act: str, pt: int,
                            pool_w: Optional[torch.Tensor], bits=None,
                            keep_k: int = 0, pg: int = 1):
    """K3's plain version: (dh, dinv, dc, dW, db) of the plain chain for
    the cotangent ``gz``, by autograd; dW in float32."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (h, inv, c, w, b)]
        out = stem_epilogue_plain(*leaves, act, pt, pool_w, bits, keep_k,
                                  pg)
        dh, dinv, dc, dw, db = torch.autograd.grad(out, leaves, gz)
    return dh, dinv, dc, dw.float(), db


def pair_pool_channels(pool_w: np.ndarray) -> int:
    """The channels per fold copy ``c`` for which ``pool_w`` equals the
    pair-averaging matrix ``_freq_pool_matrix(L // c, 2, c)``; raises
    ValueError if it is no such matrix."""
    pool_w = np.asarray(pool_w, np.float32)
    if pool_w.shape == (L, L // 2):
        for c in (4, 8, 16, 32, 64):
            want = np.zeros((L, L // 2), np.float32)
            for r in range(L // c):
                for ch in range(c):
                    want[r * c + ch, (r // 2) * c + ch] = 0.5
            if np.array_equal(pool_w, want):
                return c
    raise ValueError("the CUDA stem epilogue supports only the folded "
                     "stem's (128, 64) pair-averaging pool_w")


def check_group_form(g: int, pt: int, pg: int, cout: int = L) -> None:
    """Raise ValueError unless the kernels take the group-pool form for G
    groups of ``cout`` channels: 128 channels, pt ∈ {1, 2}, G divides the
    64-row panel, which holds whole time pairs, and pg ∈ {1, 2} divides
    G."""
    if cout != L or pt not in (1, 2):
        raise ValueError(f"group pool needs {L} channels and pt 1/2, got "
                         f"{cout} channels, pt={pt}")
    if pg not in (1, 2):
        raise ValueError(f"group pool supports pg 1/2, got {pg}")
    if (g < 1 or PANEL_ROWS % g or (PANEL_ROWS // g) % pt or g % pg):
        raise ValueError(f"group-pool kernels need G | {PANEL_ROWS} with "
                         f"({PANEL_ROWS}/G) % pt == 0 and G % pg == 0; got "
                         f"G={g}, pt={pt}, pg={pg}")


def group_form_ok(g: int, pt: int, pg: int, cout: int = L) -> bool:
    """Whether ``check_group_form`` admits the layout."""
    try:
        check_group_form(g, pt, pg, cout)
    except ValueError:
        return False
    return True


def _out_shape(h, pt: int, lane_form: bool, pg: int):
    bsz, t_in, g = h.shape[:3]
    if lane_form:
        return (bsz, t_in // pt, g, L // 2)
    return (bsz, t_in // pt, g // pg, L)


def _check_inputs(h, inv, c, w, b, act, pt, bits, keep_k, lane_form,
                  pg) -> None:
    if h.device.type != "cuda":
        raise ValueError(f"stem epilogue kernel runs on CUDA, got {h.device}")
    if h.dtype not in _DTYPES:
        raise ValueError(f"stem epilogue kernel takes float32/bfloat16, "
                         f"got {h.dtype}")
    if h.ndim != 4 or h.shape[3] != L or not h.is_contiguous():
        raise ValueError(f"stem epilogue kernel needs a contiguous "
                         f"(B, T, G, {L}) h, got {tuple(h.shape)}")
    if lane_form and h.shape[2] != LANE_G:
        raise ValueError(f"the pool_w form needs G = {LANE_G}, got "
                         f"{h.shape[2]}")
    if not lane_form:
        check_group_form(h.shape[2], pt, pg, h.shape[3])
    if w.shape != (L, L) or w.dtype != h.dtype or not w.is_contiguous():
        raise ValueError("w must be a contiguous (128, 128) tensor in h's "
                         "dtype")
    for name, v in (("inv", inv), ("c", c), ("b", b)):
        if (v.shape != (L,) or v.dtype != torch.float32
                or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 (128,)")
    if any(t.data_ptr() % 16 for t in (h, w) if t.numel()):
        raise ValueError("h and w must be 16-byte aligned")
    if any(t.device != h.device for t in (inv, c, w, b)):
        raise ValueError("stem epilogue inputs must share h's device")
    if act not in _ACTS or pt not in (1, 2):
        raise ValueError(f"unsupported act={act} pt={pt}")
    if bits is not None:
        if (bits.dtype != torch.uint8 or bits.numel() != h.numel()
                or bits.shape[0] != h.shape[0] or not bits.is_contiguous()
                or bits.device != h.device):
            raise ValueError("bits must be contiguous uint8 (B, T·G, 128) "
                             "on h's device")
        if not 1 <= keep_k <= 255:
            raise ValueError(f"keep_k must be in 1..255, got {keep_k}")
        if bits.data_ptr() % 16:
            raise ValueError("bits must be 16-byte aligned")


def _bind_fwd(lib):
    fn = lib.bsed_stem_epilogue
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    return fn


def stem_epilogue_fwd(h, inv, c, w, b, act: str, pt: int,
                      pool_w: Optional[torch.Tensor], pool_c: int, bits=None,
                      keep_k: int = 0, pg: int = 1) -> torch.Tensor:
    """K2's wrapper: the kernel where ``kernels.launches_on`` says so, else
    the plain version (``pool_c`` from ``pair_pool_channels(pool_w)``, or
    ``pool_w=None`` and ``pg`` for the group-pool form)."""
    if not kernels.launches_on(h.device):
        return stem_epilogue_plain(h, inv, c, w, b, act, pt, pool_w, bits,
                                   keep_k, pg)
    lane_form = pool_w is not None
    _check_inputs(h, inv, c, w, b, act, pt, bits, keep_k, lane_form, pg)
    bsz, t_in, g = h.shape[:3]
    out = torch.empty(_out_shape(h, pt, lane_form, pg), device=h.device,
                      dtype=h.dtype)
    fn = _bind_fwd(kernels.load("stem_epilogue"))
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = fn(h.data_ptr(), inv.data_ptr(), c.data_ptr(), w.data_ptr(),
             b.data_ptr(), None if bits is None else bits.data_ptr(),
             keep_k if bits is not None else 0, out.data_ptr(),
             _DTYPES[h.dtype], _ACTS[act], pt, bsz, t_in, t_in // pt, g,
             pool_c if lane_form else 0, pg, stream)
    kernels.check(err, "stem epilogue kernel")
    stem_epilogue_fwd.launches += 1
    _FWD.launches_pg += not lane_form
    return out


stem_epilogue_fwd.launches = 0          # every launch, both forms
stem_epilogue_fwd.launches_pg = 0       # of which the group-pool form's
# launches_pg stays on this function object even where a profiler has put
# a wrapper in the module's place that carries only ``launches``
_FWD = stem_epilogue_fwd

_WORKSPACE: Dict[torch.device, torch.Tensor] = {}


def _workspace(lib, device: torch.device) -> torch.Tensor:
    """One (SMs, partial size) float32 buffer per device for K3's per-block
    partial sums; the kernel's grid is at most one block per SM."""
    ws = _WORKSPACE.get(device)
    if ws is None:
        size_fn = lib.bsed_stem_epilogue_bwd_partial_size
        size_fn.restype = ctypes.c_int
        size_fn.argtypes = []
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        ws = torch.empty((sms, size_fn()), device=device,
                         dtype=torch.float32)
        _WORKSPACE[device] = ws
    return ws


def _bind_bwd(lib):
    fn = lib.bsed_stem_epilogue_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    return fn


def stem_epilogue_bwd(gz, h, inv, c, w, b, act: str, pt: int,
                      pool_w: Optional[torch.Tensor], pool_c: int, bits=None,
                      keep_k: int = 0, pg: int = 1):
    """K3's wrapper: (dh in h's dtype, dinv, dc, dW, db in float32), from
    the kernel where ``kernels.launches_on`` says so, else from the plain
    version."""
    if not kernels.launches_on(h.device):
        return stem_epilogue_bwd_plain(gz, h, inv, c, w, b, act, pt, pool_w,
                                       bits, keep_k, pg)
    lane_form = pool_w is not None
    _check_inputs(h, inv, c, w, b, act, pt, bits, keep_k, lane_form, pg)
    bsz, t_in, g = h.shape[:3]
    t_out = t_in // pt
    gz = gz.contiguous()
    want = _out_shape(h, pt, lane_form, pg)
    if gz.shape != want or gz.dtype != h.dtype or gz.data_ptr() % 16:
        raise ValueError(f"gz must be {want} in h's dtype and 16-byte "
                         f"aligned, got {tuple(gz.shape)} {gz.dtype}")
    lib = kernels.load("stem_epilogue_bwd")
    fn = _bind_bwd(lib)
    ws = _workspace(lib, h.device)
    dh = torch.empty_like(h)
    # rows after the last panel (the dropped odd row when T//pt is even)
    panel_t = PANEL_ROWS // g
    covered = -(-t_out // (panel_t // pt)) * panel_t
    if covered < t_in:
        dh[:, covered:].zero_()
    f32 = dict(device=h.device, dtype=torch.float32)
    dw = torch.empty((L, L), **f32)
    dinv, dc, db = (torch.empty(L, **f32) for _ in range(3))
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = fn(gz.data_ptr(), h.data_ptr(), inv.data_ptr(), c.data_ptr(),
             w.data_ptr(), b.data_ptr(),
             None if bits is None else bits.data_ptr(),
             keep_k if bits is not None else 0, dh.data_ptr(), dw.data_ptr(),
             dinv.data_ptr(), dc.data_ptr(), db.data_ptr(), ws.data_ptr(),
             ws.shape[0], _DTYPES[h.dtype], _ACTS[act], pt, bsz, t_in, t_out,
             g, pool_c if lane_form else 0, pg, stream)
    kernels.check(err, "stem epilogue backward kernel")
    stem_epilogue_bwd.launches += 1
    return dh, dinv, dc, dw, db


stem_epilogue_bwd.launches = 0


class StemEpilogueFn(torch.autograd.Function):
    """K2 forward, K3 backward: the port of the TPU kernel's custom_vjp.
    Saves only the inputs; returns (dh, dinv, dc, dW in w's dtype, db) and
    no gradient for the bits."""

    @staticmethod
    def forward(ctx, h, inv, c, w, b, bits, act, pt, pool_w, pool_c,
                keep_k, pg=1):
        ctx.save_for_backward(h, inv, c, w, b, bits)
        ctx.cfg = (act, pt, pool_w, pool_c, keep_k, pg)
        return stem_epilogue_fwd(h, inv, c, w, b, act, pt, pool_w, pool_c,
                                 bits, keep_k, pg)

    @staticmethod
    def backward(ctx, gz):
        h, inv, c, w, b, bits = ctx.saved_tensors
        act, pt, pool_w, pool_c, keep_k, pg = ctx.cfg
        dh, dinv, dc, dw, db = stem_epilogue_bwd(
            gz.to(h.dtype), h, inv, c, w, b, act, pt, pool_w, pool_c, bits,
            keep_k, pg)
        return (dh, dinv, dc, dw.to(w.dtype), db, None, None, None, None,
                None, None, None)


def make_fused_epilogue(act: str, pt: int,
                        pool_w: Optional[torch.Tensor] = None,
                        rate: float = 0.0, pg: int = 1) -> Callable:
    """Build ``ep(h, inv, c, w, b, bits=None) -> out`` for one conv-block
    epilogue, differentiable in (h, inv, c, w, b). The frequency pool is
    ``pool_w`` (on h's device; folded blocks, output (B, T//pt, 16, 64))
    or, with ``pool_w=None``, the mean of ``pg`` adjacent groups
    (standard-layout blocks, output (B, T//pt, G//pg, 128)); the two are
    exclusive. ``rate`` > 0 is the train form: ``bits`` (B, T·G, L) uint8
    are then required, keep = bits < round(256·(1−rate)). ``ep`` is
    ``StemEpilogueFn`` (K2 and K3 as ``kernels.launches_on`` decides), but
    on a card inside ``kernels.plain_versions()`` the plain version under
    autograd."""
    if act not in _ACTS:
        raise ValueError(f"fused epilogue supports glu/cg, got {act}")
    if pt not in (1, 2):
        raise ValueError(f"fused epilogue supports time pool 1/2, got {pt}")
    if pool_w is not None and pg != 1:
        raise ValueError("pool_w (lane pooling) and pg (group pooling) are "
                         "mutually exclusive")
    if pg not in (1, 2):
        raise ValueError(f"fused epilogue supports group pool 1/2, got {pg}")
    keep_k = 0
    if rate > 0:
        keep_k = _u8_threshold(1.0 - rate)
        if keep_k is None:
            raise ValueError(f"dropout rate {rate} not on the k/256 grid")
    pool_c = 0 if pool_w is None else pair_pool_channels(pool_w.cpu().numpy())

    def ep(h, inv, c, w, b, bits: Optional[torch.Tensor] = None):
        if (bits is None) != (keep_k == 0):
            raise ValueError("bits are required exactly when rate > 0")
        if h.device.type == "cuda" and not kernels.launches_on(h.device):
            return stem_epilogue_plain(h, inv, c, w, b, act, pt, pool_w,
                                       bits, keep_k, pg)
        return StemEpilogueFn.apply(h, inv, c, w, b, bits, act, pt, pool_w,
                                    pool_c, keep_k, pg)

    return ep
