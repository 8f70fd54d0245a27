"""Kernel K1: raw audio → linear mel in one CUDA kernel.

Replaces the TPU kernel ``bsed_tpu/ops/mel_kernel.py:fused_block_mel``
(body ``_mel_kernel``). The CUDA source is ``csrc/mel_kernel.cu``.

What it computes (see ``ops/mel.block_dft_bases``): the padded signal is
cut into non-overlapping H-sample hop blocks; each block goes once through
the three complex stage-1 bases of the Hamming rank-3 split
w[jH+r] = Σ_p u_p[j]·v_p[r]; frame t is recombined from blocks t..t+7 by
the k-dependent 8-tap coefficients d_re/d_im, plus the transform of the
8-sample tail (the head of block t+8); then |·| and the Slaney projection
over the filterbank's live bins. Only the (B, T, n_mels) mel is written:
the (B, M, 6, bins) stage-1 tensor never leaves the chip.

Bound on the H100: operations. Per 10 s clip the stage-1 transform is
~4.0 GFLOP, the mel projection ~0.33 and the recombination ~0.16, against
1.28 MB of audio in and 0.64 MB of mel out. The kernel computes in float32
FMA (no tensor cores yet), so its floor is the card's f32 rate. Design:
one block owns 56 frames of one clip and loops over 32-bin chunks of the
live spectrum; per chunk it runs the stage-1 product for the 64 hop blocks
the 56 frames touch through shared-memory tiles (4×2×6 register tile per
thread), recombines the taps from shared memory, takes the magnitude and
accumulates the 128 mels in registers. The basis streams through shared
memory 16 rows at a time; nothing but the mel goes back to device memory.

The constants are built in float64 on the host and stored as float32.
The plain PyTorch version (``fused_block_mel_plain``) is
``_padded_signal`` → ``block_stft_magnitude`` → the mel matmul on the very
same constants; the wrapper takes it only for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from bsed_tpu_torch.ops.mel import (_padded_signal, block_dft_bases,
                                    block_stft_magnitude)
from bsed_tpu_torch.utils.device import resolve_device

TILE_T = 56          # output frames per thread block (csrc/mel_kernel.cu)
BIN_CHUNK = 32       # live bins per chunk; the bin count is padded to it
MAX_MELS = 128
_J = 8               # full-block taps (N // H)


class MelKernelBases(NamedTuple):
    """The kernel's constants, float32 on one device. ``bins`` is the
    filterbank's live support rounded up to BIN_CHUNK (1024 for the
    parity config); rows and bins past the real ones are zero."""
    e: torch.Tensor      # (256, 3, 2, bins) stage-1 basis v_p[r]·e^{-2πirk/N}
    d_re: torch.Tensor   # (8, 3, 2, bins)   recombination → Re X
    d_im: torch.Tensor   # (8, 3, 2, bins)   recombination → Im X
    e_tail: torch.Tensor  # (rem, 2, bins) w[8H+r]·e^{-2πi(8H+r)k/N}
    fb: torch.Tensor     # (bins, n_mels)    Slaney filterbank rows


def live_bins(mel_fb: np.ndarray) -> int:
    """Bins the filterbank reads: one past its last nonzero row. For the
    parity config (N=2048, f_max=Nyquist) the Slaney triangles end before
    the Nyquist bin, so 1024 of the 1025 bins are live."""
    used = np.nonzero(np.abs(mel_fb).sum(axis=1))[0]
    return int(used[-1]) + 1 if used.size else mel_fb.shape[0]


def check_geometry(n_window: int, hop_size: int, n_mels: int) -> None:
    """Raise ValueError unless the kernel supports this audio geometry."""
    if n_window // hop_size != _J:
        raise ValueError("mel kernel is specialized to N//H == 8")
    if n_window % hop_size == 0:
        raise ValueError(
            "mel kernel needs a non-empty tail block (n_window % hop_size "
            "!= 0); use the dense front end for exact-multiple hops")
    if hop_size >= 256:
        raise ValueError("mel kernel holds a hop block in 256 basis rows; "
                         "hop_size must be < 256")
    if n_mels > MAX_MELS or n_mels % 4:
        raise ValueError(f"mel kernel needs n_mels <= {MAX_MELS} and a "
                         "multiple of 4")


def supports(n_window: int, hop_size: int, n_mels: int) -> bool:
    try:
        check_geometry(n_window, hop_size, n_mels)
    except ValueError:
        return False
    return True


def build_mel_kernel_bases(n_window: int, hop_size: int, mel_fb: np.ndarray,
                           device="cuda") -> MelKernelBases:
    """Build the kernel's constants in float64 over the live bins and pack
    them at the kernel's padded layouts. The rank-3 coefficients u_p[j]
    enter through d_re/d_im (``block_dft_bases``): the kernel uses the
    k-dependent tap form, so it needs no separate phase-twist planes."""
    check_geometry(n_window, hop_size, mel_fb.shape[1])
    device = resolve_device(device)
    nf = live_bins(mel_fb)
    bins = -(-nf // BIN_CHUNK) * BIN_CHUNK
    e_basis, d_re, d_im, e_tail = block_dft_bases(
        n_window, hop_size, dtype=np.float64, n_bins=nf)

    def pad(a, rows=None):
        widths = [(0, 0)] * a.ndim
        widths[-1] = (0, bins - nf)
        if rows is not None:
            widths[0] = (0, rows - a.shape[0])
        return torch.as_tensor(np.pad(a, widths).astype(np.float32),
                               device=device).contiguous()

    fb = np.zeros((bins, mel_fb.shape[1]))
    fb[:nf] = mel_fb[:nf]
    return MelKernelBases(
        e=pad(e_basis, rows=256), d_re=pad(d_re), d_im=pad(d_im),
        e_tail=pad(e_tail),
        fb=torch.as_tensor(fb.astype(np.float32), device=device).contiguous())


def fused_block_mel_plain(audio: torch.Tensor, bases: MelKernelBases,
                          n_window: int, hop_size: int,
                          n_mels: int) -> torch.Tensor:
    """The plain PyTorch version of K1 on the same constants:
    ``_padded_signal`` → ``block_stft_magnitude`` → mel matmul."""
    mag = block_stft_magnitude(
        audio, (bases.e, bases.d_re, bases.d_im, bases.e_tail),
        n_window, hop_size)
    return mag @ bases.fb[:, :n_mels]


def _bind(lib):
    fn = lib.bsed_mel_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    return fn


def fused_block_mel(audio: torch.Tensor, bases: MelKernelBases,
                    n_window: int, hop_size: int,
                    n_mels: int) -> torch.Tensor:
    """(..., n_samples) → (..., T, n_mels) linear mel. CPU tensors take the
    plain version; CUDA tensors launch kernel K1 (csrc/mel_kernel.cu)."""
    if audio.device.type == "cpu":
        return fused_block_mel_plain(audio, bases, n_window, hop_size,
                                     n_mels)
    if audio.device.type != "cuda":
        raise ValueError(f"mel kernel runs on CUDA, got {audio.device}")
    check_geometry(n_window, hop_size, n_mels)
    for name, c in bases._asdict().items():
        if (c.device != audio.device or c.dtype != torch.float32
                or not c.is_contiguous()):
            raise ValueError(f"mel kernel constant {name} must be a "
                             f"contiguous float32 tensor on {audio.device}")
    bins = bases.fb.shape[0]
    if (bases.e.shape != (256, 3, 2, bins) or bases.fb.shape[1] != n_mels
            or bins % BIN_CHUNK):
        raise ValueError("mel kernel constants do not match the geometry")
    rem = n_window - _J * hop_size

    p, t, lead = _padded_signal(audio.float(), n_window, hop_size)
    b = p.shape[0]
    n_tiles = -(-t // TILE_T)
    # every hop block a tile reads, plus one block of slack for the
    # 256-row basis reading past a 255-sample hop
    sig_len = (n_tiles * TILE_T + _J + 1) * hop_size + 256
    p = F.pad(p, (0, sig_len - p.shape[1])).contiguous()
    out = torch.empty((b, t, n_mels), device=audio.device,
                      dtype=torch.float32)
    from bsed_tpu_torch import kernels
    fn = _bind(kernels.load("mel_kernel"))
    stream = torch.cuda.current_stream(audio.device).cuda_stream
    err = fn(p.data_ptr(), bases.e.data_ptr(), bases.d_re.data_ptr(),
             bases.d_im.data_ptr(), bases.e_tail.data_ptr(),
             bases.fb.data_ptr(), out.data_ptr(),
             b, sig_len, t, n_tiles, bins, n_mels, hop_size, rem, stream)
    kernels.check(err, "mel kernel")
    fused_block_mel.launches += 1
    return out.reshape(lead + (t, n_mels))


fused_block_mel.launches = 0
