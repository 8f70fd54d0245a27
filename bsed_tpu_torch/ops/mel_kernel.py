"""Kernel K1: raw audio → mel in one CUDA kernel, in two forms.

Replaces the TPU kernel ``bsed_tpu/ops/mel_kernel.py:fused_block_mel``
(body ``_mel_kernel``) in its magnitude form. The CUDA source is
``csrc/mel_kernel.cu``.

What it computes: frame t of the centre reflect-padded signal, times the
window, goes through a real N-point DFT; then the mel over the
filterbank's bands. The form is a property of the constants
(``MelKernelBases.power_db``), each with its own envelope
(``check_geometry``):

  * magnitude (the CRNN's front end, librosa semantics as the JAX kernel):
    symmetric Hamming, |·| of the bins, the Slaney projection with
    norm=None; out the linear mel, whose per-clip dB clamp
    (``ops/mel.amplitude_to_db``) stays outside. The JAX kernel's
    envelope: N // H == 8, N % H != 0, H < 256;
  * power-dB (torchlibrosa's front end, HTS-AT's): periodic Hann, |·|² of
    the bins, the Slaney area-normalised bands, and 10·log10(max(mel,
    1e-10)) written out, no top_db clamp (elementwise, so in the
    kernel's epilogue). Any hop up to ``MAX_HOP_DB``.

Both forms take N a power of two from 128 to 2048 and n_mels ≤ 128, a
multiple of 4. The TPU kernel's block DFT suits a systolic matrix unit;
on the H100 the kernel is an FFT instead: the real N-point DFT is one
complex M-point FFT (M = N/2) of the even/odd packed frame z[n] = x[2n] +
i·x[2n+1], followed by the split step

    X[k] = (Z[k] + conj Z[M−k])/2 − i/2·W_N^k·(Z[k] − conj Z[M−k]),
    X[M] = Re Z[0] − Im Z[0],

and the mel is a banded sum over each band's nonzero bins (2016 of the
1025 × 128 parity filterbank's entries; 866 of HTS-AT's 513 × 64), not a
dense product. Only the (B, T, n_mels) mel is written to device memory.

Bound on the H100: per B=64 batch of 10 s clips, the magnitude form at N
= 2048, H = 255 ≈5.1 GFLOP (2.5·N·log₂N per frame for the real FFT, 3 per
live bin for |·|, 2 per filterbank nonzero) against 82 MB of audio in and
41 MB of mel out, so the f32 rate sets the floor (≈0.076 ms at the H100
SXM data sheet's 67 TFLOP/s, 700 W); the power-dB form at N = 1024, H =
320 ≈1.6 GFLOP against 82 MB in and 16.4 MB out (≈0.03 ms either way).
The kernel is bound by shared-memory traffic and the latency of its
butterflies: a warp owns a frame and runs a four-step FFT, M = P × Q
(1024 = 32 × 32), with both passes in registers and one padded
shared-memory transpose between them (see the source's header, also for
the two layouts the power-dB form uses where lanes would idle).

The constants are built in float64 on the host and stored as float32
(the band table as int32). The plain PyTorch version
(``fused_block_mel_plain``) is the kernel's decomposition: frames, window,
even/odd packing, an M-point complex FFT, the split step, |·| or |·|²,
the banded sum by gather and, in the power-dB form, the dB; the wrapper
takes it where ``kernels.launches_on`` says not to launch (CPU tensors).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from bsed_tpu_torch import kernels
from bsed_tpu_torch.ops.mel import frame_signal, num_frames, power_to_db
from bsed_tpu_torch.utils.device import resolve_device

MAX_MELS = 128
MAX_WINDOW = 4096
MAX_HOP_DB = 512     # the power-dB form's tile (csrc/mel_kernel.cu)
_DB_WINDOWS = (128, 256, 512, 1024, 2048)   # the source's FFT sizes
_J = 8               # N // H, the JAX kernel's envelope
_BLOCKS_PER_SM = 2   # the persistent grid (csrc/mel_kernel.cu)


class MelKernelBases(NamedTuple):
    """The kernel's constants on one device, and the form they serve."""
    window: torch.Tensor   # (N,) float32: symmetric Hamming (magnitude),
    #                        periodic Hann (torchlibrosa's power-dB)
    twiddle: torch.Tensor  # (N, 2) float32: W_N^q, q < N/2; then W_M^{j·k1}
    #                        at N/2 + k1·Q + j (the four-step twiddles)
    bands: torch.Tensor    # (n_mels, 3) int32: start bin, length, offset
    weights: torch.Tensor  # (nnz,) float32, the bands' filterbank values
    power_db: bool = False  # out: dB of the power mel, else the |·| mel


def check_geometry(n_window: int, hop_size: int, n_mels: int,
                   power_db: bool = False) -> None:
    """Raise ValueError unless the kernel's form (magnitude, or
    ``power_db``) supports this audio geometry."""
    if power_db:
        if n_window not in _DB_WINDOWS:
            raise ValueError("mel kernel's FFT needs n_window a power of "
                             f"two from {_DB_WINDOWS[0]} to "
                             f"{_DB_WINDOWS[-1]}")
        if not 1 <= hop_size <= MAX_HOP_DB:
            raise ValueError("mel kernel's power-dB form takes hop_size "
                             f"from 1 to {MAX_HOP_DB} (its shared-memory "
                             "tile)")
    else:
        if n_window // hop_size != _J:
            raise ValueError("mel kernel is specialized to N//H == 8")
        if n_window % hop_size == 0:
            raise ValueError(
                "mel kernel needs a non-empty tail block (n_window % "
                "hop_size != 0); use the dense front end for "
                "exact-multiple hops")
        if hop_size >= 256:
            raise ValueError("mel kernel keeps the JAX kernel's envelope: "
                             "hop_size must be < 256")
    if n_mels > MAX_MELS or n_mels % 4:
        raise ValueError(f"mel kernel needs n_mels <= {MAX_MELS} and a "
                         "multiple of 4")
    if n_window & (n_window - 1) or n_window > MAX_WINDOW:
        raise ValueError("mel kernel's FFT needs n_window a power of two "
                         f"<= {MAX_WINDOW}")


def supports(n_window: int, hop_size: int, n_mels: int,
             power_db: bool = False) -> bool:
    try:
        check_geometry(n_window, hop_size, n_mels, power_db)
    except ValueError:
        return False
    return True


def fft_split(n_window: int) -> Tuple[int, int]:
    """(P, Q) of the four-step FFT of M = n_window / 2 = P·Q points, P ≥ Q:
    a lane's first pass is P points, its second Q."""
    m = n_window // 2
    p = 1 << (m.bit_length() // 2)         # m = 2^L: P = 2^ceil(L/2)
    return p, m // p


def band_table(mel_fb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The filterbank (bins, n_mels) as bands: (n_mels, 3) int32 rows of
    (first nonzero bin, length through the last nonzero, offset into the
    weights) and the float32 weights of every band, band after band."""
    rows, weights, off = [], [], 0
    for col in mel_fb.T:
        nz = np.nonzero(col)[0]
        if nz.size == 0:
            rows.append((0, 0, off))
            continue
        start, length = int(nz[0]), int(nz[-1] - nz[0] + 1)
        rows.append((start, length, off))
        weights.append(col[start:start + length])
        off += length
    w = np.concatenate(weights) if weights else np.zeros(0)
    return np.asarray(rows, np.int32), w.astype(np.float32)


def build_mel_kernel_bases(n_window: int, hop_size: int, mel_fb: np.ndarray,
                           device="cuda", *,
                           window: Optional[np.ndarray] = None,
                           power_db: bool = False) -> MelKernelBases:
    """The kernel's constants for one front end: the filterbank (1 + N/2,
    n_mels) as its band table, the window (``window``, by default the
    symmetric Hamming) and the twiddles from float64; ``power_db`` picks
    the form."""
    check_geometry(n_window, hop_size, mel_fb.shape[1], power_db)
    if mel_fb.shape[0] != n_window // 2 + 1:
        raise ValueError(f"filterbank has {mel_fb.shape[0]} bins, the FFT "
                         f"{n_window // 2 + 1}")
    if window is None:
        window = np.hamming(n_window)
    device = resolve_device(device)
    m = n_window // 2
    p, q = fft_split(n_window)
    k1, j = np.meshgrid(np.arange(p), np.arange(q), indexing="ij")
    ang = np.concatenate([2 * np.pi * np.arange(m) / n_window,
                          (2 * np.pi * k1 * j / m).ravel()])
    twiddle = np.stack([np.cos(ang), -np.sin(ang)], axis=1)
    bands, weights = band_table(mel_fb)
    as_t = lambda a: torch.as_tensor(a, device=device).contiguous()  # noqa
    return MelKernelBases(
        window=as_t(np.asarray(window).astype(np.float32)),
        twiddle=as_t(twiddle.astype(np.float32)),
        bands=as_t(bands), weights=as_t(weights), power_db=bool(power_db))


def fused_block_mel_plain(audio: torch.Tensor, bases: MelKernelBases,
                          n_window: int, hop_size: int,
                          n_mels: int) -> torch.Tensor:
    """The plain PyTorch version of K1 on the same constants: frames,
    window, even/odd packing, M-point FFT, split step, |·| (or |·|²),
    banded sum (and, in the power-dB form, its dB)."""
    m = n_window // 2
    frames = frame_signal(audio.float(), n_window, hop_size) * bases.window
    z = torch.fft.fft(torch.complex(frames[..., 0::2], frames[..., 1::2]))
    zc = torch.roll(z.flip(-1), 1, dims=-1).conj()       # conj Z[(M−k) % M]
    w = torch.complex(bases.twiddle[:m, 0], bases.twiddle[:m, 1])
    x = 0.5 * (z + zc) - 0.5j * w * (z - zc)
    nyquist = z[..., :1].real - z[..., :1].imag
    if bases.power_db:
        spec = torch.cat([x.real * x.real + x.imag * x.imag,
                          nyquist * nyquist], dim=-1)     # (..., T, M + 1)
    else:
        spec = torch.cat([x.abs(), nyquist.abs()], dim=-1)
    # each nonzero's bin and band, from the band table
    start, length, offset = bases.bands.long().unbind(1)
    band = torch.repeat_interleave(
        torch.arange(n_mels, device=spec.device), length)
    bins = start[band] + torch.arange(band.numel(), device=spec.device) \
        - offset[band]
    prod = spec[..., bins] * bases.weights
    out = spec.new_zeros(spec.shape[:-1] + (n_mels,))
    out = out.index_add_(-1, band, prod)
    if bases.power_db:
        out = power_to_db(out, top_db=None)
    return out


def _bind(lib):
    fn = lib.bsed_mel_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    return fn


def fused_block_mel(audio: torch.Tensor, bases: MelKernelBases,
                    n_window: int, hop_size: int,
                    n_mels: int) -> torch.Tensor:
    """(..., n_samples) → (..., T, n_mels): the linear magnitude mel, or
    with ``bases.power_db`` the unclamped dB of the power mel; kernel K1
    (csrc/mel_kernel.cu) where ``kernels.launches_on`` says so, else the
    plain version. ``fused_block_mel.launches`` counts the launches of
    both forms, ``launches_db`` the power-dB form's."""
    if not kernels.launches_on(audio.device):
        return fused_block_mel_plain(audio, bases, n_window, hop_size,
                                     n_mels)
    if audio.device.type != "cuda":
        raise ValueError(f"mel kernel runs on CUDA, got {audio.device}")
    check_geometry(n_window, hop_size, n_mels, bases.power_db)
    dtypes = {"bands": torch.int32}
    for name in ("window", "twiddle", "bands", "weights"):
        c, want = getattr(bases, name), dtypes.get(name, torch.float32)
        if c.device != audio.device or c.dtype != want \
                or not c.is_contiguous():
            raise ValueError(f"mel kernel constant {name} must be a "
                             f"contiguous {want} tensor on {audio.device}")
    if (bases.window.shape != (n_window,)
            or bases.twiddle.shape != (n_window, 2)
            or bases.bands.shape != (n_mels, 3)):
        raise ValueError("mel kernel constants do not match the geometry")
    n_samples = audio.shape[-1]
    if n_samples <= n_window // 2:
        raise ValueError("mel kernel's reflect pad needs more than "
                         f"{n_window // 2} samples, got {n_samples}")
    lead = tuple(audio.shape[:-1])
    x = audio.float().reshape(-1, n_samples).contiguous()
    t = num_frames(n_samples, hop_size)
    out = torch.empty((x.shape[0], t, n_mels), device=audio.device,
                      dtype=torch.float32)
    sms = torch.cuda.get_device_properties(audio.device).multi_processor_count
    fn = _bind(kernels.load("mel_kernel"))
    stream = torch.cuda.current_stream(audio.device).cuda_stream
    err = fn(x.data_ptr(), bases.window.data_ptr(), bases.twiddle.data_ptr(),
             bases.bands.data_ptr(), bases.weights.data_ptr(), out.data_ptr(),
             x.shape[0], n_samples, t, n_window, hop_size, n_mels,
             int(bases.power_db), _BLOCKS_PER_SM * sms, stream)
    kernels.check(err, "mel kernel")
    fused_block_mel.launches += 1
    if bases.power_db:
        # getattr: a wrapper standing in the entry's place (the benchmark's
        # spans) carries ``launches`` alone
        fused_block_mel.launches_db = getattr(
            fused_block_mel, "launches_db", 0) + 1
    return out.reshape(lead + (t, n_mels))


fused_block_mel.launches = 0
fused_block_mel.launches_db = 0
