"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The library lands in ``bsed_tpu_torch/kernels/_build/`` (git-ignored),
named by a hash of the source, the shared headers ``csrc/*.cuh`` and the
flags, at first use, with ptxas' report beside it (``<name>-<hash>.ptxas``,
``ptxas_report``). Only the
sources in the checkout are compiled. Nothing here runs at import time:
the CPU tests import every module of the package on a host without
``nvcc`` or a card.

Each kernel entry (``ops/mel_kernel.fused_block_mel``,
``ops/stem_epilogue.stem_epilogue_fwd`` / ``stem_epilogue_bwd``,
``ops/gru_kernel.recurrence``, ``ops/stem_kernel.fused_stem_block``,
``ops/rel_attention.gated_rel_attention``,
``ops/pos_conv.pos_conv_residual``) asks ``launches_on`` on every
call whether to launch its kernel or run its plain PyTorch version: CUDA
tensors launch, CPU tensors take the plain version. ``plain_versions()``
makes CUDA tensors take the plain versions too, for the length of a
block, so a test can hold the kernel path against the plain path on the
same card.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("mel_kernel", "stem_epilogue", "stem_epilogue_bwd", "stem_kernel",
           "gru_kernel", "rel_attention", "pos_conv")

_loaded: Dict[str, ctypes.CDLL] = {}
_plain_blocks = 0     # open plain_versions() blocks


def launches_on(device) -> bool:
    """Whether a kernel entry launches its kernel for tensors on the
    ``torch.device`` ``device``: on a CUDA device outside every
    ``plain_versions()`` block. Otherwise the entry runs its plain
    version. Raises for a device that is neither CUDA nor the CPU."""
    if device.type == "cuda":
        return not _plain_blocks
    if device.type == "cpu":
        return False
    raise ValueError(f"the port's kernels and their plain versions run on "
                     f"CUDA or the CPU, got {device}")


@contextlib.contextmanager
def plain_versions():
    """Run the kernels' plain versions on CUDA tensors too inside the
    block; restored on exit, also when the block raises."""
    global _plain_blocks
    _plain_blocks += 1
    try:
        yield
    finally:
        _plain_blocks -= 1


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a host with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the source, the
    shared headers and the flags."""
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(SRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one source unless its library exists; returns the
    process (or None) and the library path."""
    out = library_path(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), out


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no current library, all nvcc
    processes started together. Returns ``{name: ptxas report}`` for the
    sources built now; raises with nvcc's output if one fails."""
    started = {n: _start_build(n) for n in names}
    reports = {}
    try:
        for name, (job, out) in started.items():
            if job is None:
                continue
            proc, tmp = job
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
            os.replace(tmp, out)
            out.with_suffix(".ptxas").write_text(log)
            reports[name] = log
    finally:
        for job, _ in started.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    return reports


def ptxas_report(name: str):
    """The ptxas report kept beside the current library of
    ``csrc/<name>.cu`` by whichever process built it, or None."""
    path = library_path(name).with_suffix(".ptxas")
    return path.read_text() if path.exists() else None


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel's C entry returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
