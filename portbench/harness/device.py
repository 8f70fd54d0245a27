"""The card: its presence, its name and power limit, the numeric flags in
force, and the process's start time (set-up is counted from it)."""
from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Dict, Optional


class NoCard(RuntimeError):
    """The run needs more CUDA devices than this machine has."""


def require(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: the benchmark "
                     "runs on a card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell needs {chips} cards, the machine has "
                     f"{torch.cuda.device_count()}")


def power_limit_w() -> Optional[float]:
    """The card's power limit by ``nvidia-smi`` (None where it cannot
    say)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def info(count: int) -> Dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "power_limit_w": power_limit_w()}


def flags() -> Dict:
    import torch
    return {"matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn_benchmark": torch.backends.cudnn.benchmark,
            "cudnn_deterministic": torch.backends.cudnn.deterministic,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 on float32 matmuls and cuDNN convolutions for the block."""
    import torch
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = on
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock (Linux:
    /proc/self/stat's start time against /proc/uptime); the time of this
    call where the kernel cannot say."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        start_ticks = float(fields[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return now
