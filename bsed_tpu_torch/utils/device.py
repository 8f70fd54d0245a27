"""Device selection and float32 precision for the port's entry points."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it asks for CUDA and no CUDA
    device is present (the port never falls back to the CPU quietly)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is present; "
                           "pass device='cpu' to run on the CPU")
    return dev


# TF32 for float32 matmuls and cuDNN convolutions, by precision tier:
# 'highest' and 'high' compute in full float32 (as bsed_tpu's 'highest'
# and its 3-pass 'high' do), 'fast' lets the card round to TF32 (as
# bsed_tpu's single-pass bf16 'fast' trades accuracy for speed)
TF32_BY_PRECISION = {"highest": False, "high": False, "fast": True}


@contextlib.contextmanager
def float32_precision(precision: str = "highest"):
    """For the ``with`` block, set TF32 on float32 matmuls and cuDNN
    convolutions as ``precision`` asks (``TF32_BY_PRECISION``); the earlier
    settings come back at its end. The settings matter only to work on
    the card."""
    tf32 = TF32_BY_PRECISION[precision]
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = tf32
    try:
        yield {"matmul_tf32": matmul.allow_tf32, "cudnn_tf32": cudnn.allow_tf32}
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
