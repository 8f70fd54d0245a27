"""PyTorch/CUDA port of ``bsed_tpu`` for NVIDIA Hopper (H100).

A package of its own beside the JAX one: it imports ``torch`` and nothing of
``jax``, ``flax`` or ``bsed_tpu``. Module names mirror ``bsed_tpu``; the
hand-written CUDA kernels live in ``csrc/`` and are built and loaded by
``kernels/`` at first use. Entry points run on ``device="cuda"`` unless the
caller asks for the CPU.
"""
