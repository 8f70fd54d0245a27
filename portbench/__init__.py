"""The benchmark of the PyTorch and CUDA port (``bsed_tpu_torch``); see
``portbench/README.md``."""
