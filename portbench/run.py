"""The benchmark of the PyTorch and CUDA port (``bsed_tpu_torch``).

Run one cell on the card, from the root of a checkout:

    python portbench/run.py --workload serve_crnn_b64 --seed 7 \\
        --seconds 10 --trace 0

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled stretch of the window. The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number compared with its limit); the checks are
also the last lines of standard error. Without a CUDA card, or with fewer
cards than the cell asks for, the run exits with code 3 and prints no
result. ``BENCHMARK.json`` names the cells; ``portbench/README.md`` says
how one is added.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _caches() -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds
    its CUDA libraries into ``bsed_tpu_torch/kernels/_build/`` itself)."""
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    _caches()
    from portbench.harness import guard
    guard.install()
    from portbench.harness import device as D
    t_start = D.process_start()

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench.harness import cell
    try:
        result = cell.execute(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=t_start)
    except D.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 3
    return cell.emit(result)


if __name__ == "__main__":
    sys.exit(main())
