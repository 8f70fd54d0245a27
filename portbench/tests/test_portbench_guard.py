"""The import guard and ``run.py``'s refusal to run without a card."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.harness import guard
from portbench.tests.tiny_cells import ROOT


@pytest.mark.parametrize("name,blocked", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax", True),
    ("flax.linen", True), ("bsed_tpu", True), ("bsed_tpu.ops.mel", True),
    ("pandas", True), ("bsed_tpu_torch", False), ("bsed_tpu_torch.ops", False),
    ("jaxtyping", False), ("pandasx", False), ("numpy", False)])
def test_finder_compares_whole_top_level_names(name, blocked):
    finder = guard._Blocker(guard.BLOCKED)
    spec = finder.find_spec(name)
    assert (spec is not None) == blocked
    if blocked:
        assert spec.origin is None
        with pytest.raises(guard.BlockedImport):
            spec.loader.create_module(spec)


def test_loaded_compares_whole_top_level_names():
    assert guard.loaded(["bsed_tpu_torch", "bsed_tpu_torch.ops", "numpy",
                         "jaxtyping"]) == []
    assert guard.loaded(["bsed_tpu.ops", "jax._src", "flax"]) == [
        "bsed_tpu", "flax", "jax"]


_RUN_TINY = r"""
import json, sys
sys.path.insert(0, {root!r})
from portbench.harness import guard
guard.install()
for name in ("jax", "flax", "bsed_tpu", "pandas"):
    try:
        __import__(name)
        print("IMPORTED", name)
    except ImportError:
        pass
from portbench.tests.tiny_cells import run
for w in ("serve_crnn_b64", "predict_crnn_wav", "train_crnn_mtisp_perf",
          "train_fpn_mtisp_ref"):
    assert run(w)["correct"], w
print(json.dumps(sorted({{n.partition(".")[0] for n in sys.modules}})))
"""


def test_a_run_loads_no_jax_flax_jax_package_or_pandas():
    """Every cell, run through the harness in a fresh interpreter, leaves
    no module with a blocked top-level name in ``sys.modules``."""
    out = subprocess.run(
        [sys.executable, "-c", _RUN_TINY.format(root=ROOT)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "IMPORTED" not in out.stdout
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "bsed_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "bsed_tpu", "pandas"}


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "serve_crnn_b64",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_run_py_exits_nonzero_without_a_card():
    out = _run_py(ROOT)
    assert out.returncode == 3, out.stderr[-2000:]
    assert out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


def test_run_py_exits_nonzero_with_the_benchmark_alone(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's paths
    has no program to measure: ``run.py`` prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        paths = json.load(fh)["paths"]
    for p in paths:
        shutil.copytree(os.path.join(ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
