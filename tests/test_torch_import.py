"""The port stands alone: bsed_tpu_torch and chip_smoke.py import no jax,
flax or bsed_tpu (the JAX package), and no pandas (the machine with the
card has none), checked by importing every module with those blocked and
by scanning every import statement; importing them pulls in none of
tensorboard, matplotlib and scikit-learn (optional, and absent on that
machine)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "bsed_tpu", "pandas")


def _port_sources():
    return sorted((ROOT / "bsed_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'flax', 'bsed_tpu', 'pandas'):\n"
        "    sys.modules[name] = None\n"
        "import bsed_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    bsed_tpu_torch.__path__, 'bsed_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "importlib.import_module('chip_smoke')\n"
        "for m in ('train.steps', 'data.pipeline', 'eval.test_model',\n"
        "          'eval.psds', 'ops.median', 'utils.torch_compat',\n"
        "          'train.trainer', 'utils.checkpoint', 'utils.meters',\n"
        "          'utils.profiling', 'eval.features', 'cli',\n"
        "          'train.ramps', 'train.losses', 'train.state',\n"
        "          'ops.augment', 'utils.weights', 'models.layers',\n"
        "          'models.cnn', 'models.crnn', 'serve', 'ops.grl',\n"
        "          'models.discriminators', 'train.da', 'predict',\n"
        "          'utils.audio', 'data.preprocess', 'data.synthesizer',\n"
        "          'data.analysis', 'eval.visualize', 'models.resnet',\n"
        "          'train.tagging_trainer', 'parallel.mesh',\n"
        "          'parallel.launch', 'entry'):\n"
        "    assert 'bsed_tpu_torch.' + m in mods, m\n"
        "for m in ('torch.utils.tensorboard', 'tensorboard', 'matplotlib',\n"
        "          'sklearn'):\n"
        "    assert m not in sys.modules, m + ' imported at module import'\n"
        "print(len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 60


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.name}:{node.lineno} imports {name}")
