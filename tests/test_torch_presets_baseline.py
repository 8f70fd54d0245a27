"""One train step of the port against ``bsed_tpu.train.steps.
make_train_step`` on the CPU for the presets of the main_baseline lineage
and its supervised and weak-label relatives, in the reference-parity form
(float32, unfolded encoder, one forward per stream): ``baseline`` (no
teacher, no ISP), ``baseline_mt``, ``baseline_ena`` (supervised on the
real stream), ``pseudo_labeling`` (real weak BCE on the labelled half),
``scmt_ada_weak`` (SGD) and ``baseline_mt_isp`` unfolded. The
configuration, the replayed draws and the gates are those of
``tests/test_torch_preset_units.py``; each JAX step is built once."""
import functools

import pytest

from bsed_tpu_torch.config import AudioConfig, get_config

from tests.test_torch_preset_units import (_small, assert_step_matches,
                                           jax_step, port_step)

CASES = ("baseline", "baseline_mt", "baseline_ena", "pseudo_labeling",
         "scmt_ada_weak", "baseline_mt_isp")


@functools.lru_cache(maxsize=None)
def _jax(preset):
    return jax_step(preset)


@pytest.mark.parametrize("preset", CASES)
def test_preset_step_matches_jax(preset):
    want = _jax(preset)
    got = port_step(preset, want[0])
    assert_step_matches(want, got, _small(get_config(preset), AudioConfig))
