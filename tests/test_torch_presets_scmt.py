"""One train step of the port against ``bsed_tpu.train.steps.
make_train_step`` on the CPU for the exp_step lineage's ISP flavours:
``scmt`` (syn-only shifted forwards, cross-stream self consistency, four
teacher shift terms), ``scmt_ada`` (mean teacher, no ISP) and
``sct_ada_weak`` (the 'sct' flavour: real freq-then-time forwards and its
computed-but-not-added terms), in the reference-parity form (float32,
unfolded, one forward per stream), and ``scmt`` in the folded fused form
(JAX's K2/K3 in interpret mode, the port's plain versions). The state's
step is 200 with 8 steps an epoch, so the exp_step cost is ~0.29.
``scmt_ada_origin``'s train configuration is ``scmt``'s. The
configuration, the replayed draws and the gates are those of
``tests/test_torch_preset_units.py``; each JAX step is built once."""
import dataclasses
import functools

import pytest

from bsed_tpu.config import get_config as j_get_config

from bsed_tpu_torch.config import AudioConfig, get_config

from tests.test_torch_preset_units import (_small, assert_step_matches,
                                           jax_step, port_step)

CASES = [("scmt", False), ("scmt_ada", False), ("sct_ada_weak", False),
         ("scmt", True)]


@functools.lru_cache(maxsize=None)
def _jax(preset, folded):
    return jax_step(preset, folded=folded, fused=folded)


@pytest.mark.parametrize("preset,folded", CASES,
                         ids=[f"{p}-{'folded_fused' if f else 'unfolded'}"
                              for p, f in CASES])
def test_preset_step_matches_jax(preset, folded):
    want = _jax(preset, folded)
    got = port_step(preset, want[0], folded=folded, fused=folded)
    assert_step_matches(want, got, _small(get_config(preset), AudioConfig,
                                          folded, folded))


@pytest.mark.parametrize("get", [get_config, j_get_config],
                         ids=["port", "jax"])
def test_scmt_ada_origin_trains_as_scmt(get):
    """Without a discriminator scmt_ada_origin is scmt: the same train
    and model configuration (they differ in DA only), so scmt's step test
    covers it."""
    a, b = get("scmt_ada_origin"), get("scmt")
    assert a.train == b.train and a.model == b.model and a.audio == b.audio
    assert a.da != b.da
    assert dataclasses.asdict(a.train)["isp_flavor"] == "scmt"
