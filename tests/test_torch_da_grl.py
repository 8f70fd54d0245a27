"""One train step of each adaptation-stage run that updates through a GRL
pre-step against ``bsed_tpu.train.steps.make_train_step`` on the CPU
(``grl_pre_step``, steps.py:474-514: one backward through the reversed
domain loss steps the encoder's aux optimizer and the discriminator's,
then the main step):

  * a ``baseline_adaptation``: frame-CDAN, ``FrameDiscriminator`` per
    frame, MT + ISP 'baseline', Adam aux; also in the folded fused form
    (JAX's K2/K3 in interpret mode, the port's plain versions);
  * b ``scmt_ada_weak_separate_2crnn``: the same loss, the ``mlp`` head
    (Predictor2), SGD;
  * f ``scmt_ada -stage adaptation``: DANN on the flattened (B, T·2H)
    encoding, ``FrameDiscriminatorGRL(n_out=1)``.

Configuration, replayed draws and gates: ``tests/test_torch_da_units.py``
(state step 200, λ ≈ 0.0997); each JAX step is built once."""
import functools

import pytest
import torch

from tests.test_torch_da_units import check_run, jax_da_step

CASES = [("a", False), ("b", False), ("f", False), ("a", True)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax(run, folded, step):
    return jax_da_step(run, folded, step)


@pytest.mark.parametrize("run,folded", CASES,
                         ids=[f"{r}-{'folded_fused' if f else 'unfolded'}"
                              for r, f in CASES])
def test_grl_pre_step_run_matches_jax(run, folded):
    want, got = check_run(run, _jax, folded)
    # the pre-step stepped both aux optimizers once
    assert want[1]["disc_opt_state"].keys() == got[0]["disc_opt_state"].keys()
