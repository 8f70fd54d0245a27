"""One train step of each adaptation-stage run with a joint domain loss
against ``bsed_tpu.train.steps.make_train_step`` on the CPU (steps.py
1079-1110: the domain loss on the main forwards' features × adv_weight,
one backward stepping the model's optimizer and the discriminator's):

  * c ``scmt_ada_weak_separate``: clip CDAN, whose loss is
    ``cdan_frame_loss`` on the full (B, T, 2H) encoding through
    ``ClipDiscriminator`` (five stride-2 convs: 13 s clips, 65 frames),
    SGD;
  * d ``pseudo_labeling -stage adaptation``: frame CDAN on the randomized
    map (JAX's R_f / R_g injected) with entropy weights,
    ``FrameDiscriminatorGRL(n_out=1, apply_grl=False)``, SGD aux;
  * e ``sct_ada_weak -stage adaptation``: DANN on the flattened encoding,
    the 'sct' ISP flavour, SGD aux.

Configuration, replayed draws and gates: ``tests/test_torch_da_units.py``;
each JAX step is built once."""
import functools

import pytest
import torch

from tests.test_torch_da_units import check_run, jax_da_step
from tests.test_torch_train_step import _leaves

RUNS = ("c", "d", "e")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax(run, folded, step):
    return jax_da_step(run, folded, step)


@pytest.mark.parametrize("run", RUNS)
def test_joint_run_matches_jax(run):
    want, got = check_run(run, _jax)
    # one backward stepped the model's and the discriminator's optimizers;
    # the encoder's aux optimizer is built (JAX's enc_opt_state) and idle
    slot = "trace" if "trace" in want[1]["enc_opt_state"] else "mu"
    for _, v in _leaves(got[0]["enc_opt_state"][slot]):
        assert not v.any()
