"""One train step of each ADDA run against
``bsed_tpu.train.steps.make_train_step`` on the CPU (``adda_steps``,
steps.py:516-593: the discriminator on detached real then syn features,
then the encoder's confusion step, every ``update_step`` steps; the
half-batch draws ``sample_adda_choice`` replayed on both sides):

  * g ``scmt -stage adaptation``: clip level, ``ClipDiscriminatorSoftmax``
    (13 s clips, 65 frames), all-target labels, confusion on a fresh half
    of the real stream, ``update_step`` 2 — at state step 200 (update)
    and 201 (skip: only the main step runs, domain_loss 0);
  * h ``origin -stage adaptation``: frame level, split labels, confusion
    on the whole combined real batch through the discriminator's own
    GRL (``FrameDiscriminatorGRL(n_out=2, apply_grl=True)``), origin's
    masked batch, normalisation and mixup; the choice is drawn over the
    combined batch (8 rows) and indexes the 4-row syn stream clamped, as
    JAX's gather does; also in the folded fused form (JAX's K2/K3 in
    interpret mode);
  * i ``scmt_ada_origin -stage adaptation``: the syn stream's confusion
    against flipped labels, ``update_step`` 1.

Configuration, replayed draws and gates: ``tests/test_torch_da_units.py``;
each JAX step is built once."""
import functools

import pytest
import torch

from tests.test_torch_da_units import DA_STEP, check_run, jax_da_step

CASES = [("g", False, DA_STEP), ("g", False, DA_STEP + 1),
         ("h", False, DA_STEP), ("h", True, DA_STEP), ("i", False, DA_STEP)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax(run, folded, step):
    return jax_da_step(run, folded, step)


@pytest.mark.parametrize(
    "run,folded,step", CASES,
    ids=[f"{r}-{'folded_fused' if f else 'unfolded'}-step{s}"
         for r, f, s in CASES])
def test_adda_run_matches_jax(run, folded, step):
    want, got = check_run(run, _jax, folded, step)
    before, after, metrics = want[0], want[1], want[2]
    if step % 2 and run == "g":
        # the skip branch: no ADDA draw (JAX traces both branches of its
        # lax.cond, so it drew two), discriminator and aux optimizer
        # untouched, domain_loss 0
        assert got[3] == 0 and want[4] == 2
        assert metrics["domain_loss"] == float(got[1]["domain_loss"]) == 0.0
        assert after["disc_opt_state"]["count"] == 0
    else:
        assert want[4] == (2 if run == "g" else 1)
        assert after["disc_opt_state"]["count"] == \
            after["enc_opt_state"]["count"] == 1
