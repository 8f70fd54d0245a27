"""The one direct comparison of the port's data-parallel step with
``bsed_tpu``'s: ``baseline_mt_isp`` on a 2-device virtual mesh
(``tests/test_parallel.py``'s sharded step: batch sharded, state
replicated) against the port's step on 2 gloo ranks
(``parallel.launch.spawn``), from the same initial trees on the same
global batch with the same replayed ISP shifts, at the one-step preset
gates (``tests/test_torch_preset_units.assert_step_matches``).

The configuration is the one-step tests' (``_small``: AudioConfig(sr=3200,
hop_size=160, max_len_seconds=2.0) with 16 mel bins and four narrow
blocks, float32, dropout 0, no teacher noise, ``rnn_unroll=1``), JAX's
``create_train_state`` jitted and its step under
``jax.default_matmul_precision("float32")``. Every other data-parallel
test holds the port's n ranks against the port's 1 rank
(``tests/test_torch_parallel*.py``); this file is apart so that
``--dist loadfile`` runs its JAX compile beside them.
"""
import jax
import jax.numpy as jnp
import numpy as np

import bsed_tpu.train.steps as j_steps
from bsed_tpu.config import AudioConfig as JAudioConfig
from bsed_tpu.config import get_config as j_get_config
from bsed_tpu.parallel.mesh import make_mesh, replicate, shard_batch

from bsed_tpu_torch.config import AudioConfig, get_config
from bsed_tpu_torch.parallel.launch import spawn
from bsed_tpu_torch.utils import weights

from tests.test_torch_parallel import (SPAWN_TIMEOUT,  # noqa: F401
                                       one_torch_thread, replayed_step)
from tests.test_torch_preset_units import (EPOCH, STEPS_PER_EPOCH, _batch,
                                           _shifts, _small,
                                           assert_step_matches)


def test_two_ranks_match_bsed_tpu_sharded_step(monkeypatch):
    preset = "baseline_mt_isp"
    j_cfg = _small(j_get_config(preset), JAudioConfig)
    cfg = _small(get_config(preset), AudioConfig)
    batch = _batch(cfg)
    shifts = _shifts(batch["syn"].shape[0])

    modules = j_steps.build_modules(j_cfg)
    state = jax.jit(lambda k: j_steps.create_train_state(
        j_cfg, modules, k))(jax.random.key(3))
    before = weights.trees_from_jax_state(state)
    monkeypatch.setattr(j_steps, "sample_isp_shifts", lambda *a, **k: tuple(
        jnp.asarray(s, jnp.int32) for s in shifts))
    mesh = make_mesh(jax.devices()[:2])
    with jax.default_matmul_precision("float32"):
        step = j_steps.make_train_step(modules,
                                       steps_per_epoch=STEPS_PER_EPOCH)
        new, metrics = step(replicate(mesh, state),
                            shard_batch(mesh, {k: jnp.asarray(v)
                                               for k, v in batch.items()}),
                            jax.random.key(1),
                            jnp.asarray(EPOCH, jnp.float32))
        after = weights.trees_from_jax_state(new)
    jax_result = (before, after, {k: float(v) for k, v in metrics.items()},
                  0)
    ranks = spawn(replayed_step, 2, timeout=SPAWN_TIMEOUT,
                  args=(cfg, before, batch, shifts, EPOCH, STEPS_PER_EPOCH))
    for port_result in ranks:
        assert_step_matches(jax_result, port_result, cfg)
    np.testing.assert_array_equal(ranks[0][1]["loss"], ranks[1][1]["loss"])
