"""Data parallelism of the port on the CPU: 2 gloo ranks spawned through
``bsed_tpu_torch.parallel.launch.spawn`` against 1 rank.

The gate is ``bsed_tpu``'s (``tests/test_parallel.py``): the n-rank step
on the ranks' shards equals the 1-rank step on the assembled global batch
(the shards concatenated in rank order), metrics and updated state, at
rtol 1e-5, dropout and draws included; a ``Trainer`` epoch under a group
equals the 1-rank epoch row for row at rtol 1e-4 / atol 1e-6. The 1-rank
side is the port's own, which ``tests/test_torch_presets_*.py`` hold
against ``bsed_tpu``; the one direct comparison with ``bsed_tpu``'s sharded
step is ``tests/test_torch_parallel_jax.py``.

This file holds the one-step cases and the helpers;
``tests/test_torch_parallel_trainer.py`` the Trainer, the mesh rule, the
loaders, sharded serving and ``spawn`` itself. Neither imports JAX, so
the spawned ranks (which import the file to find their function) start in
about a second. Every spawn has a time limit: a hung rendezvous fails the
test in seconds.
"""
import dataclasses

import numpy as np
import pytest
import torch

from bsed_tpu_torch.config import AudioConfig, get_config
from bsed_tpu_torch.parallel import mesh
from bsed_tpu_torch.parallel.launch import spawn
from bsed_tpu_torch.train import steps
from bsed_tpu_torch.utils import weights

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread here and in the spawned ranks (they take the
    parent's count): with torch's default pool, six xdist workers and
    their ranks oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WORLD = 2
BS = 8                      # the global batch of every stream
SPAWN_TIMEOUT = 120.0
NARROW = dict(nb_filters=(16, 32, 64, 32),
              pooling=((2, 2), (2, 2), (1, 2), (1, 2)), n_rnn_cell=32)


def small_cfg(preset, dropout=0.0, stage="pretrain", model=None):
    """``preset`` at 2 s clips of 16 mel bins and four narrow blocks
    (``model``: model fields set last); a clip discriminator's five
    stride-2 VALID convs need ≥ 63 frames, so its runs take 13 s clips
    (``tests/test_torch_preset_units.run_cfg``)."""
    cfg = get_config(preset)
    clip_disc = (stage == "adaptation" and cfg.da.level == "clip"
                 and cfg.da.mode in ("cdan", "adda"))
    cfg = cfg.replace(audio=AudioConfig(
        sr=3200, hop_size=160, max_len_seconds=13.0 if clip_disc else 2.0,
        n_mels=16))
    return cfg.replace(
        model=dataclasses.replace(cfg.model, dropout=dropout,
                                  **{**NARROW, **(model or {})}),
        train=dataclasses.replace(cfg.train, batch_size=BS, stage=stage),
        da=dataclasses.replace(cfg.da, disc_dropout=dropout))


def global_batch(cfg, seed=5):
    """A global batch: BS syn rows, and a real stream of BS rows (origin:
    its combined batch of 2·BS, ¼ weak, ½ unlabelled, ¼ strong)."""
    rng = np.random.default_rng(seed)
    t_in, f = cfg.audio.max_frames, cfg.audio.n_mels
    nr = 2 * BS if cfg.train.isp_flavor == "origin" else BS

    def strong(n):
        return (rng.random((n, cfg.n_frames, cfg.nclass)) > 0.9).astype(
            np.float32)
    out = {"syn": np.abs(rng.standard_normal((BS, t_in, f))).astype(
               np.float32),
           "syn_strong": strong(BS),
           "real": np.abs(rng.standard_normal((nr, t_in, f))).astype(
               np.float32),
           "real_strong": strong(nr)}
    out["real_weak"] = np.maximum(
        out["real_strong"].max(axis=1),
        (rng.random((nr, cfg.nclass)) > 0.7)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def one_step(cfg, group=None, epoch=30.0, state_step=0):
    """(state trees after, metrics) of one step from the seed-0 state on
    the global batch, or, under ``group``, on this rank's shard."""
    modules = steps.build_modules(cfg, device="cpu", group=group)
    state = steps.create_train_state(cfg, modules, 0)
    state.step = state_step
    batch = global_batch(cfg)
    if group is not None:
        batch = mesh.shard_batch(group, batch)
    metrics = steps.make_train_step(modules, steps_per_epoch=4)(
        state, batch, 1, epoch)
    return (weights.export_train_state(state),
            {k: float(v) for k, v in metrics.items()})


def _step_worker(group, cfg, kw):
    return one_step(cfg, group, **kw)


def _leaves(tree, prefix=""):
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float64)}


# The gates of the state after a step. The two sides differ by the order
# of their sums (a rank's partial sums, then the group's), and that is the
# whole gap: a 1-rank step run with 1 and with 6 torch threads differs from
# itself by the same order (scmt_ada_weak, measured on the CPU: gradient
# gaps up to 6.5e-5 of a leaf's largest element either way).
#  * Leaves whose exact gradient is 0 carry only that noise: the bias of a
#    conv that feeds a BatchNorm, and the attention head's softmax bias
#    (its softmax over time drops a constant). Their moments are not held;
#    their params are held within 2.2·lr, since Adam's first step of a
#    noise gradient is ±lr·g/(|g| + ε) of whatever sign the noise has.
#  * Other Adam elements with |g| < G_NOISE are held the same way (as
#    tests/test_torch_da_units.py holds the DA steps against bsed_tpu's).
#  * Optimizer moments (the gradients) within 1e-4 of their leaf's
#    largest element; everything else at rtol 1e-5, atol 1e-7.
#  * A step whose Adam aux update (the GRL pre-step, ADDA's) runs before
#    the main forwards, at ``aux_lr``, as tests/test_torch_da_units.py
#    holds such steps against bsed_tpu's: the encoder's elements that the
#    aux update stepped on a noise gradient are held within 2.2·aux_lr
#    more, and every BatchNorm running mean within 2.2·aux_lr more (the
#    noise-stepped conv bias before it moves the batch mean one to one),
#    the discriminator's params at atol 1e-5 (its first Adam step turns
#    a gradient's float noise near |g| ~ 1e-6 into a few 1e-6), and the
#    moments within AUX_MOMENT_GATE of their leaf's largest element: the
#    ADDA discriminator's first conv sees features far from zero mean,
#    and its gradient through the BatchNorm after it moves by 3.1e-3 of
#    the leaf's largest element when one rank sums the BatchNorm
#    statistics over two halves of the batch, as two ranks do (scmt at an
#    update step, on the CPU; that discriminator's loss and gradient in
#    float64 on two ranks equal one rank's to 1e-13).
#    A 1-rank step run with 1 and with 6 torch threads needs the same
#    allowances (scmt, scmt_ada, origin at an update step, on the CPU:
#    running-mean gaps up to 9.9e-4 at lr 5e-4 either way).
G_NOISE = 1e-6
MOMENT_GATE = 1e-4
AUX_MOMENT_GATE = 5e-3


def _structural_zero(path):
    return (path.endswith("/bias") and ("/conv" in path or "conv_" in path)
            or path.endswith("dense_softmax/bias"))


def _grad_path(path):
    """The Adam first-moment leaf that holds ``path``'s gradient (× 0.1),
    or None."""
    parts = path.split("/", 2)
    if len(parts) < 3:
        return None
    head, rest = parts[1:]
    if head in ("params", "ema_params"):
        return "/mu/" + rest
    if head == "disc_params":
        return "/disc_opt_state/mu/" + rest
    return None


def _is_moment(path):
    return any(f"/{m}/" in path + "/" for m in ("mu", "nu", "trace"))


def _aux_noise(path, r, shape):
    """Where the aux update stepped ``path``'s elements on a noise
    gradient (its Adam first moment under ``enc_opt_state``)."""
    prefix = "/params/encoder/"
    aux = "/enc_opt_state/mu/" + path[len(prefix):]
    if not path.startswith(prefix) or aux not in r:
        return np.zeros(shape, bool)
    return np.abs(r[aux] / 0.1) < G_NOISE


def assert_same_step(got, ref, lr_max, rtol=1e-5, atol=1e-7, aux_lr=0.0):
    """Every metric at rtol 1e-5, and every leaf of the state after the
    step at the gates above (``aux_lr``: the aux update's, when one ran
    before the main forwards)."""
    (g_trees, g_m), (r_trees, r_m) = got, ref
    assert g_m.keys() == r_m.keys()
    for k in r_m:
        np.testing.assert_allclose(g_m[k], r_m[k], rtol=rtol, atol=atol,
                                   err_msg=k)
    g, r = _leaves(g_trees), _leaves(r_trees)
    assert g.keys() == r.keys()
    for k in r:
        if r[k].size == 0:
            continue
        gap = np.abs(g[k] - r[k])
        if _is_moment(k):
            gate = AUX_MOMENT_GATE if aux_lr else MOMENT_GATE
            if not _structural_zero(k):
                assert gap.max() <= gate * np.abs(r[k]).max() + atol, \
                    (k, gap.max(), np.abs(r[k]).max())
            continue
        gp = _grad_path(k)
        noise = np.zeros(r[k].shape, bool)
        if _structural_zero(k) and k.split("/")[1] != "batch_stats":
            noise[...] = True
        elif gp in r:
            noise = np.abs(r[gp] / 0.1) < G_NOISE
        bound = np.where(noise, 2.2 * lr_max, 0.0)
        if aux_lr:
            aux = _aux_noise(k, r, r[k].shape)
            bound = bound + np.where(aux, 2.2 * aux_lr, 0.0)
            noise = noise | aux
            if "batch_stats/" in k and k.endswith("/mean"):
                noise[...] = True
                bound = np.maximum(bound, atol + rtol * np.abs(r[k])) \
                    + 2.2 * aux_lr
        np.testing.assert_allclose(
            g[k][~noise], r[k][~noise], rtol=rtol, err_msg=k,
            atol=1e-5 if aux_lr and k.startswith("/disc_params/") else atol)
        assert np.all(gap[noise] <= bound[noise]), (
            k, (gap - bound)[noise].max())


# case: (small_cfg's arguments, the step's, whether an Adam aux update
# runs before the main forwards: the gates' aux allowance above). The
# adaptation cases hold each DA flavour: clip CDAN in the joint backward
# (scmt_ada_weak), DANN in the GRL pre-step (scmt_ada) and in the joint
# backward with the ISP stream (sct_ada_weak), ADDA at a step that runs
# its update (scmt: half-batch choices of global row numbers; origin: the
# whole real stream, the choice drawn over the combined real batch and so
# past the syn stream's rows), frame CDAN through the randomized map with
# entropy weights normalised over the global batch (pseudo_labeling).
ADAPT = dict(stage="adaptation")
STEP_CASES = {
    "baseline": (dict(preset="baseline"), {}, False),
    "baseline_mt_isp": (dict(preset="baseline_mt_isp", dropout=0.5), {},
                        False),
    "origin": (dict(preset="origin", dropout=0.5), {}, False),
    "scmt_ada_weak": (dict(preset="scmt_ada_weak", **ADAPT),
                      dict(state_step=200), False),
    "scmt_ada_grl_dann": (dict(preset="scmt_ada", **ADAPT),
                          dict(state_step=200), True),
    "sct_ada_weak_joint_dann": (dict(preset="sct_ada_weak", **ADAPT), {},
                                False),
    "scmt_adda": (dict(preset="scmt", **ADAPT), dict(state_step=200), True),
    "origin_adda": (dict(preset="origin", **ADAPT), dict(state_step=200),
                    True),
    "pseudo_labeling_cdan": (dict(preset="pseudo_labeling", **ADAPT), {},
                             False),
    # the 'crnn' head (at n_rnn_cell 128: its pools divide the width by
    # 256) with its convs dropping out: its BatchNorm takes the global
    # batch's statistics, its masks the global batch's draw
    "crnn_head": (dict(preset="baseline_mt_isp", dropout=0.5,
                       model=dict(predictor_head="crnn", n_rnn_cell=128)),
                  {}, False),
    # recurrent dropout alone: the GRUs' inter-layer masks are the global
    # batch's draw
    "recurrent_dropout": (dict(preset="baseline_mt_isp",
                               model=dict(dropout_recurrent=0.5)), {},
                          False),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_two_ranks_step_equals_one_rank_step(case):
    """The 2-rank step on the shards equals the 1-rank step on the global
    batch: every metric (a domain loss included) and every leaf of the
    state after the step (a discriminator's included)."""
    cfg_kw, kw, aux_first = STEP_CASES[case]
    cfg = small_cfg(**cfg_kw)
    aux_lr = (cfg.train.max_learning_rate * cfg.da.aux_lr_factor
              if aux_first else 0.0)
    ref = one_step(cfg, **kw)
    if cfg.train.stage == "adaptation":
        assert ref[1]["domain_loss"] != 0.0
    ranks = spawn(_step_worker, WORLD, args=(cfg, kw),
                  timeout=SPAWN_TIMEOUT)
    for got in ranks:
        assert_same_step(got, ref, cfg.train.max_learning_rate,
                         aux_lr=aux_lr)


def replayed_step(group, cfg, before, batch, shifts, epoch, steps_per_epoch):
    """One step of the port from the trees ``before`` on ``batch`` (the
    global batch; under ``group`` this rank's rows of it) with the ISP
    shifts ``shifts`` (the global batch's, as replayed draws): (trees
    after, metrics, mixup calls)."""
    modules = steps.build_modules(cfg, device="cpu", group=group)
    state = steps.load_train_state(modules, before)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    if group is not None:
        batch = mesh.shard_batch(group, batch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(steps, "sample_isp_shifts", lambda *a, **k: tuple(
            torch.tensor(s) for s in shifts))
        metrics = steps.make_train_step(
            modules, steps_per_epoch=steps_per_epoch)(state, batch, 1, epoch)
    return (weights.export_train_state(state),
            {k: float(v) for k, v in metrics.items()}, 0)
