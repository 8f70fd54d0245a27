"""The weak taggers of the port (bsed_tpu_torch/models/resnet.py) and their
weight carry (utils/weights.init_tagger, load_named / export_named, the
tagging trainer's save / load and pretrained init) against
``bsed_tpu/models/resnet.py`` and ``bsed_tpu/train/tagging_trainer.py``
on the CPU, on 2 s clips at 3.2 kHz (40 × 128 mel frames, ``SMALL_AUDIO``
of tests/test_aux_components.py), float32, the JAX side under
``jax.default_matmul_precision("float32")``.

Gates: forwards in eval and train mode 1e-4, the running statistics a
train-mode forward leaves 1e-5 + 1e-4 relative (the gate of
tests/test_torch_train_step.py); the pretrained init's forward against
the torch oracle 2e-5 (tests/test_aux_components.py:242-268).

Both sides start from the same trees. ``jax_trainer`` builds
``bsed_tpu``'s TaggingTrainer with its ``model.init`` replaced by those
trees: its eager init costs ~12 s (ResNet) here, and the trees it would
draw are not the port's (the same distributions, another generator), so
``init_tagger`` is held to its keys, shapes and distributions under
``jax.eval_shape`` instead."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsed_tpu.train.tagging_trainer as j_tt
from bsed_tpu.config import AudioConfig as JAudioConfig
from bsed_tpu.config import get_config as j_get_config
from bsed_tpu.ops.mel import amplitude_to_db as j_amplitude_to_db

from bsed_tpu_torch.config import AudioConfig, get_config
from bsed_tpu_torch.models.resnet import build_tagger
from bsed_tpu_torch.train.tagging_trainer import TaggingTrainer
from bsed_tpu_torch.utils import weights

from tests.test_torch_train_step import _assert_trees, _leaves
from tests.test_torch_trainer import one_torch_thread  # noqa: F401
from tests.torch_ref import TorchResNet18

SMALL_AUDIO = dict(sr=3200, hop_size=160, max_len_seconds=2.0)
ARCHS = ("resnet", "vgg")


def cfgs(**audio):
    """(port cfg, JAX cfg) of preset baseline at ``SMALL_AUDIO``."""
    a = dict(SMALL_AUDIO, **audio)
    return (get_config("baseline").replace(audio=AudioConfig(**a)),
            j_get_config("baseline").replace(audio=JAudioConfig(**a)))


def trees(cfg, arch, seed=0):
    """The port's fresh (params, batch_stats) from ``seed``."""
    return weights.init_tagger(cfg, arch, torch.Generator().manual_seed(seed))


def jax_trainer(jcfg, arch, params, stats, mean_teacher=False, lr=1e-3):
    """``bsed_tpu``'s TaggingTrainer starting from (params, stats)."""
    build = j_tt.build_tagger

    def with_trees(cfg, a):
        model = build(cfg, a)
        variables = {"params": jax.tree.map(jnp.asarray, params),
                     "batch_stats": jax.tree.map(jnp.asarray, stats)}
        # flax modules are frozen dataclasses
        object.__setattr__(model, "init", lambda *_, **__: variables)
        return model

    j_tt.build_tagger = with_trees
    try:
        return j_tt.TaggingTrainer(jcfg, arch=arch, learning_rate=lr,
                                   mean_teacher=mean_teacher)
    finally:
        j_tt.build_tagger = build


def port_trainer(cfg, arch, params, stats, mean_teacher=False, lr=1e-3):
    trainer = TaggingTrainer(cfg, arch=arch, learning_rate=lr,
                             mean_teacher=mean_teacher, device="cpu")
    weights.load_named(trainer.model, params, stats)
    if mean_teacher:
        weights.load_named(trainer.ema_model, params, stats)
    return trainer


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_keep_mask(model, variables, batch, rng):
    """The keep mask ``bsed_tpu``'s VGGTagger draws in a train-mode
    forward of ``batch`` clips with dropout key ``rng``. It depends on the
    key and its (batch, 4096) shape only, so it is read off a forward of
    small zero clips whose fc1 bias is raised until ReLU(fc1) is positive
    everywhere: kept where the dropout's output is nonzero."""
    params = dict(variables["params"])
    params["fc1"] = dict(params["fc1"], bias=params["fc1"]["bias"] + 1e6)
    _, mut = model.apply(dict(variables, params=params),
                         jnp.zeros((batch, 32, 32, 1)), train=True,
                         rngs={"dropout": rng},
                         mutable=["batch_stats", "intermediates"],
                         capture_intermediates=True)
    dropped = np.asarray(mut["intermediates"]["FastDropout_0"]["__call__"][0])
    return torch.from_numpy(dropped != 0)


def _mel(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    return np.abs(rng.standard_normal(
        (batch, cfg.audio.max_frames, cfg.audio.n_mels))).astype(np.float32)


def _random_stats(stats, seed):
    """Running statistics away from 0 / 1, so eval mode is no identity."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (0.1 * rng.standard_normal(v.shape) if
                      p[-1].key == "mean" else
                      0.5 + rng.random(v.shape)).astype(np.float32), stats)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, train):
    cfg, jcfg = cfgs()
    params, stats = trees(cfg, arch)
    stats = _random_stats(stats, 1)
    x = np.array(j_amplitude_to_db(jnp.asarray(_mel(cfg, 3, 2))))
    jmodel = j_tt.build_tagger(jcfg, arch)
    variables = {"params": params, "batch_stats": stats}
    rng = jax.random.key(5)
    with jax.default_matmul_precision("float32"):
        if train:
            want, mut = jmodel.apply(variables, x[..., None], train=True,
                                     rngs={"dropout": rng},
                                     mutable=["batch_stats"])
        else:
            want = jmodel.apply(variables, x[..., None], train=False)
        keep = (jax_keep_mask(jmodel, variables, x.shape[0], rng)
                if train and arch == "vgg" else None)

    model = build_tagger(cfg, arch).train(train)
    weights.load_named(model, params, stats)
    with torch.no_grad():
        got = model(torch.from_numpy(x), keep=keep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert 0.05 < float(np.asarray(want).std())  # not saturated
    if train:
        _, got_stats = weights.export_named(model)
        _assert_trees(got_stats, np_tree(mut["batch_stats"]),
                      "batch_stats", atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tagger_matches_flax_init(arch):
    """Keys and shapes of ``bsed_tpu``'s ``model.init`` (abstractly
    evaluated), BatchNorm 1 / 0 and statistics exactly 0 / 1, biases 0,
    kernels lecun-normal: std sqrt(1 / fan_in) and nothing beyond two
    of the untruncated std."""
    cfg, jcfg = cfgs()
    params, stats = trees(cfg, arch)
    jmodel = j_tt.build_tagger(jcfg, arch)
    dummy = jnp.zeros((2, cfg.audio.max_frames, cfg.audio.n_mels, 1))
    want = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(0)}, dummy,
        train=True))
    for got, ref in ((params, want["params"]),
                     (stats, want["batch_stats"])):
        got_shapes = {p: v.shape for p, v in _leaves(got)}
        ref_shapes = {tuple(k.key for k in p): tuple(v.shape) for p, v
                      in jax.tree_util.tree_flatten_with_path(ref)[0]}
        assert got_shapes == ref_shapes
    for path, v in _leaves(stats):
        assert (v == (0.0 if path[-1] == "mean" else 1.0)).all(), path
    for path, v in _leaves(params):
        assert v.dtype == np.float32, path
        if path[-1] == "scale":
            assert (v == 1.0).all(), path
        elif path[-1] == "bias":
            assert (v == 0.0).all(), path
        else:
            std = np.sqrt(1.0 / np.prod(v.shape[:-1]))
            assert abs(v.std() / std - 1.0) < 0.1, (path, v.std(), std)
            assert np.abs(v).max() <= 2.0 * std / 0.87962566103423978 \
                * (1 + 1e-6), path
    again, _ = trees(cfg, arch)
    assert all(np.array_equal(a, b) for (_, a), (_, b)
               in zip(_leaves(params), _leaves(again)))


def test_pretrained_resnet18_identical_forward():
    """A torch resnet18 with the reference's surgery (1-channel conv1, a
    20-class fc) loads with nothing skipped and gives its forward."""
    cfg, _ = cfgs()
    torch.manual_seed(0)
    oracle = TorchResNet18(nclass=cfg.nclass, in_ch=1).eval()
    with torch.no_grad():            # running statistics away from 0 / 1
        for m in oracle.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    trainer = TaggingTrainer(cfg, device="cpu")
    assert trainer.load_pretrained_torch(oracle.state_dict()) == []
    mel = _mel(cfg, 2, 0)
    x = np.array(j_amplitude_to_db(jnp.asarray(mel)))[:, None]
    with torch.no_grad():
        want = oracle(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(trainer.predict_weak(mel), want, atol=2e-5)


def test_pretrained_resnet18_skips_rebuilt_layers(tmp_path):
    """An ImageNet-shaped state dict (3-channel stem, 1000-class fc), read
    from a file with a ``"state_dict"`` wrapper, skips what
    ``bsed_tpu``'s ``load_pretrained_torch`` skips; the skipped layers
    keep their fresh init and a deep block takes the torch weights."""
    cfg, jcfg = cfgs()
    torch.manual_seed(1)
    state = TorchResNet18(nclass=1000, in_ch=3).state_dict()
    path = str(tmp_path / "imagenet.pt")
    torch.save({"state_dict": state}, path)
    params, stats = trees(cfg, "resnet")
    trainer = port_trainer(cfg, "resnet", params, stats)
    skipped = trainer.load_pretrained_torch(path)
    j_skipped = jax_trainer(jcfg, "resnet", params, stats
                            ).load_pretrained_torch(dict(state))
    assert skipped == j_skipped and skipped
    assert any("stem_conv" in s for s in skipped)
    assert any("fc" in s for s in skipped)
    got, _ = weights.export_named(trainer.model)
    np.testing.assert_array_equal(got["fc"]["kernel"],
                                  params["fc"]["kernel"])
    np.testing.assert_array_equal(got["stem_conv"]["kernel"],
                                  params["stem_conv"]["kernel"])
    np.testing.assert_array_equal(
        got["layer3_block0"]["conv1"]["kernel"],
        state["layer3.0.conv1.weight"].numpy().transpose(2, 3, 1, 0))


@pytest.mark.parametrize("arch", ARCHS)
def test_save_load_round_trip(arch, tmp_path):
    """``save`` writes the flax trees of ``bsed_tpu`` for the same
    weights as CPU tensors; ``load`` reads them back into a fresh
    trainer, leaf for leaf."""
    cfg, _ = cfgs()
    params, stats = trees(cfg, arch, seed=3)
    stats = _random_stats(stats, 4)
    path = str(tmp_path / "sub" / "tagger.pt")
    port_trainer(cfg, arch, params, stats).save(path)
    blob = torch.load(path, weights_only=True)
    assert sorted(blob) == ["batch_stats", "params"]
    for key, ref in (("params", params), ("batch_stats", stats)):
        got = dict(_leaves(jax.tree.map(lambda t: t.numpy(), blob[key])))
        want = dict(_leaves(ref))
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[p], want[p]) for p in want), key
    fresh = TaggingTrainer(cfg, arch=arch, device="cpu")
    fresh.load(path)
    for got, want in zip(weights.export_named(fresh.model),
                         (params, stats)):
        want = dict(_leaves(want))
        assert all(np.array_equal(v, want[p]) for p, v in _leaves(got))
