"""Serving's conv blocks after the folded stem on K2's group-pool form
(``serve.GroupPoolCNN``): each block's conv without bias, then one eval-form
call of the epilogue (its plain version on the CPU) in place of the
BatchNorm → gate → pool chain of ``_RestCNN``'s ``ConvBlock``s.

Weights and running statistics are drawn from numpy seeds, away from
their init so the folding is exercised. Gates: float32 1e-5 (the two
chains differ in the order of the affine's roundings alone); bfloat16 2e-2
of the output's largest magnitude (both chains round every step to bf16,
2^-8, over four blocks)."""
import dataclasses

import numpy as np
import pytest
import torch

from bsed_tpu_torch import serve
from bsed_tpu_torch.config import AudioConfig, get_config
from bsed_tpu_torch.models.layers import ConvBlock
from bsed_tpu_torch.utils.weights import init_params

START = 3            # blocks 3-6: G = 16, 8, 4, 2, pooled (1, 2)


def _cfg(activation="glu", pooling=None):
    cfg = get_config("baseline").replace(
        audio=AudioConfig(sr=3200, hop_size=160, max_len_seconds=2.0))
    model = dataclasses.replace(cfg.model, activation=activation)
    if pooling is not None:
        model = dataclasses.replace(model, pooling=pooling)
    return cfg.replace(model=model)


def _randomize(module, seed):
    """Every conv, BatchNorm and dense of ``module`` from a numpy seed."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    for blk in module.modules():
        if not isinstance(blk, ConvBlock):
            continue
        w = blk.conv.weight
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        with torch.no_grad():
            w.copy_(t(rng.standard_normal(w.shape) / np.sqrt(fan_in)))
            blk.conv.bias.copy_(t(rng.standard_normal(w.shape[0]) * 0.2))
            n = w.shape[0]
            blk.bn.weight.copy_(t(rng.uniform(0.5, 1.5, n)))
            blk.bn.bias.copy_(t(rng.standard_normal(n) * 0.3))
            blk.bn.running_mean.copy_(t(rng.standard_normal(n) * 0.3))
            blk.bn.running_var.copy_(t(rng.uniform(0.3, 2.0, n)))
            if hasattr(blk.act, "linear"):
                lin = blk.act.linear
                lin.weight.copy_(t(rng.standard_normal(lin.weight.shape)
                                   / np.sqrt(n)))
                lin.bias.copy_(t(rng.standard_normal(n) * 0.1))
    return module.eval()


@pytest.mark.parametrize("activation", ["glu", "cg"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fused_epilogue", [True, False])
def test_group_pool_cnn_matches_rest_cnn(activation, dtype, fused_epilogue):
    """Blocks 3-6 served as conv + K2 group pool equal ``_RestCNN`` in eval
    mode on the same weights and statistics, through K2's entry and
    through ``stem_epilogue_plain``."""
    cfg = _cfg(activation)
    assert serve.group_pool_serves(cfg, START)
    dt = None if dtype is torch.float32 else dtype
    rest = _randomize(serve._RestCNN(cfg, start=START, dtype=dt), 7)
    cnn = serve.GroupPoolCNN(rest, activation, dt, fused_epilogue)
    assert [blk[2:] for blk in cnn.blocks] == [(1, 2)] * 4
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 9, 16, 64)).astype(np.float32)).to(dtype)
    with torch.inference_mode():
        want = rest(x)
        got = cnn(x)
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape == (2, 9, 1, 128)
    scale = float(want.abs().max())
    assert scale > 0.1
    gate = 1e-5 if dtype is torch.float32 else 2e-2 * scale
    torch.testing.assert_close(got, want, rtol=0, atol=gate)


@pytest.mark.parametrize("activation", ["glu", "cg"])
def test_folded_constants_equal_batchnorm_and_gate(activation):
    """On one block: h·inv + c is the block's eval BatchNorm of the conv
    output with its bias, y @ w + b is the gate's dense, and the conv
    weight is the block's in the compute dtype, channels-last."""
    blk = _randomize(ConvBlock(64, 128, (1, 2), activation), 5)
    rng = np.random.default_rng(9)
    h = torch.from_numpy(rng.standard_normal((2, 5, 4, 128)).astype(
        np.float32))
    k = serve.fold_conv_block(blk)
    with torch.no_grad():
        y = blk.bn(h + blk.conv.bias)
        torch.testing.assert_close(h * k["inv"] + k["c"], y, rtol=1e-6,
                                   atol=1e-5)
        torch.testing.assert_close(y @ k["w"] + k["b"], blk.act.linear(y),
                                   rtol=1e-6, atol=1e-5)
    assert all(k[n].dtype == torch.float32 and k[n].shape == (128,)
               for n in ("inv", "c", "b"))
    torch.testing.assert_close(k["weight"], blk.conv.weight, rtol=0, atol=0)
    kb = serve.fold_conv_block(blk, torch.bfloat16)
    assert kb["weight"].dtype == kb["w"].dtype == torch.bfloat16
    assert kb["weight"].is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(kb["inv"], k["inv"]) and torch.equal(kb["c"], k["c"])


_REFUSED = {
    "relu": dict(activation="relu"),
    "leakyrelu": dict(activation="leakyrelu"),
    "freq_pool_4": dict(pooling=((2, 2), (2, 2), (1, 2), (1, 2), (1, 4),
                                 (1, 2), (1, 1))),
    "time_pool_3": dict(pooling=((2, 2), (2, 2), (1, 2), (3, 2), (1, 2),
                                 (1, 2), (1, 2))),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_layouts_k2_refuses_keep_rest_cnn(monkeypatch, case):
    """relu / leakyrelu, or a pool the group form does not take (pg 4, pt
    3): the folded branch serves blocks 3-6 as ``_RestCNN``, and the
    encoder still runs."""
    cfg = _cfg(**_REFUSED[case])
    assert not serve.group_pool_serves(cfg, START)

    def refuse(*args, **kwargs):
        raise AssertionError("GroupPoolCNN built for a refused layout")
    monkeypatch.setattr(serve, "GroupPoolCNN", refuse)
    params, stats = init_params(cfg, 1)
    encode = serve.build_encoder(cfg, params["encoder"], stats["encoder"],
                                 torch.device("cpu"))
    mel = torch.from_numpy(np.abs(np.random.default_rng(2).standard_normal(
        (2, cfg.audio.max_frames, cfg.audio.n_mels, 1))).astype(np.float32))
    with torch.inference_mode():
        assert torch.isfinite(encode(mel)).all()


def test_default_layout_builds_group_pool_cnn(monkeypatch):
    """The default GLU layout serves blocks 3-6 as ``GroupPoolCNN``, once
    an encoder; the fused-stem and standard branches never do."""
    built = []
    real = serve.GroupPoolCNN

    def record(*args, **kwargs):
        built.append(args[1])          # the activation
        return real(*args, **kwargs)
    monkeypatch.setattr(serve, "GroupPoolCNN", record)
    cfg = _cfg()
    params, stats = init_params(cfg, 2)
    for kw in ({}, {"use_folded_stem": False}, {"use_fused_stem": True}):
        serve.build_encoder(cfg, params["encoder"], stats["encoder"],
                            torch.device("cpu"), **kw)
    assert built == ["glu"]


@pytest.mark.parametrize("fused,calls", [(True, 7), (False, 0)])
def test_fused_epilogue_option_governs_group_pool(monkeypatch, fused, calls):
    """``use_fused_epilogue`` chooses K2 for the whole folded branch: on,
    a forward enters K2's entry 3 times for blocks 0-2 and 4 for blocks
    3-6 (on the CPU it runs the plain version); off, never, and blocks 3-6
    run ``stem_epilogue_plain``. The two give the same posteriors."""
    from bsed_tpu_torch.ops import stem_epilogue

    entered = []
    real = stem_epilogue.stem_epilogue_fwd

    def count(*args, **kwargs):
        entered.append(args[7] is None)          # pool_w: group form
        return real(*args, **kwargs)
    monkeypatch.setattr(stem_epilogue, "stem_epilogue_fwd", count)
    cfg = _cfg()
    params, stats = init_params(cfg, 3)
    mel = torch.from_numpy(np.abs(np.random.default_rng(4).standard_normal(
        (2, cfg.audio.max_frames, cfg.audio.n_mels, 1))).astype(np.float32))
    with torch.inference_mode():
        got = serve.build_encoder(cfg, params["encoder"], stats["encoder"],
                                  torch.device("cpu"),
                                  use_fused_epilogue=fused)(mel)
        assert len(entered) == calls and sum(entered) == calls * 4 // 7
        want = serve.build_encoder(cfg, params["encoder"], stats["encoder"],
                                   torch.device("cpu"))(mel)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("g,pt,pg,cout,ok", [
    (16, 1, 2, 128, True), (2, 1, 2, 128, True), (8, 2, 2, 128, True),
    (16, 1, 2, 64, False), (16, 3, 2, 128, False), (16, 1, 4, 128, False),
    (3, 1, 1, 128, False)])
def test_group_form_ok_is_check_group_form(g, pt, pg, cout, ok):
    """``group_form_ok``, which ``group_pool_serves`` asks, holds exactly
    where ``check_group_form``, which the kernel's input check runs,
    raises nothing."""
    from bsed_tpu_torch.ops import stem_epilogue

    assert stem_epilogue.group_form_ok(g, pt, pg, cout) is ok
    if not ok:
        with pytest.raises(ValueError):
            stem_epilogue.check_group_form(g, pt, pg, cout)
