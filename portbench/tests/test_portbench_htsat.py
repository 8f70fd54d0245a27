"""The ``serve_htsat_b64`` cell at a tiny size on the CPU: the runner's
check passes on the program and fails on each of its faults and on the
control, and set-up is refused where the port has no HTS-AT; HTS-AT's
FLOP count and the window attention's work at the published shapes; the
configuration's widths."""
from __future__ import annotations

import copy
import json
import os

import pytest
import torch

from portbench.harness import cell
from portbench.harness import htsat as H
from portbench.harness.readers import load
from portbench.reference import controls
from portbench.runners import serve_htsat
from portbench.tests.tiny_cells import ROOT

CELL = "serve_htsat_b64"


def tiny_htsat(config, mix):
    """1 s clips at 8 kHz on 32 mels, HTS-AT at 3 stages of d = 16-64
    (heads 2/2/4, window 4) on a 64 × 64 image: shifted and masked
    stages, a full-window stage, two merges; ``serve``'s tiny mix."""
    config, mix = copy.deepcopy(config), copy.deepcopy(mix)
    config["audio"].update(sr=8000, n_window=256, hop_size=80, n_mels=32,
                           mel_f_max=3500.0, max_len_seconds=1.0)
    config["htsat"].update(spec_size=64, embed_dim=16, depths=[2, 2, 2],
                           num_heads=[2, 2, 4], window_size=4)
    mix["audio"].update(freq_hz=[300, 3000], sweep_hz_per_s=2000,
                        event_s=[0.1, 0.5])
    mix.update(copy.deepcopy(serve_htsat.TINY))
    return config, mix


def run(seed: int = 2 ** 31 + 11, seconds: float = 0.5, **kw):
    torch.set_num_threads(2)
    return cell.execute(ROOT, CELL, seed, seconds, False, device="cpu",
                        require_card=False, overrides=tiny_htsat,
                        log=lambda s: None, **kw)


def test_sound_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"frame_posterior_gap", "clip_posterior_gap",
                                "token_gap", "stage1_band_gap"}


@pytest.mark.parametrize("fault", serve_htsat.FAULTS,
                         ids=lambda f: f.__name__)
def test_fault_is_caught(fault):
    r = run(fault=fault)
    assert not r["correct"], (fault.__name__, r["checks"])


def test_control_reads_far_above_the_program():
    """fp8 e4m3 operands in the program's place read at least three times
    the program's gaps, in one number or more."""
    _, _, config, mix, _ = cell.find(ROOT, CELL)
    ctl = controls.control_for(*tiny_htsat(config, mix))
    assert ctl.name == "fp8"
    prog = run()["checks"]
    got = run(control=ctl, seconds=1.0)["checks"]
    ratios = {k: got[k]["value"] / max(prog[k]["value"], 1e-12)
              for k in prog}
    assert max(ratios.values()) >= 3.0, (prog, got)


def test_parent_without_htsat_is_refused_at_setup(monkeypatch):
    """A port without HTS-AT fails at set-up, before weights."""
    monkeypatch.setattr(serve_htsat, "port_has_htsat", lambda: False)
    with pytest.raises(RuntimeError, match="no HTS-AT"):
        run()


def test_mask_fault_alters_only_the_wrap_band():
    """At the tiny size (first stage 16 × 16, window 4, shift 2; merged 8 ×
    8) ``wrap_band`` is the merged map's outer ring, and leaving out the
    shift's mask changes the first stage's tokens there and nowhere else,
    bit for bit in float32."""
    from bsed_tpu_torch.serve import make_fast_forward
    from portbench.harness import synth
    from portbench.harness import weights as Wt
    from portbench.reference import htsat as RH
    _, _, config, mix, _ = cell.find(ROOT, CELL)
    config, mix = tiny_htsat(config, mix)
    band = serve_htsat.wrap_band(config)
    ring = torch.ones(8, 8, dtype=torch.bool)
    ring[1:-1, 1:-1] = False
    assert torch.equal(band, ring.reshape(-1))
    cfg = serve_htsat.port_config(config, {"compute_dtype": "float32"})
    params = H.make_params(config, 5, "cpu")
    audio = synth.clips(7, 2, config["audio"], mix["audio"], "cpu")
    stats = H.bn0_stats(RH.log_mel(audio, config["audio"]))
    first = []
    for fault in (None, serve_htsat.shift_mask_left_out):
        fwd = make_fast_forward(cfg, Wt.to_numpy(params), Wt.to_numpy(stats),
                                device="cpu")
        fwd = fault(fwd) if fault else fwd
        fwd.htsat.layers[0].register_forward_hook(
            lambda m, i, o: first.append(o))
        fwd(audio)
    sound, faulty = first
    assert torch.equal(sound[:, ~band], faulty[:, ~band])
    gap = (faulty[:, band] - sound[:, band]).norm() / sound[:, band].norm()
    assert float(gap) > 1e-2


# --- arithmetic --------------------------------------------------------------

def _config():
    with open(os.path.join(ROOT, "portbench", "configs", "htsat.json")) as fh:
        return json.load(fh)


def test_htsat_flops_at_published_widths():
    config = _config()
    assert H.stages(config) == [(64, 96, 4, 2, 8), (32, 192, 8, 2, 8),
                                (16, 384, 16, 6, 8), (8, 768, 32, 2, 8)]
    f = H.htsat_flops(config)

    def block(n, d):
        return 24 * n * d * d + 4 * n * 64 * d
    assert f["blocks"] == pytest.approx(
        2 * block(4096, 96) + 2 * block(1024, 192) + 6 * block(256, 384)
        + 2 * block(64, 768))
    assert f["merges"] == pytest.approx(3 * 2 * 1024 * 384 * 192)
    assert f["patch_embed"] == pytest.approx(2 * 4096 * 16 * 96)
    assert f["head"] == pytest.approx(2 * 32 * 768 * 2 * 3 * 20)
    assert sum(f.values()) == pytest.approx(11.8e9, rel=3e-3)
    assert H.frontend_flops(config) == pytest.approx(
        4 * 1001 * 1024 * 513 + 2 * 1001 * 513 * 64)


def test_attention_work_counts_the_table_not_the_bias():
    mod = load(ROOT, "serve.htsat_attn_roofline")
    (module, attr, span, work_of), = mod.spans(_config())
    assert (module, attr) == ("bsed_tpu_torch.ops.window_attention",
                              "window_attention")
    for nwh, h in ((256, 4), (128, 8), (64, 16), (32, 32)):
        q = torch.zeros(2, nwh, 64, 24, dtype=torch.bfloat16)
        bias = torch.zeros(nwh, 64, 64, dtype=torch.bfloat16)
        nbytes, ops = work_of((q, q, q, bias), {}, q)
        assert ops == {"bfloat16": 4.0 * 2 * nwh * 64 ** 2 * 24}
        assert nbytes == (4 * 2 * nwh * 64 * 24 + 15 ** 2 * h) * 2


def test_configuration_keeps_the_published_widths():
    config = _config()
    h = config["htsat"]
    assert (h["spec_size"], h["patch_size"], h["patch_stride"],
            h["embed_dim"], h["depths"], h["num_heads"], h["window_size"],
            h["mlp_ratio"], h["qkv_bias"]) == (256, 4, 4, 96, [2, 2, 6, 2],
                                               [4, 8, 16, 32], 8, 4.0, True)
    assert config["audio"] == {"sr": 32000, "n_window": 1024,
                               "hop_size": 320, "n_mels": 64,
                               "mel_f_min": 50.0, "mel_f_max": 14000.0,
                               "max_len_seconds": 10.0}
    assert config["reduced"] == []
    # the control looks its precision up by the runner's name
    assert config["precision"]["serve_htsat"] == "bfloat16"
    n = sum(int(torch.tensor(s).prod()) for _, s, _ in H.leaves(config))
    assert n == pytest.approx(27.6e6, rel=0.01)


def test_htsat_weights_follow_the_published_keys():
    names = [k for k, _, _ in H.leaves(_config())]
    assert names[:4] == ["bn0.weight", "bn0.bias", "patch_embed.proj.weight",
                         "patch_embed.proj.bias"]
    assert "layers.3.blocks.1.attn.relative_position_bias_table" in names
    assert "layers.2.downsample.reduction.weight" in names
    assert not any(k.startswith("layers.3.downsample") for k in names)
    assert names[-2:] == ["tscam_conv.weight", "tscam_conv.bias"]
    assert len(names) == len(set(names))
