"""The ``serve_beats_crnn_b64`` cell at a tiny size on the CPU: the
runner's check passes on the program and fails on each of its faults and
on the control; BEATs' FLOP count and the attention's work at known
shapes; the configuration's widths."""
from __future__ import annotations

import copy
import json
import os

import pytest
import torch

from portbench.harness import beats as B
from portbench.harness import cell
from portbench.harness.readers import load
from portbench.reference import controls
from portbench.runners import serve_beats
from portbench.tests.tiny_cells import ROOT, tiny

CELL = "serve_beats_crnn_b64"


def tiny_beats(config, mix):
    """``tiny_cells.tiny``'s CRNN at 32 kHz (BEATs' front end decimates
    to 16 kHz) with 1 s clips, and BEATs at 2 layers of d = 64, 4 heads,
    on 32 fbank bins: 6 × 2 patches."""
    config, mix = tiny(config, mix)
    config = copy.deepcopy(config)
    config["audio"].update(sr=32000, mel_f_max=16000.0)
    config["beats"].update(num_mel_bins=32, embed_dim=32, encoder_layers=2,
                           encoder_embed_dim=64, encoder_ffn_embed_dim=128,
                           encoder_attention_heads=4, conv_pos=16,
                           conv_pos_groups=4)
    c = config["model"]["nb_filters"][-1]
    config["fusion"].update(in_features=c + 64, out_features=c)
    return config, mix


def run(seed: int = 2 ** 31 + 11, seconds: float = 0.5, **kw):
    torch.set_num_threads(2)
    return cell.execute(ROOT, CELL, seed, seconds, False, device="cpu",
                        require_card=False, overrides=tiny_beats,
                        log=lambda s: None, **kw)


def test_sound_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == {"frame_posterior_gap", "clip_posterior_gap",
                                "embedding_gap"}


@pytest.mark.parametrize("fault", serve_beats.FAULTS,
                         ids=lambda f: f.__name__)
def test_fault_is_caught(fault):
    r = run(fault=fault)
    assert not r["correct"], (fault.__name__, r["checks"])


def test_control_reads_far_above_the_program():
    """fp8 e4m3 operands in the program's place read at least three times
    the program's gaps, in one number or more."""
    _, _, config, mix, _ = cell.find(ROOT, CELL)
    ctl = controls.control_for(*tiny_beats(config, mix))
    assert ctl.name == "fp8"
    prog = run()["checks"]
    got = run(control=ctl, seconds=1.0)["checks"]
    ratios = {k: got[k]["value"] / max(prog[k]["value"], 1e-12)
              for k in prog}
    assert max(ratios.values()) >= 3.0, (prog, got)


def test_parent_without_beats_is_refused_at_setup(monkeypatch):
    """A port without the BEATs branch fails at set-up, before weights."""
    monkeypatch.setattr(serve_beats, "port_has_beats", lambda: False)
    with pytest.raises(RuntimeError, match="no BEATs branch"):
        run()


# --- arithmetic --------------------------------------------------------------

def _config():
    with open(os.path.join(ROOT, "portbench", "configs",
                           "crnn_beats.json")) as fh:
        return json.load(fh)


def test_beats_flops_at_published_widths():
    config = _config()
    assert B.tokens(config) == (62, 8)
    f = B.beats_flops(config)
    n, d = 496, 768
    assert f["patches"] == pytest.approx(2 * n * 256 * 512 + 2 * n * 512 * d)
    assert f["pos_conv"] == pytest.approx(2 * n * d * 48 * 128)
    layer = 2 * n * 4 * d * d + 4 * n * d * 3072 + 4 * n * n * d \
        + 2 * n * d * 8
    assert f["layers"] == pytest.approx(12 * layer)
    assert layer == pytest.approx(7.78e9, rel=1e-3)
    assert sum(f.values()) == pytest.approx(98.5e9, rel=2e-3)
    assert B.fusion_flops(config) == pytest.approx(2 * 313 * 896 * 128)


def test_attention_work_counts_the_table_not_the_bias():
    mod = load(ROOT, "serve.beats_attn_roofline")
    q = torch.zeros(2, 12, 496, 64, dtype=torch.bfloat16)
    gate = torch.zeros(2, 12, 496, 1, dtype=torch.bfloat16)
    bias = torch.zeros(12, 496, 496, dtype=torch.bfloat16)
    (module, attr, span, work_of), = mod.spans(_config())
    assert (module, attr) == ("bsed_tpu_torch.ops.rel_attention",
                              "gated_rel_attention")
    nbytes, ops = work_of((q, q, q, gate, bias), {}, q)
    assert ops == {"bfloat16": 4.0 * 2 * 12 * 496 ** 2 * 64}
    assert nbytes == (4 * 2 * 12 * 496 * 64 + 2 * 12 * 496 + 320 * 12) * 2


def test_configuration_keeps_the_published_widths():
    config = _config()
    b = config["beats"]
    assert (b["encoder_layers"], b["encoder_embed_dim"],
            b["encoder_attention_heads"], b["encoder_ffn_embed_dim"],
            b["num_buckets"], b["max_distance"], b["conv_pos"],
            b["conv_pos_groups"], b["input_patch_size"],
            b["embed_dim"]) == (12, 768, 12, 3072, 320, 800, 128, 16, 16,
                                512)
    with open(os.path.join(ROOT, "portbench", "configs", "crnn.json")) as fh:
        crnn = json.load(fh)
    for k in ("audio", "model", "presets", "classes", "train"):
        assert config[k] == crnn[k], k
    # the control looks its precision up by the runner's name
    assert config["precision"] == dict(crnn["precision"],
                                       serve_beats="bfloat16")
    assert config["reduced"] == []
    assert config["fusion"] == {"in_features": 896, "out_features": 128}


def test_beats_weights_follow_the_checkpoint_keys():
    config = _config()
    config["beats"].update(encoder_layers=2)
    names = [k for k, _, _ in B.leaves(config["beats"])]
    assert names[:3] == ["patch_embedding.weight", "layer_norm.weight",
                         "layer_norm.bias"]
    assert "encoder.layers.0.self_attn.relative_attention_bias.weight" \
        in names
    assert not any("layers.1.self_attn.relative" in k for k in names)
    assert len(names) == len(set(names))
