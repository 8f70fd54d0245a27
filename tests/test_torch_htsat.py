"""HTS-AT served through ``serve.make_fast_forward`` (``models/htsat.py``,
``ops/window_attention.py``, ``MelFrontEnd``'s torchlibrosa settings on
K1's power-dB form and the dense algorithm,
``mel_filterbank(norm="slaney")``) against the benchmark's plain float32
reference (``portbench/reference/htsat.py``), written from HTS-AT's
definitions, on seeded random weights at a tiny size on the CPU.

The tiny model keeps every mechanism of the published one: 1 s at 8 kHz,
101 frames resized to 128 and folded into a 64 × 64 image of 2 chunks of
32 mels; patches of 4 give a 16 × 16 map; three stages (depths 2, 2, 2,
widths 16/32/64, heads 2/2/4, window 4): stage 1 (16 × 16) and stage 2
(8 × 8) shift their odd blocks by 2 under the −100 mask, stage 3 (4 × 4)
has a window equal to its map (full attention, no shift); two patch
merges; the head undoes the fold into 8 steps of 16 frames.

Tolerances: the port and the reference compute the same float32 algebra
in other orders (K1's packed FFT against an rfft, bicubic by
``F.interpolate`` against a matrix, rolls and views against explicit
indices, SDPA against a softmax written out), so float32 results agree
to ~1e-5 of their scale; the bf16 forward is held at the rounding of
bfloat16 (8 bits of mantissa, ~4e-3 a product) carried through six
blocks.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from bsed_tpu_torch.config import (HtsatConfig, config_from_dict,
                                   config_to_dict, get_config)
from bsed_tpu_torch.models.htsat import HTSAT
from bsed_tpu_torch.ops import window_attention as WA
from bsed_tpu_torch.ops.filterbank import mel_filterbank, mel_frequencies
from bsed_tpu_torch.ops.mel import MelFrontEnd
from bsed_tpu_torch.serve import build_encoder, make_fast_forward
from bsed_tpu_torch.utils.weights import load_htsat
from portbench.harness import htsat as H
from portbench.harness import synth
from portbench.harness import weights as Wt
from portbench.reference import htsat as RH
from portbench.runners.serve_htsat import port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIO = {"gain_db": [-50, -20], "events": 4, "event_s": [0.1, 0.5],
         "freq_hz": [300, 3000], "sweep_hz_per_s": 2000, "event_db": [0, 25]}


def _config():
    """htsat.json cut to the tiny size (see the module)."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           "htsat.json")) as fh:
        config = json.load(fh)
    config["audio"].update(sr=8000, n_window=256, hop_size=80, n_mels=32,
                           mel_f_max=3500.0, max_len_seconds=1.0)
    config["htsat"].update(spec_size=64, embed_dim=16, depths=[2, 2, 2],
                           num_heads=[2, 2, 4], window_size=4)
    return config


@pytest.fixture(scope="module")
def tiny():
    """(config, params, stats, audio (3 clips of 1 s))."""
    config = _config()
    params = H.make_params(config, 11, "cpu")
    audio = synth.clips(13, 3, config["audio"], AUDIO, "cpu")
    stats = H.bn0_stats(RH.log_mel(audio, config["audio"]))
    return config, params, stats, audio


def _forward(config, params, stats, dtype="float32"):
    cfg = port_config(config, {"compute_dtype": dtype})
    return make_fast_forward(cfg, Wt.to_numpy(params), Wt.to_numpy(stats),
                             device="cpu")


def test_tiny_model_has_every_mechanism(tiny):
    """Shifted and masked stages, a full-window stage, two merges."""
    config, params, stats, _ = tiny
    model = _forward(config, params, stats).htsat
    blocks = [(b.resolution[0], b.window, b.shift_size,
               b.attn_mask is not None)
              for st in model.layers for b in st.blocks]
    assert blocks == [(16, 4, 0, False), (16, 4, 2, True),
                      (8, 4, 0, False), (8, 4, 2, True),
                      (4, 4, 0, False), (4, 4, 0, False)]
    assert [st.downsample is not None for st in model.layers] == [
        True, True, False]


@pytest.mark.parametrize("dtype,post_tol,token_tol", [
    ("float32", 1e-5, 1e-5), ("bfloat16", 0.03, 0.05)])
def test_fast_forward_matches_reference(tiny, dtype, post_tol, token_tol):
    """Framewise (3, 128, 20) and clipwise (3, 20) posteriors against the
    reference's, and by ‖e − r‖/‖r‖ the tokens after the final LayerNorm
    (``forward.htsat``'s output) and after the first stage's patch merge
    (``layers[0]``'s); one window-attention call a block."""
    config, params, stats, audio = tiny
    fwd = _forward(config, params, stats, dtype)
    seen, first = [], []
    fwd.htsat.register_forward_hook(lambda m, i, o: seen.append(o))
    fwd.htsat.layers[0].register_forward_hook(lambda m, i, o: first.append(o))
    before = WA.calls
    strong, weak = fwd(audio)
    assert WA.calls == before + 6
    rs, rw, rt, r1 = RH.forward(audio, params, stats, config)
    assert strong.shape == rs.shape == (3, 128, 20)
    assert weak.shape == rw.shape == (3, 20)
    assert strong.dtype == weak.dtype == torch.float32
    torch.testing.assert_close(strong, rs, rtol=0, atol=post_tol)
    torch.testing.assert_close(weak, rw, rtol=0, atol=post_tol)
    assert seen[0].shape == (3, 16, 64)
    assert float((seen[0].float() - rt).norm() / rt.norm()) < token_tol
    assert first[0].shape == r1.shape == (3, 64, 32)
    assert float((first[0].float() - r1).norm() / r1.norm()) < token_tol


@pytest.mark.parametrize("part", ["shift", "mask", "table", "merge"])
def test_each_mechanism_moves_the_tokens(tiny, part):
    """Each of the faults the cell's check has to catch moves the tiny
    model's tokens, the last stage's and the first's, by far more than
    the float32 tolerance: the tiny size exercises them all."""
    from portbench.runners import serve_htsat as SH
    fault = {"shift": SH.shift_left_out, "mask": SH.shift_mask_left_out,
             "table": SH.rel_bias_left_out,
             "merge": SH.merge_order_altered}[part]
    config, params, stats, audio = tiny
    fwd = fault(_forward(config, params, stats))
    seen, first = [], []
    fwd.htsat.register_forward_hook(lambda m, i, o: seen.append(o))
    fwd.htsat.layers[0].register_forward_hook(lambda m, i, o: first.append(o))
    fwd(audio)
    _, _, rt, r1 = RH.forward(audio, params, stats, config)
    assert float((seen[0] - rt).norm() / rt.norm()) > 1e-2
    assert float((first[0] - r1).norm() / r1.norm()) > 1e-2


def test_front_end_matches_reference(tiny):
    """The dense algorithm at HTS-AT's settings (periodic Hann, Slaney
    area norm, power mel, dB unclamped) against the reference's rfft
    front end: 1e-3 dB over values of tens of dB (float32 DFT products
    against an FFT)."""
    config, _, _, audio = tiny
    fe = MelFrontEnd(port_config(config, {}).audio, "dense", "cpu",
                     torchlibrosa=True)
    quiet = audio.clone()
    quiet[:, 4000:] = 0.0          # silent frames: 10·log10(1e-10) = −100
    got = fe(quiet, log=True)
    want = RH.log_mel(quiet, config["audio"])
    assert got.shape == want.shape == (3, 101, 32)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)
    assert float(got.min()) == pytest.approx(-100.0)
    assert float(got.max()) > -10.0                  # no top_db clamp


def test_htsat_front_end_is_k1_power_db(tiny, monkeypatch):
    """``make_htsat_forward``'s front end is K1's power-dB form: one call
    of the kernel entry a forward, with the power-dB constants (periodic
    Hann, the Slaney area-normalised bands), returning the dB that HTS-AT
    reads. On the CPU the entry runs its plain version, which equals the
    dense front end within 1e-3 dB and the reference's ``log_mel`` within
    ``test_front_end_matches_reference``'s tolerance, silent frames at
    −100 dB included; the power-dB form refuses to return a linear mel."""
    from bsed_tpu_torch.ops import mel_kernel
    config, params, stats, audio = tiny
    entry, seen = mel_kernel.fused_block_mel, []

    def spy(*args, **kwargs):
        out = entry(*args, **kwargs)
        seen.append((args[1], out))
        return out

    monkeypatch.setattr(mel_kernel, "fused_block_mel", spy)
    fwd = _forward(config, params, stats)
    inputs = []
    fwd.htsat.register_forward_hook(lambda m, i, o: inputs.append(i[0]))
    quiet = audio.clone()
    quiet[:, 4000:] = 0.0
    fwd(quiet)
    assert len(seen) == 1
    bases, db = seen[0]
    assert bases.power_db and float(bases.window[0]) == 0.0
    assert db.shape == (3, 101, 32)
    assert torch.equal(inputs[0], db)              # HTS-AT reads the dB
    dense = MelFrontEnd(port_config(config, {}).audio, "dense", "cpu",
                        torchlibrosa=True)(quiet, log=True)
    torch.testing.assert_close(db, dense, rtol=0, atol=1e-3)
    torch.testing.assert_close(db, RH.log_mel(quiet, config["audio"]),
                               rtol=0, atol=1e-3)
    assert float(db.min()) == pytest.approx(-100.0)
    k1 = MelFrontEnd(port_config(config, {}).audio, "block_kernel", "cpu",
                     torchlibrosa=True)
    with pytest.raises(ValueError, match="log=True"):
        k1(quiet)


def test_slaney_norm_is_unit_area():
    """norm="slaney" scales filter m by 2 / (f[m + 2] − f[m]) of the mel
    points in Hz, and matches the reference's own filterbank."""
    plain = mel_filterbank(32000, 1024, 64, 50.0, 14000.0, np.float64)
    slaney = mel_filterbank(32000, 1024, 64, 50.0, 14000.0, np.float64,
                            norm="slaney")
    f = mel_frequencies(66, 50.0, 14000.0)
    np.testing.assert_allclose(slaney, plain * (2.0 / (f[2:] - f[:-2])),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(
        slaney, RH.slaney_filterbank(32000, 1024, 64, 50.0, 14000.0),
        rtol=1e-9, atol=1e-15)
    with pytest.raises(ValueError, match="norm"):
        mel_filterbank(norm="htk")


def test_default_filterbank_and_k1_bands_unchanged():
    """The default (norm=None) filterbank is the JAX package's bit for
    bit, and so is K1's band table built from it."""
    from bsed_tpu.ops.filterbank import mel_filterbank as jax_filterbank
    from bsed_tpu_torch.ops.mel_kernel import build_mel_kernel_bases
    for dtype in (np.float32, np.float64):
        np.testing.assert_array_equal(mel_filterbank(dtype=dtype),
                                      jax_filterbank(dtype=dtype))
    ours = build_mel_kernel_bases(2048, 255, mel_filterbank(
        dtype=np.float64), device="cpu")
    theirs = build_mel_kernel_bases(2048, 255, jax_filterbank(
        dtype=np.float64), device="cpu")
    for a, b in zip(ours, theirs):
        if torch.is_tensor(a):
            assert torch.equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("side,w", [(16, 4), (8, 8), (64, 8)])
def test_window_partition_round_trip(side, w):
    """Partition then reverse is the identity; window k holds map rows
    ⌊k/(H/w)⌋·w … and columns (k mod H/w)·w …, row-major."""
    x = torch.arange(2 * side * side * 3, dtype=torch.float32).view(
        2, side, side, 3)
    win = WA.window_partition(x, w)
    assert win.shape == (2, (side // w) ** 2, w * w, 3)
    assert torch.equal(WA.window_reverse(win, w, side, side), x)
    k = (side // w) ** 2 - 1
    r0, c0 = (k // (side // w)) * w, (k % (side // w)) * w
    assert torch.equal(win[:, k].view(2, w, w, 3),
                       x[:, r0:r0 + w, c0:c0 + w])


def test_block_bias_built_once_and_again_on_change(tiny):
    """A block's (nW·h, N, N) bias is the gathered table plus the shift
    mask, the same tensor on every call until the table changes."""
    config, params, stats, _ = tiny
    blk = _forward(config, params, stats).htsat.layers[0].blocks[1]
    bias = blk.bias()
    assert bias.shape == (16 * 2, 16, 16) and blk.bias() is bias
    rel = RH.relative_bias(
        params["htsat"]["layers.0.blocks.1.attn.relative_position_bias_table"],
        4)
    mask = torch.as_tensor(RH.window_mask(16, 4, 2), dtype=torch.float32)
    torch.testing.assert_close(bias.view(16, 2, 16, 16),
                               rel[None] + mask[:, None], rtol=0, atol=0)
    with torch.no_grad():
        blk.attn.relative_position_bias_table.zero_()
    torch.testing.assert_close(blk.bias().view(16, 2, 16, 16),
                               mask[:, None].expand(16, 2, 16, 16),
                               rtol=0, atol=0)


def test_loader_takes_the_published_key_names(tiny):
    """A released checkpoint's extra keys (the torchlibrosa extractors,
    the unused linear head, the windows' index and mask buffers, bn0's
    counter) are skipped; a missing key is refused."""
    config, params, stats, _ = tiny
    sd = dict(Wt.to_numpy(params)["htsat"])
    extra = {"spectrogram_extractor.stft.conv_real.weight": np.zeros(3),
             "logmel_extractor.melW": np.zeros(3),
             "head.weight": np.zeros(3),
             "layers.0.blocks.1.attn_mask": np.zeros(3),
             "layers.0.blocks.0.attn.relative_position_index": np.zeros(3),
             "bn0.num_batches_tracked": np.zeros(())}
    cfg = port_config(config, {})
    model = HTSAT(cfg.model.htsat, 32, 20)
    load_htsat(model, {**sd, **extra}, Wt.to_numpy(stats)["htsat"])
    torch.testing.assert_close(
        model.layers[1].downsample.reduction.weight.detach(),
        params["htsat"]["layers.1.downsample.reduction.weight"])
    del sd["tscam_conv.weight"]
    with pytest.raises(RuntimeError, match="tscam_conv.weight"):
        load_htsat(HTSAT(cfg.model.htsat, 32, 20), sd,
                   Wt.to_numpy(stats)["htsat"])


def test_crnn_paths_refuse_an_htsat_configuration(tiny):
    """The CRNN's encoder and ``predict`` are not HTS-AT's: both refuse
    its configuration rather than serve a CRNN in its place."""
    from bsed_tpu_torch.predict import predict_recordings
    config, params, stats, _ = tiny
    cfg = port_config(config, {})
    with pytest.raises(ValueError, match="runs no CRNN encoder"):
        build_encoder(cfg, {}, {}, torch.device("cpu"))
    with pytest.raises(ValueError, match="HTS-AT"):
        predict_recordings(cfg, Wt.to_numpy(params), Wt.to_numpy(stats),
                           [], device="cpu")


@pytest.mark.parametrize("option", [
    {"mel_algorithm": "block_kernel"}, {"use_folded_stem": True},
    {"use_fused_epilogue": False}, {"use_fused_stem": True}])
def test_fast_forward_refuses_crnn_options_for_htsat(tiny, option):
    """HTS-AT runs its own torchlibrosa front end and no CRNN: an option
    of the CRNN's is refused, not ignored; K1 and torchlibrosa's front end
    build together (K1's power-dB form) and match the dense algorithm."""
    config, params, stats, audio = tiny
    cfg = port_config(config, {})
    with pytest.raises(ValueError, match="CRNN's options"):
        make_fast_forward(cfg, Wt.to_numpy(params), Wt.to_numpy(stats),
                          device="cpu", **option)
    k1 = MelFrontEnd(cfg.audio, "block_kernel", "cpu", torchlibrosa=True)
    dense = MelFrontEnd(cfg.audio, "dense", "cpu", torchlibrosa=True)
    torch.testing.assert_close(k1(audio, log=True), dense(audio, log=True),
                               rtol=0, atol=1e-3)


def test_config_round_trip_keeps_htsat():
    """``config_to_dict`` leaves ``model.htsat`` out when None (the JAX
    package's dict has no such key) and carries it otherwise."""
    cfg = get_config("baseline")
    assert "htsat" not in config_to_dict(cfg)["model"]
    with_htsat = cfg.replace(model=dataclasses.replace(
        cfg.model, htsat=HtsatConfig(depths=(2, 2, 2))))
    back = config_from_dict(json.loads(json.dumps(
        config_to_dict(with_htsat))))
    assert back == with_htsat and back.model.htsat.depths == (2, 2, 2)
