"""The CRNN fused with a BEATs encoder (``models/beats.py``,
``ops/fbank.py``, ``ops/rel_attention.py``, ``serve.make_fast_forward``'s
BEATs branch) against the benchmark's plain float32 reference
(``portbench/reference/beats.py``), written from BEATs' equations, on
seeded random weights at a tiny size on the CPU: 2 layers, d = 64, 4
heads, 1-2 s clips at 32 kHz.

Tolerances: the port and the reference compute the same float32 algebra
in other orders (a conv against a product for the patches and the
decimation, float64 against float32 filter banks), so float32 stages
agree to ~1e-5 of their scale; the bf16 forward is held at the rounding
of bfloat16 (8 bits of mantissa, ~4e-3 a product) carried through two
post-norm layers and the BiGRU.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bsed_tpu_torch.config import (BeatsConfig, config_from_dict,
                                   config_to_dict, get_config)
from bsed_tpu_torch.models.beats import BEATs, relative_buckets
from bsed_tpu_torch.ops import rel_attention
from bsed_tpu_torch.ops.fbank import BeatsFbank
from bsed_tpu_torch.serve import make_fast_forward
from bsed_tpu_torch.utils.weights import load_beats
from portbench.harness import beats as B
from portbench.harness import synth
from portbench.harness import weights as Wt
from portbench.harness.port import port_config
from portbench.reference import beats as RB
from portbench.reference import crnn as R
from portbench.reference.frontend import log_mel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIO = {"gain_db": [-50, -20], "events": 4, "event_s": [0.1, 0.5],
         "freq_hz": [500, 6000], "sweep_hz_per_s": 2000, "event_db": [0, 25]}


def _config(seconds: float = 2.0):
    """crnn_beats.json cut to the tiny size."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           "crnn_beats.json")) as fh:
        config = json.load(fh)
    config["audio"].update(n_window=256, n_mels=16, max_len_seconds=seconds)
    config["model"].update(nb_filters=[16, 32, 64, 16],
                           pooling=[[2, 2], [2, 2], [1, 2], [1, 2]],
                           n_rnn_cell=16)
    config["beats"].update(embed_dim=32, encoder_layers=2,
                           encoder_embed_dim=64, encoder_ffn_embed_dim=128,
                           encoder_attention_heads=4, conv_pos=16,
                           conv_pos_groups=4)
    config["fusion"].update(in_features=80, out_features=16)
    return config


def _bc(config) -> BeatsConfig:
    return BeatsConfig(**config["beats"])


@pytest.fixture(scope="module")
def tiny():
    """(config, params, stats, audio (3 clips of 2 s))."""
    torch.manual_seed(0)
    config = _config()
    params = B.make_params(config, 11, 12, "cpu")
    audio = synth.clips(13, 3, config["audio"], AUDIO, "cpu")
    stats = {"encoder": {"cnn": R.block_input_stats(
        log_mel(audio, config["audio"]), params, config["model"])}}
    return config, params, stats, audio


def _encoder(config, params, dtype=torch.float32) -> BEATs:
    enc = BEATs(_bc(config))
    load_beats(enc, Wt.to_numpy(params["beats"]))
    return enc.cast(dtype).eval()


# --- the relative-position buckets -----------------------------------------

BUCKETS = {0: 0, -1: 1, 1: 161, -79: 79, 79: 239, -80: 80, 80: 240,
           100: 247, -495: 143, 495: 303, 800: 319}


def test_buckets_at_known_offsets():
    """320 buckets, max distance 800: half for offsets > 0, |r| < 80
    exact, 80 + ⌊ln(|r|/80)/ln 10 · 80⌋ above, capped at 159."""
    rel = np.array(sorted(BUCKETS))
    want = [BUCKETS[r] for r in rel]
    assert RB.bucket(rel, 320, 800).tolist() == want
    assert relative_buckets(torch.as_tensor(rel), 320, 800).tolist() == want
    wide = np.arange(-2000, 2001)
    assert np.array_equal(
        relative_buckets(torch.as_tensor(wide), 320, 800).numpy(),
        RB.bucket(wide, 320, 800))


# --- the front end ----------------------------------------------------------

@pytest.mark.parametrize("seconds", [1.0, 1.5])
def test_decimation_and_fbank_match_reference(seconds):
    """10 s gives 998 frames; here 1 s 98 and 1.5 s 148. Log mel
    energies agree to 2e-4 (float32 FFTs of 2^15-scaled frames summed in
    other orders; the values are O(1) after the normalisation)."""
    config = _config(seconds)
    bc = _bc(config)
    audio = synth.clips(5, 2, config["audio"], AUDIO, "cpu")
    wave = RB.decimate(audio, config["beats"])
    assert wave.shape[-1] == int(32000 * seconds) // 2
    got = BeatsFbank(bc, "cpu")(audio)
    want = RB.fbank(wave, config["beats"])
    frames = 1 + (wave.shape[-1] - bc.frame_length) // bc.frame_shift
    assert got.shape == want.shape == (2, frames, bc.num_mel_bins)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)


def test_decimation_keeps_the_band_and_rejects_above():
    """A 1 kHz tone passes at unit gain; a 12 kHz one (folded to 4 kHz by
    the decimation were there no filter) is cut by more than 40 dB."""
    t = torch.arange(32000) / 32000.0
    lo, hi = (torch.sin(2 * np.pi * f * t)[None] for f in (1000.0, 12000.0))
    cfg = _config()["beats"]
    for x in (lo, hi):
        assert RB.decimate(x, cfg).shape == (1, 16000)
    rms = lambda x: float(RB.decimate(x, cfg)[:, 100:-100].pow(2).mean()  # noqa: E731
                          .sqrt())
    assert rms(lo) == pytest.approx(np.sqrt(0.5), rel=1e-3)
    assert rms(hi) < 0.01 * np.sqrt(0.5)


# --- the encoder, part by part ---------------------------------------------

def test_weight_norm_folded_and_position_convolution(tiny):
    """The loader folds w = g·v/‖v‖ (the norm over all but the tap
    dim); patches, position convolution and LayerNorm match the
    reference's at 1e-5."""
    config, params, _, audio = tiny
    enc = _encoder(config, params)
    sd = params["beats"]
    v, g = sd["encoder.pos_conv.0.weight_v"], sd["encoder.pos_conv.0.weight_g"]
    want_w = g * v / v.pow(2).sum((0, 1), keepdim=True).sqrt()
    torch.testing.assert_close(enc.encoder.pos_conv[0].weight.detach(),
                               want_w, rtol=1e-6, atol=1e-7)
    fb = RB.fbank(RB.decimate(audio, config["beats"]), config["beats"])
    with torch.no_grad():
        got = enc.embed(fb)
    torch.testing.assert_close(got, RB.embed(fb, sd, config["beats"]),
                               rtol=0, atol=1e-5)


def test_one_layer_with_gate_and_shared_table(tiny):
    """Layer 1 (no table of its own) on layer 0's position bias, against
    the reference's layer at 1e-5; without the gate or the bias the
    reference moves by far more."""
    config, params, _, _ = tiny
    enc = _encoder(config, params)
    sd, bc = params["beats"], config["beats"]
    x = torch.randn(2, 24, 64, generator=torch.Generator().manual_seed(3))
    bias = RB.position_bias(sd, bc, 24)
    torch.testing.assert_close(enc.position_bias(24), bias, rtol=0, atol=0)
    assert not hasattr(enc.encoder.layers[1].self_attn,
                       "relative_attention_bias")
    with torch.no_grad():
        got = enc.encoder.layers[1](x, enc.position_bias(24), enc.alpha)
    want = RB.layer(x, sd, 1, bias, bc)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    for off in ({"gate": False}, {"rel_bias": False}):
        assert float((RB.layer(x, sd, 1, bias, bc, **off) - want)
                     .abs().max()) > 1e-2


def _counting_plain(monkeypatch):
    """``gated_rel_attention_plain`` replaced by itself with a call count
    (the entry looks it up at call time)."""
    plain, calls = rel_attention.gated_rel_attention_plain, []

    def counted(*args):
        calls.append(1)
        return plain(*args)
    monkeypatch.setattr(rel_attention, "gated_rel_attention_plain", counted)
    return calls


def test_attention_entry_matches_its_plain_form(monkeypatch):
    """The entry against the softmax written out, float32 (1e-5): on the
    CPU it calls the plain form once and counts no kernel launch."""
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 4, 24, 16, generator=gen) for _ in range(3))
    gate = 1 + torch.rand(2, 4, 24, 1, generator=gen)
    bias = torch.randn(4, 24, 24, generator=gen)
    calls = _counting_plain(monkeypatch)
    before = rel_attention.gated_rel_attention.launches
    got = rel_attention.gated_rel_attention(q, k, v, gate, bias)
    assert len(calls) == 1
    assert rel_attention.gated_rel_attention.launches == before
    monkeypatch.undo()
    torch.testing.assert_close(
        got, rel_attention.gated_rel_attention_plain(q, k, v, gate, bias),
        rtol=0, atol=1e-5)


def _views(b, n, h, d, dtype=torch.float32, seed=0):
    """q, k, v as ``_SelfAttention`` passes them: (B, H, L, D) views of
    (B, L, H·D) projections; gate (B, H, L, 1) in (1, 2), bias (H, L, L)."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, n, h * d, generator=gen).to(dtype)
               .view(b, n, h, d).transpose(1, 2) for _ in range(3))
    gate = (1 + torch.rand(b, h, n, 1, generator=gen)).to(dtype)
    bias = torch.randn(h, n, n, generator=gen).to(dtype)
    return q, k, v, gate, bias


@pytest.mark.parametrize("n", [24, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_entry_on_model_views(n, dtype):
    """The entry on strided (B, H, L, D) views and ragged token counts:
    the plain form of the same inputs in q's dtype, and the same as on
    contiguous copies (float32 1e-6)."""
    args = _views(2, n, 4, 16, dtype, seed=n)
    got = rel_attention.gated_rel_attention(*args)
    assert got.dtype == dtype and got.shape == (2, 4, n, 16)
    want = rel_attention.gated_rel_attention_plain(*args)
    torch.testing.assert_close(got, want.to(dtype), rtol=0, atol=0)
    dense = rel_attention.gated_rel_attention_plain(
        *(t.contiguous() for t in args))
    torch.testing.assert_close(want, dense, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fault", ["rel_bias_left_out", "gate_left_out"])
def test_attention_entry_honours_zero_bias_and_unit_gate(fault):
    """The benchmark's faults hand the entry a zero bias or a unit gate:
    it computes softmax(q·kᵀ/√d)·v, or the bias ungated, written out here
    (1e-5), and not the true output."""
    q, k, v, gate, bias = _views(2, 24, 4, 16, seed=3)
    s = q @ k.transpose(-1, -2) / 4.0
    if fault == "rel_bias_left_out":
        got = rel_attention.gated_rel_attention(q, k, v, gate,
                                                torch.zeros_like(bias))
    else:
        got = rel_attention.gated_rel_attention(q, k, v,
                                                torch.ones_like(gate), bias)
        s = s + bias
    torch.testing.assert_close(got, torch.softmax(s, -1) @ v, rtol=0,
                               atol=1e-5)
    true = rel_attention.gated_rel_attention(q, k, v, gate, bias)
    assert float((got - true).abs().max()) > 0.1


def test_launch_plan_takes_the_model_views_without_a_copy():
    """The kernel's arguments for BEATs' bf16 views at 496 tokens: the
    very tensors (no copy), and the strides of (B, L, H·D) storage, the
    gate's and the table's."""
    args = _views(2, 496, 12, 64, torch.bfloat16)
    plan = rel_attention.launch_plan(*args)
    assert all(a.data_ptr() == t.data_ptr()
               for a, t in zip(args, plan.tensors))
    row = 12 * 64
    assert plan.strides == [496 * row, 64, row] * 3 + [
        12 * 496, 496, 1, 496 * 496, 496]


@pytest.mark.parametrize("n", [37, 200])
def test_launch_plan_puts_p_rows_on_16_bytes(n):
    """P's rows start on 16 bytes for the kernel's tensor map: a token
    count that is no multiple of 8 gets a copy with rows padded to one,
    holding P's values as given; 200 tokens pass P itself."""
    args = _views(1, n, 2, 64, torch.bfloat16)
    pb = rel_attention.launch_plan(*args).tensors[4]
    assert pb.shape == args[4].shape and torch.equal(pb, args[4])
    assert pb.stride(1) % 8 == 0 and pb.data_ptr() % 16 == 0
    assert (pb.data_ptr() == args[4].data_ptr()) == (n % 8 == 0)


def test_launch_plan_gives_q_k_v_one_stride_order():
    """The kernel maps q, k and v in one stride order, the model's: a
    contiguous (B, H, L, D) q is copied into (B, L, H, D) storage, values
    kept; the views beside it pass as they are."""
    q, k, v, gate, bias = _views(2, 24, 4, 64, torch.bfloat16)
    dense = q.contiguous()
    plan = rel_attention.launch_plan(dense, k, v, gate, bias)
    pq, pk, pv = plan.tensors[:3]
    assert pq.data_ptr() != dense.data_ptr() and torch.equal(pq, dense)
    assert pq.transpose(1, 2).is_contiguous()
    assert pk.data_ptr() == k.data_ptr() and pv.data_ptr() == v.data_ptr()
    assert plan.strides[:3] == [24 * 4 * 64, 64, 4 * 64]


def test_launch_plan_copies_rows_it_cannot_stream():
    """q, k, v whose rows do not start on 16 bytes are copied into the
    model's layout (here q), values kept; a gate and bias in float32
    beside bf16 q are rounded to q's dtype."""
    q, k, v, gate, bias = _views(1, 24, 2, 64, torch.bfloat16)
    wide = torch.randn(1, 2, 24, 65).to(torch.bfloat16)
    q = wide[..., 1:]
    plan = rel_attention.launch_plan(q, k, v, gate.float(), bias.float())
    pq, pk, _, pg, pb = plan.tensors
    assert pq.transpose(1, 2).is_contiguous()
    assert pq.data_ptr() != q.data_ptr() and torch.equal(pq, q)
    assert pk.data_ptr() == k.data_ptr()
    assert pg.dtype == pb.dtype == torch.bfloat16
    assert plan.strides[:3] == [24 * 2 * 64, 64, 2 * 64]


@pytest.mark.parametrize("case,match", [
    ("float16", "float32 or bfloat16"), ("head_32", "takes q"),
    ("bf16_600_tokens", "at most 512 tokens"),
    ("bias_shape", "bias \\(H, L, L\\)"), ("kv_dtype", "share a dtype")])
def test_launch_plan_refuses_what_the_kernel_does_not_take(case, match):
    """What the kernel does not take raises before any launch; float32 is
    held to no token limit."""
    dtype = torch.float16 if case == "float16" else torch.bfloat16
    n = 600 if case == "bf16_600_tokens" else 24
    d = 32 if case == "head_32" else 64
    q, k, v, gate, bias = _views(1, n, 2, d, dtype)
    if case == "bias_shape":
        bias = bias[:, :, :-1]
    if case == "kv_dtype":
        k = k.float()
    with pytest.raises(ValueError, match=match):
        rel_attention.launch_plan(q, k, v, gate, bias)
    if case == "bf16_600_tokens":
        plan = rel_attention.launch_plan(
            *(t.float() for t in (q, k, v, gate, bias)))
        assert plan.tensors[0].dtype == torch.float32


def test_encoder_calls_no_library_attention(tiny, monkeypatch):
    """The encoder's attention goes through the entry alone: with
    ``F.scaled_dot_product_attention`` made to raise, a forward runs and
    calls the plain form twice (2 layers), counting no kernel launch."""
    config, params, _, audio = tiny

    def refused(*a, **kw):
        raise AssertionError("scaled_dot_product_attention called")
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                        refused)
    enc = _encoder(config, params)
    fb = BeatsFbank(_bc(config), torch.device("cpu"))(audio)
    calls = _counting_plain(monkeypatch)
    before = rel_attention.gated_rel_attention.launches
    with torch.no_grad():
        out = enc(fb)
    assert len(calls) == 2
    assert rel_attention.gated_rel_attention.launches == before
    assert torch.isfinite(out).all()


def test_loader_takes_the_public_key_names(tiny):
    """A state dict made here under the released checkpoint's key names
    (weight norm unfolded, layer 0 alone holding the table) loads
    strictly, and the encoder then matches the reference at 1e-5."""
    config, params, _, audio = tiny
    bc = config["beats"]
    d, e, p = bc["encoder_embed_dim"], bc["embed_dim"], 16
    rng = np.random.default_rng(9)

    def r(*shape, scale=None):
        scale = scale or 1.0 / np.sqrt(shape[-1])
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    sd = {"patch_embedding.weight": r(e, 1, p, p, scale=1 / 16),
          "layer_norm.weight": 1 + r(e, scale=0.1),
          "layer_norm.bias": r(e, scale=0.1),
          "post_extract_proj.weight": r(d, e), "post_extract_proj.bias":
          r(d, scale=0.1),
          "encoder.pos_conv.0.weight_g": np.abs(r(1, 1, 16, scale=3)),
          "encoder.pos_conv.0.weight_v": r(d, 16, 16),
          "encoder.pos_conv.0.bias": r(d, scale=0.1),
          "encoder.layer_norm.weight": 1 + r(d, scale=0.1),
          "encoder.layer_norm.bias": r(d, scale=0.1),
          "encoder.layers.0.self_attn.relative_attention_bias.weight":
          r(320, 4, scale=1.0)}
    for i in range(2):
        at = f"encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[at + f"self_attn.{proj}.weight"] = r(d, d)
            sd[at + f"self_attn.{proj}.bias"] = r(d, scale=0.1)
        sd[at + "self_attn.grep_linear.weight"] = r(8, 16)
        sd[at + "self_attn.grep_linear.bias"] = r(8, scale=0.1)
        sd[at + "self_attn.grep_a"] = 1 + r(1, 4, 1, 1, scale=0.1)
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            sd[at + ln + ".weight"] = 1 + r(d, scale=0.1)
            sd[at + ln + ".bias"] = r(d, scale=0.1)
        sd[at + "fc1.weight"], sd[at + "fc1.bias"] = r(128, d), r(128)
        sd[at + "fc2.weight"], sd[at + "fc2.bias"] = r(d, 128), r(d)
    enc = BEATs(_bc(config))
    load_beats(enc, sd)
    fb = RB.fbank(RB.decimate(audio, bc), bc)
    with torch.no_grad():
        got = enc.eval()(fb)
    want = RB.beats(fb, {k: torch.from_numpy(v) for k, v in sd.items()}, bc)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_beats(BEATs(_bc(config)), {k: v for k, v in sd.items()
                                        if "grep_a" not in k})


# --- the served forward -----------------------------------------------------

def _port_cfg(config, dtype: str):
    cfg = port_config(config, "serve", {"runner": "serve_beats"})
    return cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype=dtype, beats=_bc(config)))


@pytest.mark.parametrize("dtype,frame_tol,emb_tol", [
    ("float32", 1e-5, 1e-5), ("bfloat16", 0.02, 0.05)])
def test_fast_forward_matches_reference(tiny, dtype, frame_tol, emb_tol):
    """make_fast_forward's BEATs branch (kernels' plain versions on the
    CPU): posteriors against the reference's forward, the embeddings
    (``forward.beats.encoder``'s output) by ‖e − r‖/‖r‖."""
    config, params, stats, audio = tiny
    fwd = make_fast_forward(_port_cfg(config, dtype), Wt.to_numpy(params),
                            Wt.to_numpy(stats), device="cpu",
                            precision="high")
    seen = []
    fwd.beats.encoder.register_forward_hook(lambda m, i, o: seen.append(o))
    strong, weak = fwd(audio)
    h, emb = RB.encode(audio, params, stats, config)
    rs, rw = R.predictor(h, params["predictor"])
    assert strong.shape == rs.shape == (3, 251 // 4, 20)
    torch.testing.assert_close(strong, rs, rtol=0, atol=frame_tol)
    torch.testing.assert_close(weak, rw, rtol=0, atol=frame_tol)
    gap = float((seen[0].float() - emb).norm() / emb.norm())
    assert gap < emb_tol


def test_crnn_path_unchanged_without_beats(tiny):
    """Without a BEATs part the forward has none (``forward.beats`` is
    None) and serves the CRNN as the reference's CRNN."""
    config, params, stats, audio = tiny
    cfg = port_config(config, "serve", {"runner": "serve"})
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="float32"))
    p = {k: v for k, v in params.items() if k != "beats"}
    fwd = make_fast_forward(cfg, Wt.to_numpy(p), Wt.to_numpy(stats),
                            device="cpu")
    assert fwd.beats is None
    strong, _ = fwd(audio)
    rs, _ = R.forward(log_mel(audio, config["audio"]), params, stats,
                      config["model"])
    torch.testing.assert_close(strong, rs, rtol=0, atol=1e-5)


def test_encoder_without_its_fusion_is_refused(tiny):
    """An encoder built for a BEATs configuration without the fusion (as
    ``train.steps.make_predict_fn``, which feeds it the mel alone, would
    build it) is refused, not served as the CRNN alone."""
    from bsed_tpu_torch.serve import build_encoder
    config, params, stats, _ = tiny
    with pytest.raises(ValueError, match="takes its fusion"):
        build_encoder(_port_cfg(config, "float32"),
                      Wt.to_numpy(params["encoder"]),
                      Wt.to_numpy(stats["encoder"]), torch.device("cpu"))


def test_predict_recordings_serves_beats(tiny, tmp_path):
    """``predict.predict_recordings`` reaches the BEATs branch through
    ``make_fast_forward``: a one-clip recording's posteriors equal the
    reference's forward of that clip."""
    from bsed_tpu_torch.predict import predict_recordings
    config, params, stats, audio = tiny
    path = str(tmp_path / "rec.npy")
    np.save(path, audio[0].numpy())
    out = predict_recordings(_port_cfg(config, "float32"),
                             Wt.to_numpy(params), Wt.to_numpy(stats),
                             [path], device="cpu",
                             batch_size=1, keep_posteriors=True)
    rs, _ = RB.forward(audio[:1], params, stats, config)
    np.testing.assert_allclose(out["posteriors"][0], rs[0].numpy(),
                               rtol=0, atol=1e-5)
    assert out["batches"] == [[1]]


def test_config_round_trip_keeps_beats():
    """``config_to_dict`` leaves ``model.beats`` out when None (the JAX
    package's dict has no such key) and carries it otherwise."""
    cfg = get_config("baseline")
    assert "beats" not in config_to_dict(cfg)["model"]
    assert config_from_dict(config_to_dict(cfg)) == cfg
    with_beats = cfg.replace(model=dataclasses.replace(
        cfg.model, beats=BeatsConfig(encoder_layers=2)))
    back = config_from_dict(json.loads(json.dumps(
        config_to_dict(with_beats))))
    assert back == with_beats and back.model.beats.encoder_layers == 2


def test_new_modules_import_with_jax_and_pandas_blocked():
    code = ("import sys\n"
            "for name in ('jax', 'flax', 'bsed_tpu', 'pandas'):\n"
            "    sys.modules[name] = None\n"
            "import bsed_tpu_torch.models.beats, bsed_tpu_torch.ops.fbank\n"
            "import bsed_tpu_torch.ops.rel_attention, bsed_tpu_torch.serve\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"
