"""The plain reference against hand results at a tiny size, and the
generators' determinism per seed."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.harness import synth
from portbench.harness import weights as Wt
from portbench.reference import crnn as R
from portbench.reference import frontend, quant, recording
from portbench.reference import train_step as RT

AUDIO = {"sr": 3200, "n_window": 256, "hop_size": 80, "n_mels": 16,
         "mel_f_min": 0.0, "mel_f_max": 1600.0, "max_len_seconds": 1.0}
SPEC = {"gain_db": [-50, -20], "events": 3, "event_s": [0.1, 0.5],
        "freq_hz": [100, 1400], "sweep_hz_per_s": 300, "event_db": [0, 25]}


def test_filterbank_is_slaney_triangles():
    fb = frontend.mel_filterbank(AUDIO)
    assert fb.shape == (129, 16)
    assert fb.min() >= 0.0 and fb.max() <= 1.0 + 1e-12
    # below 1 kHz the Slaney scale is linear: 200/3 Hz a mel
    assert frontend._hz_to_mel(500.0) == pytest.approx(7.5)
    assert frontend._mel_to_hz(frontend._hz_to_mel(2500.0)) == \
        pytest.approx(2500.0)
    peaks = fb.argmax(axis=0)
    assert (np.diff(peaks) >= 0).all()


def test_log_mel_of_a_sine_peaks_at_its_band():
    t = torch.arange(3200) / 3200.0
    x = torch.sin(2 * np.pi * 400.0 * t)[None]
    db = frontend.log_mel(x, AUDIO)
    assert db.shape == (1, 41, 16)
    band = int(frontend.mel_filterbank(AUDIO)[32].argmax())   # 400 Hz bin
    assert int(db[0, 20].argmax()) == band
    assert float(db.max() - db.min()) <= 80.0 + 1e-4


def test_conv_block_by_hand():
    """One channel, a 3×3 kernel of ones, BatchNorm an identity, GLU with
    an identity linear: y · sigmoid(y), then a 2×2 mean."""
    x = torch.zeros(1, 2, 2, 1)
    x[0, 0, 0, 0] = 1.0
    p = {"conv": {"kernel": torch.ones(3, 3, 1, 1), "bias": torch.zeros(1)},
         "bn": {"scale": torch.ones(1), "bias": torch.zeros(1)},
         "GLU_0": {"linear": {"kernel": torch.eye(1),
                              "bias": torch.zeros(1)}}}
    s = {"bn": {"mean": torch.zeros(1), "var": torch.ones(1) - 1e-3}}
    y = R.conv_block(x, p, s, (2, 2), "glu")
    one = 1.0 / (1.0 + np.exp(-1.0))
    assert float(y) == pytest.approx(one, rel=1e-6)     # every tap sees 1


def test_gru_matches_torch_equations():
    torch.manual_seed(0)
    gru = torch.nn.GRU(3, 4, num_layers=2, batch_first=True,
                       bidirectional=True)
    p = dict(gru.named_parameters())
    x = torch.randn(2, 5, 3)
    want = gru(x)[0]
    got = R.bigru(x, {k: v.detach() for k, v in p.items()}, 2)
    assert torch.allclose(got, want, atol=1e-6)
    got_t = RT.bigru(x, {k: v.detach() for k, v in p.items()}, 2,
                     quant.identity)
    assert torch.allclose(got_t, want, atol=1e-6)


def test_attention_pooling_by_hand():
    x = torch.zeros(1, 2, 1)
    x[0, 1, 0] = 1.0
    p = {"dense": {"kernel": torch.tensor([[2.0]]), "bias": torch.zeros(1)},
         "dense_softmax": {"kernel": torch.tensor([[1.0]]),
                           "bias": torch.zeros(1)}}
    strong, weak = R.predictor(x, p)
    s = torch.sigmoid(torch.tensor([0.0, 2.0]))
    # one class: the softmax over classes is 1 for every frame
    assert torch.allclose(strong[0, :, 0], s)
    assert float(weak) == pytest.approx(float(s.mean()))


def test_roll_is_per_row_circular():
    x = torch.arange(10.0).reshape(2, 5)
    out = RT.roll(x, torch.tensor([1, -2]), 1)
    assert out.tolist() == [[4, 0, 1, 2, 3], [7, 8, 9, 5, 6]]


def test_events_by_hand():
    post = np.zeros((10, 2), np.float32)
    post[2:8, 1] = 0.9
    ev = recording.events(post, 0.5, 1, 0.1)
    assert ev == [(1, pytest.approx(0.2), pytest.approx(0.8))]
    post[4, 1] = 0.1                       # a one-frame hole, filtered
    assert recording.events(post, 0.5, 3, 0.1) == ev


def test_fp8_and_bf16_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -5, 448.0, -3.3])
    assert quant.fp8(x)[1] in (1.0, 1.0625)
    assert quant.fp8(x)[2] == 448.0
    assert quant.bf16(torch.tensor([1.0 + 2 ** -10]))[0] == 1.0
    g = torch.ones(4, requires_grad=True)
    quant.fp8(g * 3.3).sum().backward()
    assert torch.allclose(g.grad, torch.full((4,), 3.3))


def test_generators_are_deterministic_per_seed():
    a = synth.clips(2 ** 33 + 7, 3, AUDIO, SPEC, "cpu")
    b = synth.clips(2 ** 33 + 7, 3, AUDIO, SPEC, "cpu")
    c = synth.clips(2 ** 33 + 8, 3, AUDIO, SPEC, "cpu")
    assert torch.equal(a, b) and a.shape == c.shape == (3, 3200)
    assert not torch.equal(a, c)
    model = {"n_in_channel": 1, "nclass": 20, "activation": "glu",
             "nb_filters": [4, 8], "pooling": [[2, 2], [1, 2]],
             "kernel_size": 3, "n_rnn_cell": 8, "n_layers_rnn": 2,
             "use_fpn": True}
    p1 = Wt.make_params(model, 5, "cpu")
    p2 = Wt.make_params(model, 5, "cpu")
    p3 = Wt.make_params(model, 6, "cpu")
    l1, l2, l3 = (dict(RT._leaves(p)) for p in (p1, p2, p3))
    assert l1.keys() == l3.keys()
    assert all(torch.equal(l1[k], l2[k]) for k in l1)
    assert not torch.equal(l1[("encoder", "rnn", "weight_ih_l0")],
                           l3[("encoder", "rnn", "weight_ih_l0")])
    assert ("encoder", "cnn", "block_down", "conv", "kernel") in l1


def test_step_draws_follow_the_seed():
    g1 = RT.step_generator(2 ** 31 + 3, 0, "cpu")
    g2 = RT.step_generator(2 ** 31 + 3, 0, "cpu")
    g3 = RT.step_generator(2 ** 31 + 3, 1, "cpu")
    a, b, c = (torch.randint(0, 256, (8,), generator=g) for g in (g1, g2, g3))
    assert torch.equal(a, b) and not torch.equal(a, c)
