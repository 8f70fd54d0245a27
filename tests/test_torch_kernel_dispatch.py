"""The one rule that picks a kernel or its plain version
(``bsed_tpu_torch/kernels.launches_on``) and its test seam
(``kernels.plain_versions``), on the CPU.

Each of the six kernel entries asks ``kernels.launches_on`` on every
call. With it patched to say yes for the CPU, the entry leaves its plain
route for its kernel path, which stops at the entry's own device check
(CPU tensors are not on a card) or at ``kernels.load``, patched to raise.
Unpatched, the entry returns its plain version's result bit for bit and
counts no launch.
"""
import numpy as np
import pytest
import torch

from bsed_tpu_torch import kernels
from bsed_tpu_torch.config import AudioConfig
from bsed_tpu_torch.ops import (gru_kernel, mel_kernel, rel_attention,
                                stem_epilogue, stem_kernel)
from bsed_tpu_torch.ops.filterbank import mel_filterbank


class KernelPath(Exception):
    """Raised by the patched ``kernels.load``: a kernel was asked for."""


def _randn(rng, *shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))


def _mel(rng):
    cfg = AudioConfig(max_len_seconds=0.25)
    fb = mel_filterbank(cfg.sr, cfg.n_window, cfg.n_mels, dtype=np.float64)
    bases = mel_kernel.build_mel_kernel_bases(cfg.n_window, cfg.hop_size, fb,
                                              device="cpu")
    args = (_randn(rng, 2, cfg.n_samples, scale=0.1), bases, cfg.n_window,
            cfg.hop_size, cfg.n_mels)
    return (mel_kernel.fused_block_mel, mel_kernel.fused_block_mel_plain,
            args)


def _epilogue_inputs(rng):
    """h (B, T, G, 128) and the eval form's constants, group-pool form."""
    return (_randn(rng, 2, 6, 4, 128), _randn(rng, 128, scale=0.2) + 1.0,
            _randn(rng, 128, scale=0.3), _randn(rng, 128, 128, scale=0.09),
            _randn(rng, 128, scale=0.1))


def _stem_fwd(rng):
    h, inv, c, w, b = _epilogue_inputs(rng)
    return (stem_epilogue.stem_epilogue_fwd,
            lambda *a: stem_epilogue.stem_epilogue_plain(
                *a[:8], None, 0, a[-1]),
            (h, inv, c, w, b, "glu", 1, None, 0, None, 0, 2))


def _stem_bwd(rng):
    h, inv, c, w, b = _epilogue_inputs(rng)
    gz = _randn(rng, 2, 6, 2, 128)
    return (stem_epilogue.stem_epilogue_bwd,
            lambda *a: stem_epilogue.stem_epilogue_bwd_plain(
                *a[:9], None, 0, a[-1]),
            (gz, h, inv, c, w, b, "glu", 1, None, 0, None, 0, 2))


def _gru(rng):
    weights = gru_kernel.prepare_weights(
        _randn(rng, 2, 3 * 128, 128, scale=0.09),
        _randn(rng, 2, 3 * 128, scale=0.1), torch.float32)
    return (gru_kernel.recurrence, gru_kernel.recurrence_plain,
            (_randn(rng, 2, 3, 5, 3 * 128), weights))


def _stem(rng):
    folded = {"w_gate": _randn(rng, 3, 3, 16), "w_lin": _randn(rng, 3, 3, 16),
              "b_gate": _randn(rng, 16), "b_lin": _randn(rng, 16)}
    return (stem_kernel.fused_stem_block, stem_kernel.reference_stem_block,
            (_randn(rng, 2, 6, 128, 1), folded))


def _attention(rng):
    q, k, v = (_randn(rng, 2, 2, 8, 64, scale=0.3) for _ in range(3))
    args = (q, k, v, _randn(rng, 2, 2, 8, 1) + 2.0, _randn(rng, 2, 8, 8))
    return (rel_attention.gated_rel_attention,
            lambda *a: rel_attention.gated_rel_attention_plain(*a).to(
                a[0].dtype),
            args)


ENTRIES = {"fused_block_mel": (_mel, mel_kernel.fused_block_mel),
           "stem_epilogue_fwd": (_stem_fwd, stem_epilogue.stem_epilogue_fwd),
           "stem_epilogue_bwd": (_stem_bwd, stem_epilogue.stem_epilogue_bwd),
           "recurrence": (_gru, gru_kernel.gru_bidir_recurrence),
           "fused_stem_block": (_stem, stem_kernel.fused_stem_block),
           "gated_rel_attention": (_attention,
                                   rel_attention.gated_rel_attention)}


def _load_refused(name):
    raise KernelPath(f"kernels.load({name!r})")


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_entry_follows_launches_on(monkeypatch, name):
    """Told to launch, the entry leaves its plain route on CPU tensors;
    left alone, it returns its plain version's result bit for bit and
    counts no launch."""
    make, counter = ENTRIES[name]
    entry, plain, args = make(np.random.default_rng(len(name)))
    with monkeypatch.context() as m:
        m.setattr(kernels, "launches_on", lambda device: True)
        m.setattr(kernels, "load", _load_refused)
        with pytest.raises((KernelPath, ValueError),
                           match="runs on CUDA|kernels.load"):
            entry(*args)
    before = counter.launches
    got, want = entry(*args), plain(*args)
    assert counter.launches == before
    for g, w in zip(*((t,) if torch.is_tensor(t) else t
                      for t in (got, want))):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_plain_versions_holds_the_card_off_and_restores():
    card, cpu = torch.device("cuda"), torch.device("cpu")
    assert kernels.launches_on(card) and not kernels.launches_on(cpu)
    with kernels.plain_versions():
        assert not kernels.launches_on(card)
        with kernels.plain_versions():
            assert not kernels.launches_on(card)
        assert not kernels.launches_on(card)
    assert kernels.launches_on(card) and not kernels.launches_on(cpu)


def test_plain_versions_restores_after_an_exception():
    card = torch.device("cuda")
    with pytest.raises(RuntimeError, match="inside the block"):
        with kernels.plain_versions():
            assert not kernels.launches_on(card)
            raise RuntimeError("inside the block")
    assert kernels.launches_on(card)


def test_other_devices_are_refused():
    """Neither a kernel nor a plain version runs on a device that is
    neither CUDA nor the CPU, as before the rule."""
    with pytest.raises(ValueError, match="CUDA or the CPU, got meta"):
        kernels.launches_on(torch.device("meta"))
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        gru_kernel.recurrence(torch.zeros((2, 1, 1, 384), device="meta"),
                              gru_kernel.RecurrenceWeights(
                                  torch.zeros((2, 128, 384), device="meta"),
                                  torch.zeros((2, 384), device="meta")))
