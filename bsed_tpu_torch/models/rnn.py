"""Bidirectional multi-layer GRU. Port of
``bsed_tpu/models/rnn.py:BidirectionalGRU`` (reference RNN.py:7-16).

The JAX module's gate order (r, z, n) with the recurrent bias inside the
reset gate ("linear before reset") is exactly ``torch.nn.GRU``'s, and its
parameter names (``weight_ih_l0``, ``bias_hh_l1_reverse``, …) are
torch's, so the module is an ``nn.GRU``. The JAX package runs this
recurrence in XLA (``lax.scan``), so cuDNN runs it here; its inter-layer
dropout in training draws from the step's generator (``BidirectionalGRU``).
Dtype handling follows rnn.py:83-111: the input, the projection and the
carry are in the compute dtype; the output is cast to float32.

``HoistedBiGRU`` is the JAX module's own form of the same network, and
the form the port serves (``serve.make_fast_forward``): one
input-projection matmul per layer for both directions, then both
directions' recurrences in one walk over time on kernel K4
(``ops/gru_kernel.py``, the port of the Pallas drop-in for
``_gru_scan_bidir``) or on K4's plain version, as
``kernels.launches_on`` decides; its weights are laid out
once, when it is built. ``bigru_hoisted`` is the same network written as
the JAX module writes it, laying the weights out on every call: the
reference the built form is held to. ``gru_scan_bidir`` ports
``_gru_scan_bidir`` itself (h carried in the compute dtype). Training
keeps ``nn.GRU``: K4 is forward only, as the Pallas kernel is.

Weights: serving casts them to the compute dtype once, at build time
(``cast_weights=True``). Training keeps float32 master weights, as the JAX
train state does, and casts them per call through
``torch.func.functional_call``, so the optimizer updates float32 values and
the gradients flow back through the casts.
"""
from __future__ import annotations

import warnings
from typing import Optional

import torch
import torch.nn as nn

from bsed_tpu_torch.ops import gru_kernel
from bsed_tpu_torch.ops.dropout import FastDropout


def gru_scan_bidir(xp2: torch.Tensor, w_hh2: torch.Tensor,
                   b_hh2: torch.Tensor) -> torch.Tensor:
    """Both GRU directions in one walk over time, everything in xp2's
    dtype (port of ``bsed_tpu/models/rnn.py:_gru_scan_bidir``).

    xp2: (2, B, T, 3H) with xp2[1] already time-flipped; w_hh2: (2, 3H, H);
    b_hh2: (2, 3H). Returns (2, B, T, H) with out[1] in flipped time
    order."""
    dt = xp2.dtype
    w_t2 = w_hh2.transpose(1, 2).to(dt)
    b2 = b_hh2.to(dt)[:, None, :]
    h = torch.zeros(xp2.shape[:2] + (w_hh2.shape[2],), dtype=dt,
                    device=xp2.device)
    ys = []
    for t in range(xp2.shape[2]):
        hp = torch.bmm(h, w_t2) + b2
        xr, xz, xn = xp2[:, :, t].chunk(3, dim=-1)
        hr, hz, hn = hp.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        ys.append(h)
    return torch.stack(ys, dim=2)


def _no_flatten() -> None:
    pass


def _template_gru(n_in: int, n_hidden: int) -> nn.GRU:
    """A one-layer bidirectional ``nn.GRU`` that ``functional_call`` feeds
    another module's weights. On the card ``nn.GRU`` flattens the weights
    it is given into one buffer of its own, rebinding their storage in
    place; these are another module's parameters, so it never flattens,
    and cuDNN copies them per call."""
    gru = nn.GRU(n_in, n_hidden, batch_first=True, bidirectional=True)
    gru.flatten_parameters = _no_flatten
    return gru


class BidirectionalGRU(nn.Module):
    """(B, T, n_in) → (B, T, 2·n_hidden) float32.

    ``dropout`` is ``bsed_tpu``'s inter-layer dropout (rnn.py:109-110):
    in training, each layer's output but the last goes through
    ``ops/dropout.FastDropout`` in the compute dtype, drawn from the
    generator passed to ``forward``. ``nn.GRU``'s own dropout draws from
    torch's global generator and cuDNN's multi-layer call takes no outside
    mask, so a training forward with ``dropout > 0`` runs the layers one
    call each: a one-layer bidirectional ``nn.GRU`` per layer, fed that
    layer's weights through ``torch.func.functional_call``. The parameters
    stay those of ``self.gru`` (``weight_ih_l0``, …); without dropout, or
    in eval mode, one call of ``self.gru`` runs them all."""

    def __init__(self, n_in: int, n_hidden: int, num_layers: int = 2,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None,
                 cast_weights: bool = True):
        super().__init__()
        self.gru = nn.GRU(n_in, n_hidden, num_layers=num_layers,
                          batch_first=True, bidirectional=True)
        self.dtype = dtype or torch.float32
        if dtype is not None and cast_weights:
            self.gru.to(dtype)
        self.dropout = FastDropout(dropout if num_layers > 1 else 0.0)
        # the one-layer GRUs of a training forward with dropout: templates
        # whose weights functional_call replaces, kept out of the module's
        # parameters
        self._layers = tuple(
            _template_gru(n_in if i == 0 else 2 * n_hidden, n_hidden)
            for i in range(num_layers)) if self.dropout.rate > 0 else ()

    def forward(self, x, gen: Optional[torch.Generator] = None):
        x = x.to(self.dtype)
        cast = any(p.dtype != self.dtype for p in self.gru.parameters())
        params = {n: p.to(self.dtype) for n, p in self.gru.named_parameters()}
        with warnings.catch_warnings():
            # cast or per-layer weights are separate tensors, so cuDNN
            # compacts them into one buffer per call and says so every time
            warnings.filterwarnings("ignore", message=".*contiguous "
                                    "chunk of memory.*")
            if not (self.training and self._layers):
                out = (torch.func.functional_call(self.gru, params, (x,))
                       if cast else self.gru(x))
                return out[0].float()
            for i, layer in enumerate(self._layers):
                if i:
                    x = self.dropout(x, gen)
                own = {n.replace(f"_l{i}", "_l0"): p
                       for n, p in params.items()
                       if n.endswith((f"_l{i}", f"_l{i}_reverse"))}
                x = torch.func.functional_call(layer, own, (x,))[0]
        return x.float()


def bigru_hoisted(rnn: BidirectionalGRU, x: torch.Tensor) -> torch.Tensor:
    """Eval forward of ``rnn`` in ``bsed_tpu``'s hoisted form
    (rnn.py:84-111), written as the JAX module writes it: per layer and
    direction one (B·T, D) @ (D, 3H) projection plus b_ih in the module's
    dtype, then the recurrence of both directions on the stacked, flipped
    projections (``gru_kernel.gru_bidir_recurrence``: kernel K4 or its
    plain version, as ``kernels.launches_on`` decides). Reads the weights
    of ``rnn.gru`` (torch names and gate order) on every call; no
    inter-layer dropout. (B, T, n_in) → (B, T, 2H) float32."""
    gru, cd = rnn.gru, rnn.dtype
    out = x.to(cd)
    for layer in range(gru.num_layers):
        xps, w_hh, b_hh = [], [], []
        for suffix in ("", "_reverse"):
            name = f"l{layer}{suffix}"
            w_ih = getattr(gru, f"weight_ih_{name}").to(cd)
            b_ih = getattr(gru, f"bias_ih_{name}").to(cd)
            xps.append(out @ w_ih.T + b_ih)
            w_hh.append(getattr(gru, f"weight_hh_{name}"))
            b_hh.append(getattr(gru, f"bias_hh_{name}"))
        xp2 = torch.stack([xps[0], xps[1].flip(1)])
        ys2 = gru_kernel.gru_bidir_recurrence(xp2, torch.stack(w_hh),
                                              torch.stack(b_hh))
        out = torch.cat([ys2[0], ys2[1].flip(1)], dim=-1)
    return out.float()


class HoistedBiGRU:
    """The eval BiGRU of ``rnn`` in ``bsed_tpu``'s hoisted form, with its
    weights laid out once: per layer W_ih of both directions as one
    (D, 6H) matrix and b_ih as one (6H,) vector in the module's dtype, and
    W_hh, b_hh in K4's layout (``gru_kernel.prepare_weights``). A call
    makes one projection a layer, stacks the directions (the reverse one
    flipped in time), runs their recurrences in one call of
    ``gru_kernel.recurrence`` (bound here; K4 or its plain version, as
    ``kernels.launches_on`` decides), and concatenates them back. No inter-layer dropout (eval).
    (B, T, n_in) → (B, T, 2H) float32, equal to ``bigru_hoisted``."""

    def __init__(self, rnn: BidirectionalGRU):
        gru, cd = rnn.gru, rnn.dtype
        self.dtype = cd
        self.recurrence = gru_kernel.recurrence
        self.layers = []
        with torch.no_grad():
            for layer in range(gru.num_layers):
                names = (f"l{layer}", f"l{layer}_reverse")
                get = lambda kind: [getattr(gru, f"{kind}_{n}")  # noqa: E731
                                    for n in names]
                w_ih = torch.cat(get("weight_ih")).to(cd).T.contiguous()
                b_ih = torch.cat(get("bias_ih")).to(cd)
                self.layers.append((w_ih, b_ih, gru_kernel.prepare_weights(
                    torch.stack(get("weight_hh")),
                    torch.stack(get("bias_hh")), cd)))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        out = x.to(self.dtype)
        for w_ih, b_ih, w_hh in self.layers:
            xp = out @ w_ih + b_ih                       # (B, T, 6H)
            g3 = xp.shape[-1] // 2
            xp2 = torch.stack([xp[..., :g3], xp[..., g3:].flip(1)])
            ys2 = self.recurrence(xp2, w_hh)
            out = torch.cat([ys2[0], ys2[1].flip(1)], dim=-1)
        return out.float()
