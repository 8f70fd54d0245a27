"""Bidirectional multi-layer GRU. Port of
``bsed_tpu/models/rnn.py:BidirectionalGRU`` (reference RNN.py:7-16).

The JAX module's gate order (r, z, n) with the recurrent bias inside the
reset gate ("linear before reset") is exactly ``torch.nn.GRU``'s, and its
parameter names (``weight_ih_l0``, ``bias_hh_l1_reverse``, …) are
torch's, so the module is an ``nn.GRU``. The JAX package runs this
recurrence in XLA (``lax.scan``), so cuDNN runs it here. Dtype handling
follows rnn.py:83-111: the input, the projection and the carry are in the
compute dtype; the output is cast to float32.

``HoistedBiGRU`` is the JAX module's own form of the same network, and
the form the port serves (``serve.make_fast_forward``): one
input-projection matmul per layer for both directions, then both
directions' recurrences in one walk over time on kernel K4
(``ops/gru_kernel.py``, the port of the Pallas drop-in for
``_gru_scan_bidir``) or on K4's plain version; its weights are laid out
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


class BidirectionalGRU(nn.Module):
    """(B, T, n_in) → (B, T, 2·n_hidden) float32."""

    def __init__(self, n_in: int, n_hidden: int, num_layers: int = 2,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None,
                 cast_weights: bool = True):
        super().__init__()
        self.gru = nn.GRU(n_in, n_hidden, num_layers=num_layers,
                          batch_first=True, bidirectional=True,
                          dropout=dropout if num_layers > 1 else 0.0)
        self.dtype = dtype or torch.float32
        if dtype is not None and cast_weights:
            self.gru.to(dtype)

    def forward(self, x):
        if self.training and self.gru.dropout > 0:
            raise NotImplementedError(
                "inter-layer GRU dropout in training draws from torch's "
                "global generator; the port's train step does not take it "
                "(model.dropout_recurrent must be 0)")
        x = x.to(self.dtype)
        params = dict(self.gru.named_parameters())
        if all(p.dtype == self.dtype for p in params.values()):
            out, _ = self.gru(x)
        else:
            cast = {n: p.to(self.dtype) for n, p in params.items()}
            with warnings.catch_warnings():
                # the cast weights are separate tensors, so cuDNN compacts
                # them into one buffer per call and says so every time
                warnings.filterwarnings("ignore", message=".*contiguous "
                                        "chunk of memory.*")
                out, _ = torch.func.functional_call(self.gru, cast, (x,))
        return out.float()


def bigru_hoisted(rnn: BidirectionalGRU, x: torch.Tensor,
                  use_kernel: bool = True) -> torch.Tensor:
    """Eval forward of ``rnn`` in ``bsed_tpu``'s hoisted form
    (rnn.py:84-111), written as the JAX module writes it: per layer and
    direction one (B·T, D) @ (D, 3H) projection plus b_ih in the module's
    dtype, then the recurrence of both directions on the stacked, flipped
    projections — kernel K4 (``gru_kernel.gru_bidir_recurrence``) or, with
    ``use_kernel=False``, its plain version. Reads the weights of
    ``rnn.gru`` (torch names and gate order) on every call; no inter-layer
    dropout. (B, T, n_in) → (B, T, 2H) float32."""
    recurrence = (gru_kernel.gru_bidir_recurrence if use_kernel
                  else gru_kernel.gru_bidir_recurrence_plain)
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
        ys2 = recurrence(xp2, torch.stack(w_hh), torch.stack(b_hh))
        out = torch.cat([ys2[0], ys2[1].flip(1)], dim=-1)
    return out.float()


class HoistedBiGRU:
    """The eval BiGRU of ``rnn`` in ``bsed_tpu``'s hoisted form, with its
    weights laid out once: per layer W_ih of both directions as one
    (D, 6H) matrix and b_ih as one (6H,) vector in the module's dtype, and
    W_hh, b_hh in K4's layout (``gru_kernel.prepare_weights``). A call
    makes one projection a layer, stacks the directions (the reverse one
    flipped in time), runs their recurrences in one call of K4
    (``gru_kernel.recurrence``) or, with ``use_kernel=False``, of its plain
    version, and concatenates them back. No inter-layer dropout (eval).
    (B, T, n_in) → (B, T, 2H) float32, equal to ``bigru_hoisted``."""

    def __init__(self, rnn: BidirectionalGRU, use_kernel: bool = True):
        gru, cd = rnn.gru, rnn.dtype
        self.dtype = cd
        self.recurrence = (gru_kernel.recurrence if use_kernel
                           else gru_kernel.recurrence_plain)
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
