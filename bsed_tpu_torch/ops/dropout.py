"""Inverted dropout from uint8 bits. Port of ``bsed_tpu/ops/dropout.py``.

When the keep probability is k/256 (every dropout of the model family is
0.5 = 128/256), one uint8 draw per element is an exact Bernoulli(k/256)
sample as ``bits < k``. Rates off the 1/256 grid draw a float32 uniform.
Every draw comes from the caller's ``torch.Generator``, on the tensor's
device, so a step seeded the same way drops the same elements. The bits
are drawn apart from where they are used: the fused stem epilogue (kernel
K2 and its plain version) takes them as an input.

In a data-parallel step each rank holds some rows of the global batch,
and ``bsed_tpu`` draws every mask with the global batch's shape; a
``RowGenerator`` carries where this rank's rows sit, so a draw makes the
global batch's bits and keeps this rank's rows. Drawing only the local
shape would not do: a card's generator gives an element a value that
depends on the shape of the whole draw.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn


def _u8_threshold(keep_prob: float) -> Optional[int]:
    """k if keep_prob == k/256 exactly (1 ≤ k ≤ 255), else None."""
    t = keep_prob * 256.0
    k = int(round(t))
    if abs(t - k) < 1e-9 and 1 <= k <= 255:
        return k
    return None


class RowGenerator:
    """A generator with the rows of the forward it draws for: row ``i`` of
    a local batch is row ``index[i]`` of a global batch of ``rows`` rows
    (``index`` a long tensor on the generator's device)."""

    def __init__(self, generator: torch.Generator, index: torch.Tensor,
                 rows: int):
        self.generator, self.index, self.rows = generator, index, rows

    @property
    def device(self) -> torch.device:
        return self.generator.device


def row_generator(gen: torch.Generator, spans, rows: int):
    """The generator of a forward whose local rows are the ``spans``
    ((lo, hi) row ranges, in order) of a global batch of ``rows`` rows: a
    ``RowGenerator``, or ``gen`` itself when the spans cover every row (a
    single rank's forward draws its own shape)."""
    spans = list(spans)
    if sum(hi - lo for lo, hi in spans) == rows:
        return gen
    return RowGenerator(gen, torch.cat([
        torch.arange(lo, hi, device=gen.device) for lo, hi in spans]), rows)


def draw(gen, shape, fn):
    """``fn(generator, shape)``; under a ``RowGenerator`` the global
    batch's draw, cut to this rank's rows."""
    shape = tuple(shape)
    if not isinstance(gen, RowGenerator):
        return fn(gen, shape)
    if shape[0] != gen.index.numel():
        raise ValueError(f"a draw of {shape[0]} rows under a RowGenerator "
                         f"of {gen.index.numel()}")
    return fn(gen.generator, (gen.rows,) + shape[1:]).index_select(
        0, gen.index)


def draw_bits(gen: torch.Generator, shape, device) -> torch.Tensor:
    """uint8 bits, uniform over 0..255, from ``gen``."""
    return draw(gen, shape, lambda g, s: torch.randint(
        0, 256, s, generator=g, device=device, dtype=torch.uint8))


def keep_mask(gen: torch.Generator, shape, rate: float,
              device) -> torch.Tensor:
    """Boolean keep mask, P(keep) = 1 − rate, iid."""
    keep_prob = 1.0 - rate
    k = _u8_threshold(keep_prob)
    if k is not None:
        return draw_bits(gen, shape, device) < k
    return draw(gen, shape, lambda g, s: torch.rand(
        s, generator=g, device=device)) < keep_prob


def dropout(gen: Optional[torch.Generator], x: torch.Tensor, rate: float,
            deterministic: bool = False,
            keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout: keep → x/(1−rate), drop → 0 (torch semantics).
    ``keep`` replaces the mask's draw (tests feed the JAX mask through
    it)."""
    if deterministic or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if keep is None:
        if gen is None:
            raise ValueError("dropout needs a torch.Generator")
        keep = keep_mask(gen, x.shape, rate, x.device)
    scale = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


class FastDropout(nn.Module):
    """Dropout through ``dropout``: active in training mode, drawing from
    the generator passed to ``forward``."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                gen: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        return dropout(gen, x, self.rate, deterministic=not self.training,
                       keep=keep)
