"""Domain-adaptation losses: DANN, CDAN (clip), frame-CDAN, ADDA. Port of
``bsed_tpu/train/da.py`` (reference src/DA/dan.py, cdan.py,
cdan_frame.py and main_scmt.py:312-369; that module's docstrings carry
the file:line trail of each flavour):

  * ``dann_loss``: BCE of the discriminator on gradient-reversed features,
    source 1 / target 0;
  * ``cdan_loss``: CDAN with the multilinear, or randomized multilinear,
    map of features × detached softmaxed predictions, optionally with
    entropy weights w = 1 + e^(−H(g)) (normalised to sum to the batch);
  * ``cdan_frame_loss``: the frame-CDAN variant as the reference wires it:
    the discriminator sees the gradient-reversed (B, T, C) features only,
    and the clip labels broadcast over its frame axis;
  * ``adda_discriminator_loss`` / ``adda_confusion_loss``: the alternating
    updates' two losses on precomputed discriminator outputs.

``disc_apply`` is any callable that applies the discriminator (the train
step passes one that threads its BatchNorm statistics in call order).

``group`` (a ``parallel.mesh.DataGroup``; None: this process alone): the
inputs are this rank's rows (``rank · b`` onwards of every stream of ``b``
local rows), each loss is this rank's share of the global batch's loss
(``losses.bce``'s ``total``), CDAN's entropy weights are normalised by the
global batch, and ADDA's choice holds global row numbers.

The random matrices (R_f, R_g) of the randomized map: ``bsed_tpu`` draws
them with ``jax.random.normal`` from ``cfg.train.seed``, which this package
cannot reproduce without JAX. ``make_randomized_maps`` draws its own
standard normal pair from a CPU ``torch.Generator`` seeded by the same
seed, in chunks copied to the device that will use them, so the pair does
not depend on the device (at full width R_f is (80128, 8192) float32,
2.63 GB); the tests inject JAX's pair through
``train.steps.TrainModules.rand_maps``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from bsed_tpu_torch.ops.grl import grad_reverse
from bsed_tpu_torch.parallel.mesh import group_sum
from bsed_tpu_torch.train.losses import bce, entropy


def multilinear_map(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """T(f, g) = flatten(g ⊗ f): (B, F), (B, C) → (B, C·F)."""
    return torch.einsum("bc,bf->bcf", g, f).reshape(f.shape[0], -1)


MAP_CHUNK_ELEMENTS = 1 << 24     # 64 MiB of float32 a drawn chunk


def make_randomized_maps(features_dim: int, num_classes: int,
                         output_dim: int, seed: int = 0, device="cpu"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R_f (features_dim, output_dim), R_g (num_classes, output_dim)),
    standard normal float32 on ``device``, drawn from one CPU generator
    seeded by ``seed`` whatever the device, so a run keeps its maps when
    it moves between the CPU and the card. R_f is drawn in chunks of
    rows (``MAP_CHUNK_ELEMENTS``), each copied into R_f on ``device`` as
    it is drawn, so the host never holds the whole map; R_g is drawn
    after it."""
    device = torch.device(device)
    gen = torch.Generator().manual_seed(seed)
    rf = torch.empty((features_dim, output_dim), device=device)
    rows = max(1, MAP_CHUNK_ELEMENTS // max(output_dim, 1))
    for start in range(0, features_dim, rows):
        n = min(rows, features_dim - start)
        rf[start:start + n].copy_(torch.randn((n, output_dim),
                                              generator=gen))
    rg = torch.randn((num_classes, output_dim), generator=gen).to(device)
    return rf, rg


def randomized_multilinear_map(f: torch.Tensor, g: torch.Tensor,
                               rf: torch.Tensor,
                               rg: torch.Tensor) -> torch.Tensor:
    """(R_f f) ⊙ (R_g g) / sqrt(d)   (cdan.py:129-133)."""
    return (f @ rf) * (g @ rg) / math.sqrt(float(rf.shape[1]))


def _f32(x: torch.Tensor) -> torch.Tensor:
    """jnp's promotion of an activation against float32 operands."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _total(d: torch.Tensor, global_rows: int) -> int:
    """The element count of ``d``'s global tensor of ``global_rows``
    rows."""
    return global_rows * math.prod(d.shape[1:])


def _rows(x: torch.Tensor, group) -> int:
    """The global rows of a tensor whose local rows are this rank's part
    of every stream it concatenates."""
    return x.shape[0] * (group.size if group is not None else 1)


def dann_loss(disc_apply: Callable, f_s: torch.Tensor, f_t: torch.Tensor,
              grl_coeff=1.0, group=None) -> torch.Tensor:
    """Plain DANN over flattened features; source label 1, target 0."""
    f = torch.cat([f_s, f_t], dim=0)
    d = disc_apply(grad_reverse(f, grl_coeff))
    labels = torch.cat([
        torch.ones((f_s.shape[0],) + d.shape[1:], dtype=d.dtype,
                   device=d.device),
        torch.zeros((f_t.shape[0],) + d.shape[1:], dtype=d.dtype,
                    device=d.device)], dim=0)
    return bce(d, labels, total=_total(d, _rows(f, group)))


def cdan_loss(disc_apply: Callable, g_s, f_s, g_t, f_t,
              rf: Optional[torch.Tensor] = None,
              rg: Optional[torch.Tensor] = None,
              entropy_conditioning: bool = False,
              grl_coeff=1.0, group=None) -> torch.Tensor:
    """CDAN with multilinear conditioning (cdan.py:89-103). g_* are raw
    predictions, softmaxed and detached here (:92)."""
    f = _f32(torch.cat([f_s, f_t], dim=0))
    g = torch.softmax(torch.cat([g_s, g_t], dim=0), dim=1).detach()
    if rf is not None:
        h = randomized_multilinear_map(f, g, rf, rg)
    else:
        h = multilinear_map(f, g)
    d = disc_apply(grad_reverse(h, grl_coeff))
    labels = torch.cat([
        torch.ones((g_s.shape[0], 1), dtype=d.dtype, device=d.device),
        torch.zeros((g_t.shape[0], 1), dtype=d.dtype, device=d.device)],
        dim=0)
    rows = _rows(f, group)
    w = None
    if entropy_conditioning:
        w = 1.0 + torch.exp(-entropy(g))
        w_sum = torch.sum(w)
        if group is not None:
            w_sum = group_sum(w_sum, group)
        w = (w / w_sum * rows).reshape(d.shape)
    return bce(d, labels, weight=w, total=_total(d, rows))


def cdan_frame_loss(disc_apply: Callable, g_s, f_s, g_t, f_t,
                    grl_coeff=1.0, group=None) -> torch.Tensor:
    """Frame-CDAN as the reference wires it (cdan_frame.py:89-119): the
    multilinear conditioning is computed and discarded there, so the
    discriminator sees only the gradient-reversed features; the domain
    labels broadcast over its frame axis."""
    f = torch.cat([f_s, f_t], dim=0)
    d = disc_apply(grad_reverse(f, grl_coeff)).squeeze(-1)
    labels = torch.cat([
        torch.ones((g_s.shape[0],), dtype=d.dtype, device=d.device),
        torch.zeros((g_t.shape[0],), dtype=d.dtype, device=d.device)],
        dim=0)
    labels = labels.reshape((-1,) + (1,) * (d.ndim - 1))
    return bce(d, labels.expand(d.shape), total=_total(d, _rows(f, group)))


def take_rows(d: torch.Tensor, choice: torch.Tensor, group=None):
    """(``d[choice]`` as JAX's gather computes it, the rows' weight). An
    index past d's rows: the forward clamps it to the last row, and the
    gradient of such a row is dropped (XLA's scatter skips out-of-range
    updates); origin's choice is drawn over its combined real batch, which
    may have more rows than the syn stream it also indexes. Under a group
    ``d`` holds this rank's rows and ``choice`` global row numbers: a
    chosen row that another rank holds comes out as some row of ``d`` with
    weight 0, so a loss weighted by it is this rank's share (no row count
    that depends on the draw, hence no wait for the card)."""
    b = d.shape[0]
    n = _rows(d, group)
    off = group.rank * b if group is not None else 0
    c = choice.clamp(max=n - 1)
    shape = (-1,) + (1,) * (d.ndim - 1)
    past = (choice >= n).reshape(shape)
    mine = ((c >= off) & (c < off + b)).reshape(shape)
    rows = d[(c - off).clamp(0, b - 1)]
    return torch.where(past, rows.detach(), rows), mine.to(d.dtype)


def _unit_labels(d: torch.Tensor, unit: int) -> torch.Tensor:
    labels = torch.zeros_like(d)
    labels[..., unit] = 1.0
    return labels


def adda_discriminator_loss(d_real: torch.Tensor, d_syn: torch.Tensor,
                            choice: torch.Tensor, adv_weight: float = 2.5,
                            disc_labels: str = "split",
                            group=None) -> torch.Tensor:
    """The discriminator update on outputs of detached features:
    ``cat(d_real[choice], d_syn[choice])`` against the lineage's domain
    labels, × adv_weight. "split": real → unit 1, syn → unit 0;
    "all_target": every row unit 1 (main_scmt.py:276-278)."""
    real, w_real = take_rows(d_real, choice, group)
    syn, w_syn = take_rows(d_syn, choice, group)
    d = torch.cat([real, syn], dim=0)
    if disc_labels == "all_target":
        labels = _unit_labels(d, 1)
    else:
        labels = torch.cat([_unit_labels(real, 1), _unit_labels(syn, 0)],
                           dim=0)
    return adv_weight * bce(d, labels, weight=torch.cat([w_real, w_syn]),
                            total=_total(d, 2 * choice.numel()))


def adda_confusion_loss(d_conf: torch.Tensor,
                        choice: Optional[torch.Tensor],
                        adv_weight: float = 2.5,
                        flipped: bool = False, group=None) -> torch.Tensor:
    """The feature extractor's confusion step on a non-detached
    discriminator output: the rows of ``choice`` (all rows when None)
    against unit 0 ("source"), or unit 1 when ``flipped``."""
    if choice is None:
        d, w, rows = d_conf, None, _rows(d_conf, group)
    else:
        (d, w), rows = take_rows(d_conf, choice, group), choice.numel()
    return adv_weight * bce(d, _unit_labels(d, 1 if flipped else 0),
                            weight=w, total=_total(d, rows))
