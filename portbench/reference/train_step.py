"""Plain reference of the mean-teacher + ISP train step, float32.

The step of the reference recipe's ``main_baseline.py`` (mean teacher,
interpolation-shift consistency in its 'baseline' wiring, Adam, the
state-dict EMA), written from its definitions on flax-layout weight trees
(``harness/weights.py``):

* inputs: linear mel → dB (``amplitude_to_db``, top_db 80 a clip); the
  teacher's input gets Gaussian noise at the recipe's SNR first, its std
  per frequency bin over time;
* ISP: one (pooled-frame, frequency) shift a syn row, shared with the
  real rows of the same index; inputs rolled by 4× the pooled shift in
  time, by the frequency shift in frequency, targets by the pooled shift;
* the model in training mode: BatchNorm on the batch's statistics,
  dropout after every conv block's GLU and after each BiGRU;
* the loss: BCE of the syn stream's strong and weak posteriors, of the
  real stream's weak ones, of the shifted and frequency-shifted syn
  forwards, of the labelled real half's frequency-shifted weak ones; the
  consistencies (MSE) with the teacher, between each stream's shifted
  forward and its own rolled prediction (× cost/2), and of the real
  stream's shifted forwards with the teacher's (× cost/2);
* BatchNorm's running statistics: every training forward, the
  teacher's too, moves them to 0.01·running + 0.99·batch (the recipe's
  ``nn.BatchNorm2d(momentum=0.99)``), the variance unbiased;
* Adam (β 0.9, 0.999, ε 1e-8), then the teacher ← a·teacher +
  (1−a)·student, a = min(1 − 1/(step+1), α), its running statistics
  too where the recipe's EMA takes the whole state dict.

The step's draws are made again from the seed the way the port draws
them, in the same order: one ``torch.Generator`` on the device a step,
seeded from (seed, step) by numpy's SeedSequence; the noise, the two
shift vectors, then every forward's dropout bits block by block (uint8,
keep where < 256·(1−rate)). Where the port runs the leading conv blocks
on its folded layout (``folded``: mel bins packed 8 to a lane group),
their bits are drawn in that layout, (B, T·G, fold·C), and read here at
(B, T, G·fold, C). ``fused``: the teacher's three forwards and the
student's six run as one batch each, BatchNorm's statistics pooled over
them. Imports nothing of the program.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.frontend import to_db
from portbench.reference.quant import identity

Q = Callable[[torch.Tensor], torch.Tensor]
BN_EPS = 1e-3
BN_MOMENTUM = 0.99          # torch's convention: the batch's weight


def step_generator(seed: int, step: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence((seed, step))
                        .generate_state(1)[0]))
    return gen


def roll(x: torch.Tensor, shifts: torch.Tensor, axis: int) -> torch.Tensor:
    """Per-row circular shift: out[b, ..., i] = x[b, ..., i − s_b]."""
    return torch.stack([torch.roll(x[b], int(s), dims=axis - 1)
                        for b, s in enumerate(shifts.tolist())])


class Masks:
    """Dropout keep masks drawn from ``gen`` in the port's order."""

    def __init__(self, gen: torch.Generator, rate: float,
                 folded_blocks: int):
        self.gen, self.k = gen, int(round(256 * (1.0 - rate)))
        self.folded_blocks = folded_blocks

    def bits(self, shape) -> torch.Tensor:
        return torch.randint(0, 256, tuple(shape), generator=self.gen,
                             device=self.gen.device, dtype=torch.uint8)

    def block(self, i: int, shape, fold: int) -> torch.Tensor:
        """Keep mask of conv block ``i``'s (B, T, F, C) activation."""
        b, t, f, c = shape
        if i < self.folded_blocks:
            g = f // fold
            return (self.bits((b, t * g, fold * c)) < self.k).reshape(
                b, t, g, fold, c).reshape(b, t, f, c)
        return self.bits(shape) < self.k

    def plain(self, shape) -> torch.Tensor:
        return self.bits(shape) < self.k


def _drop(x, keep, rate):
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def conv_block(x, p, pool, masks: Optional[Masks], i: int, fold: int,
               rate: float, q: Q, record: Optional[list] = None,
               name: str = "") -> torch.Tensor:
    """conv → BatchNorm (batch statistics) → GLU → dropout → pool; ``q``
    rounds every product's operands and every activation the block
    stores, as a lower-precision path holds them. ``record`` (a list)
    gains (``name``, mean, biased variance, count) of the batch."""
    w = p["conv"]["kernel"].permute(3, 2, 0, 1)
    y = q(F.conv2d(q(x.permute(0, 3, 1, 2)), q(w), p["conv"]["bias"],
                   padding=1).permute(0, 2, 3, 1))
    mean = y.mean(dim=(0, 1, 2))
    var = (y * y).mean(dim=(0, 1, 2)) - mean * mean
    if record is not None:
        record.append((name, mean.detach(), var.detach(),
                       y.numel() // y.shape[-1]))
    y = q((y - mean) * (p["bn"]["scale"] * torch.rsqrt(var + BN_EPS))
          + p["bn"]["bias"])
    g = p["GLU_0"]["linear"]
    y = q((q(y) @ q(g["kernel"]) + g["bias"]) * torch.sigmoid(y))
    if masks is not None:
        y = _drop(y, masks.block(i, y.shape, fold), rate)
    pt, pf = pool
    if (pt, pf) != (1, 1):
        y = F.avg_pool2d(y.permute(0, 3, 1, 2), (pt, pf)).permute(0, 2, 3, 1)
    return q(y)


_GRUS: Dict[Tuple, nn.GRU] = {}


def bigru(x: torch.Tensor, p: Mapping, layers: int, q: Q) -> torch.Tensor:
    """The 2-layer bidirectional GRU (torch's equations) on the tree's
    weights, through a weightless ``nn.GRU`` template."""
    hid = p["weight_hh_l0"].shape[1]
    key = (x.shape[-1], hid, layers, str(x.device))
    if key not in _GRUS:
        _GRUS[key] = nn.GRU(x.shape[-1], hid, num_layers=layers,
                            batch_first=True, bidirectional=True
                            ).to(x.device)
        _GRUS[key].flatten_parameters = lambda: None
    weights = {k: q(v) for k, v in p.items()}
    return q(torch.func.functional_call(_GRUS[key], weights, (q(x),))[0])


def predictor(x, p):
    strong = torch.sigmoid(x @ p["dense"]["kernel"] + p["dense"]["bias"])
    sof = torch.softmax(x @ p["dense_softmax"]["kernel"]
                        + p["dense_softmax"]["bias"], dim=-1)
    sof = torch.clamp(sof, 1e-7, 1.0)
    return strong, (strong * sof).sum(dim=1) / sof.sum(dim=1)


def _folds(model, n_mels, fold0=8):
    """Each leading block's fold on the port's folded layout; 0 past the
    folded blocks."""
    out, f = [], fold0
    for _, pf in model["pooling"]:
        if f == 1:
            break
        out.append(f)
        f //= pf
    return out


def forward(x: torch.Tensor, params: Mapping, model: Mapping,
            masks: Masks, rate: float, q: Q = identity,
            record: Optional[list] = None):
    """Training-mode forward of the CRNN or CRNNFPN: (strong, weak);
    ``record`` gains each BatchNorm's batch statistics in call order."""
    enc = params["encoder"]
    folds = _folds(model, x.shape[2]) if masks.folded_blocks else []
    h = x[..., None]
    for i, pool in enumerate(model["pooling"]):
        fold = folds[i] if i < len(folds) else 1
        h = conv_block(h, enc["cnn"][f"block{i}"], pool, masks, i, fold,
                       rate, q, record, f"block{i}")
    layers = model["n_layers_rnn"]
    if not model["use_fpn"]:
        y = bigru(h.squeeze(2), enc["rnn"], layers, q)
        y = _drop(y, masks.plain(y.shape), rate)
        return predictor(y, params["predictor"])
    down = enc["cnn"]["block_down"]
    h2 = conv_block(h, down, (2, 1), masks, 99, 1, rate, q, record,
                    "block_down")
    h4 = conv_block(h2, down, (2, 1), masks, 99, 1, rate, q, record,
                    "block_down")
    ys = []
    for hh, name in ((h, "rnn"), (h2, "rnn_2"), (h4, "rnn_4")):
        y = bigru(hh.squeeze(2), enc[name], layers, q)
        ys.append(_drop(y, masks.plain(y.shape), rate))
    y, y2, y4 = ys

    def up(a, n):
        return F.interpolate(a.transpose(1, 2), size=n, mode="linear",
                             align_corners=True).transpose(1, 2)

    f2, f4 = enc["fuse_2"], enc["fuse_4"]
    y2 = q(q(torch.cat([y2, up(y4, y2.shape[1])], -1)) @ q(f2["kernel"])
           + f2["bias"])
    y = q(q(torch.cat([y, up(y2, y.shape[1])], -1)) @ q(f4["kernel"])
          + f4["bias"])
    return predictor(y, params["predictor"])


def bce(p, y):
    lp = torch.clamp(torch.log(torch.clamp(p, min=0.0) + 1e-45), min=-100.0)
    l1 = torch.clamp(torch.log(torch.clamp(1.0 - p, min=0.0) + 1e-45),
                     min=-100.0)
    return (-(y * lp + (1.0 - y) * l1)).mean()


def mse(a, b):
    return ((a - b) ** 2).mean()


def ramp(epoch: float, length: int) -> float:
    p = 1.0 - min(max(float(epoch), 0.0), float(length)) / length
    return float(np.exp(-12.5 * p * p))


def learning_rate(epoch: float, recipe: Mapping) -> float:
    lr = recipe["max_learning_rate"]
    if not recipe["adjust_lr"]:
        return lr
    lr *= ramp(epoch, recipe["rampdown_epochs"])
    if epoch > 100:
        lr *= 0.5 ** (1.0 + np.floor((epoch - 100.0) / 20.0))
    return lr


def loss_terms(params, teacher, batch, gen, model, recipe, fused: bool,
               q: Q = identity, records: Optional[Dict] = None
               ) -> Dict[str, torch.Tensor]:
    """The step's loss terms; gradients flow to ``params``' leaves.
    ``records`` ({"teacher": [], "student": []}) gain each forward's
    BatchNorm batch statistics in call order."""
    rate = model["dropout"]
    n_fold = len(_folds(model, batch["syn"].shape[2])) \
        if recipe["folded"] else 0
    syn_lin, real_lin = batch["syn"], batch["real"]
    syn_t, real_w = batch["syn_strong"], batch["real_weak"]
    cost = recipe["max_consistency_cost"] * ramp(batch["epoch"],
                                                 recipe["rampdown_epochs"])
    x_syn, x_real = to_db(syn_lin), to_db(real_lin)
    snr = recipe["noise_snr"]
    std = torch.sqrt(torch.mean(real_lin * real_lin * 10.0 ** (-snr / 10.0),
                                dim=-2, keepdim=True))
    noise = torch.randn(real_lin.shape, generator=gen, device=gen.device)
    x_t = to_db(real_lin + noise * std)
    n = syn_lin.shape[0]
    tmax, fmax = recipe["time_shift_max"], recipe["freq_shift_max"]
    pool_s = torch.randint(-tmax, tmax + 1, (n,), generator=gen,
                           device=gen.device)
    freq_s = torch.randint(-fmax, fmax + 1, (n,), generator=gen,
                           device=gen.device)
    ratio = int(np.prod([p[0] for p in model["pooling"]]))
    in_s = pool_s * ratio
    xs = {"syn": x_syn, "real": x_real,
          "real_shift": roll(x_real, in_s, 1),
          "real_freq": roll(x_real, freq_s, 2),
          "syn_shift": roll(x_syn, in_s, 1),
          "syn_freq": roll(x_syn, freq_s, 2)}
    t_in = [x_t, roll(x_t, in_s, 1), roll(x_t, freq_s, 2)]
    masks = Masks(gen, rate, n_fold)

    records = records if records is not None else {}

    def run(p, parts, rec):
        if fused:
            s, w = forward(torch.cat(parts), p, model, masks, rate, q, rec)
            return list(zip(s.split([len(a) for a in parts]),
                            w.split([len(a) for a in parts])))
        return [forward(a, p, model, masks, rate, q, rec) for a in parts]

    with torch.no_grad():
        (ts, tw), (ts_s, _), (ts_f, _) = run(teacher, t_in,
                                             records.get("teacher"))
    order = ["syn", "real", "real_shift", "real_freq", "syn_shift",
             "syn_freq"]
    out = dict(zip(order, run(params, [xs[k] for k in order],
                              records.get("student"))))
    (s_s, s_w), (r_s, r_w) = out["syn"], out["real"]
    syn_w = syn_t.amax(dim=1)
    half = real_w.shape[0] // 2
    terms = {
        "strong_class_loss": bce(s_s, syn_t),
        "weak_class_loss": bce(s_w, syn_w) + bce(r_w, real_w),
        "consistency_strong": cost * mse(r_s, ts),
        "consistency_weak": cost * mse(r_w, tw),
        "strong_shift_class_loss": bce(out["syn_shift"][0],
                                       roll(syn_t, pool_s, 1)),
        "strong_freq_shift_class_loss": bce(out["syn_freq"][0], syn_t),
        "weak_freq_shift_class_loss":
            bce(out["syn_freq"][1], syn_w)
            + bce(out["real_freq"][1][:half], real_w[:half]),
        "consistency_shift": cost / 2 * (
            mse(out["syn_shift"][0], roll(s_s.detach(), pool_s, 1))
            + mse(out["real_shift"][0], roll(r_s.detach(), pool_s, 1))),
        "consistency_strong_shift": cost * mse(out["real_shift"][0], ts_s),
        "consistency_strong_freq_shift": cost * mse(out["real_freq"][0],
                                                    ts_f),
    }
    loss = sum(v for k, v in terms.items()
               if k not in ("consistency_strong_shift",
                            "consistency_strong_freq_shift"))
    terms["loss"] = loss + 0.5 * (terms["consistency_strong_shift"]
                                  + terms["consistency_strong_freq_shift"])
    return terms


def _leaves(tree, prefix=()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _clone(tree):
    if isinstance(tree, Mapping):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


class RefState:
    """Student, teacher, their BatchNorm running statistics and Adam's
    moments as flax-layout trees."""

    def __init__(self, params, teacher, stats, teacher_stats):
        self.params, self.teacher = _clone(params), _clone(teacher)
        self.stats, self.teacher_stats = (_clone(stats),
                                          _clone(teacher_stats))
        self.m = {p: torch.zeros_like(v) for p, v in _leaves(self.params)}
        self.v = {p: torch.zeros_like(v) for p, v in _leaves(self.params)}
        self.step = 0


def train_step(state: RefState, batch, seed: int, model, recipe,
               fused: bool, q: Q = identity):
    """One step in place on ``state``; returns (loss terms as floats,
    the gradient a leaf)."""
    gen = step_generator(seed, state.step, batch["syn"].device)
    for _, v in _leaves(state.params):
        v.requires_grad_(True)
        v.grad = None
    records = {"teacher": [], "student": []}
    terms = loss_terms(state.params, state.teacher, batch, gen, model,
                       recipe, fused, q, records)
    terms["loss"].backward()
    with torch.no_grad():
        for tree, rec in ((state.teacher_stats, records["teacher"]),
                          (state.stats, records["student"])):
            for name, mean, var, n in rec:
                bn = tree["encoder"]["cnn"][name]["bn"]
                bn["mean"].mul_(1 - BN_MOMENTUM).add_(mean,
                                                      alpha=BN_MOMENTUM)
                bn["var"].mul_(1 - BN_MOMENTUM).add_(
                    var * (n / (n - 1)), alpha=BN_MOMENTUM)
    lr = learning_rate(batch["epoch"], recipe)
    b1, b2, eps = 0.9, 0.999, 1e-8
    state.step += 1
    t = state.step
    grads = {}
    with torch.no_grad():
        for path, p in _leaves(state.params):
            g = p.grad
            grads[path] = g.detach().clone()
            m = state.m[path].mul_(b1).add_(g, alpha=1 - b1)
            v = state.v[path].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v / (1 - b2 ** t)).sqrt_().add_(eps)
            p.sub_(lr / (1 - b1 ** t) * m / denom)
            p.requires_grad_(False)
            p.grad = None
        a = min(1.0 - 1.0 / (t + 1.0), recipe["ema_alpha"])
        pairs = [(state.teacher, state.params)]
        if recipe["ema_scope"] == "state_dict":
            pairs.append((state.teacher_stats, state.stats))
        for ema, student in pairs:
            src = dict(_leaves(student))
            for path, e in _leaves(ema):
                e.copy_(a * e + (1.0 - a) * src[path])
    return {k: float(v.detach()) for k, v in terms.items()}, grads
