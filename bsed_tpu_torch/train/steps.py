"""The config-driven train step. Port of ``bsed_tpu/train/steps.py``:
every preset, in the ``pretrain`` stage and, with a discriminator, in the
``adaptation`` stage:

  * supervised BCE on the SYN strong+weak targets, with the real stream's
    weak term per ``TrainConfig.real_weak_bce``, or on the real stream
    (``supervise_on='real'``, the ENA upper bound);
  * the mean teacher: EMA twin, SNR noise on its linear-mel input, MSE
    consistency × the cost ramp (per-epoch sigmoid, or per-step
    ``exp_step``); the EMA over params and BatchNorm statistics, or over
    params only (``ema_scope='params'``);
  * ISP shift consistency in each lineage's wiring (flavours 'baseline',
    'scmt', 'scmt_ada', 'sct', and 'origin' with its masked combined
    batch), and ICT mixup (the masked 'origin' branch and the generic one);
  * dataset normalisation of the log-mel (``TrainConfig.normalize``);
  * Adam or SGD (``train/state.make_optimizer``);
  * domain adaptation in the ``adaptation`` stage (``train/da.py``,
    ``models/discriminators.py``): a GRL pre-step (DANN, CDAN, frame-CDAN:
    one backward through the gradient-reversed domain loss steps the
    encoder's aux optimizer and the discriminator's), the same losses
    added to the main loss × ``da.adv_weight`` with one backward for model
    and discriminator (``da.joint_backward``), or ADDA's alternating
    discriminator and confusion updates every ``da.update_step`` steps.

Forwards run in ``bsed_tpu``'s order, which fixes the order in which the
BatchNorm running statistics advance. The encoder is the folded train
stem (``ModelConfig.folded_train_stem``, the ``--perf`` form: epilogues on
kernels K2 and K3 on the card) or, by default, the unfolded CRNN / CRNNFPN
in float32 (the reference-parity form, no kernel).
``TrainConfig.fused_streams`` runs the same-shape teacher forwards and the
student forwards as one batched forward each (BatchNorm statistics pool
over the streams), otherwise they run one by one.

PyTorch idiom: the student and teacher are ``nn.Module``s and the step
updates them and the optimizer in place (``train/state.py``). Its
randomness — teacher noise, ISP shifts, dropout bits, mixup permutations —
comes from one ``torch.Generator`` per step, seeded from (seed, step) as
the JAX step folds the step count into its key, and mixup's λ from a
numpy generator seeded the same way; the draws differ from JAX's, so
parity tests inject them (ADDA's half-batch draws through
``sample_adda_choice``, the randomized map's matrices through
``TrainModules.rand_maps``).

Under a ``torch.profiler`` profile a step marks its phases as spans
(``utils/profiling.span``), one after the other: ``bsed.train.inputs``
(the batch to the device, the teacher's noise, the ISP shifts and
rolls), ``teacher`` (its forwards under ``no_grad``), ``student`` (the
student's forwards and every loss term), ``backward`` (with the
gradients' and the metrics' sums over the group), ``optimizer`` and
``ema``; the domain-adaptation updates before the main step lie in none.

Data parallelism (``TrainModules.group``, a ``parallel.mesh.DataGroup``):
each rank steps with its rows of every stream (``rank · b`` onwards) and
the step equals one step on the global batch, as ``bsed_tpu``'s SPMD step
does. BatchNorm statistics are the global batch's
(``models/layers.batch_stats``); every draw has the global batch's shape
and each rank keeps its rows (``ops/dropout.RowGenerator``); each loss term
is this rank's share of its global mean (``losses.bce``'s ``total``), the
positional slices of a stream (the labelled half, origin's quarters)
included; the inputs of a mixup, whose permutation crosses ranks, are
gathered, mixed on every rank alike, and the mixed batch's forward is
spread over the ranks again (``parallel.mesh.chunk_bounds``); the
gradients are summed over the group in one bucket before the optimizer,
so parameters, optimizer states and the EMA teacher stay replicated; the
metrics are summed too, so every rank returns the same values.

``make_epoch_runner`` runs an epoch of steps on loader arrays resident on
the device (the port of the JAX package's ``lax.scan`` over the epoch, as
a plain loop), and ``make_predict_fn`` is the port of the JAX package's
inference function; ``train/trainer.py`` drives both.

The 'crnn' predictor head (``models/crnn.EncodedCRNNPred``) carries
BatchNorm: every forward, those whose predictions are discarded included,
advances its running statistics, which the state keeps under
``batch_stats["predictor"]``. Recurrent dropout
(``ModelConfig.dropout_recurrent``) draws from the step's generator
(``models/rnn.BidirectionalGRU``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from bsed_tpu_torch.config import Config
from bsed_tpu_torch.models.crnn import compute_dtype, make_encoder
from bsed_tpu_torch.models.discriminators import (ClipDiscriminator,
                                                  ClipDiscriminatorSoftmax,
                                                  FrameDiscriminator,
                                                  FrameDiscriminatorGRL)
from bsed_tpu_torch.models.layers import ConvBlock, set_batchnorm_group
from bsed_tpu_torch.models.predictor import make_predictor_head
from bsed_tpu_torch.models.rnn import BidirectionalGRU
from bsed_tpu_torch.ops.augment import (gaussian_snr_noise, mixup,
                                        roll_batch, sample_isp_shifts)
from bsed_tpu_torch.ops.dropout import FastDropout, row_generator
from bsed_tpu_torch.ops.folded_stem import (folded_train_eligible,
                                            make_folded_train_stem)
from bsed_tpu_torch.ops.grl import warm_start_lambda
from bsed_tpu_torch.ops.mel import amplitude_to_db
from bsed_tpu_torch.parallel.mesh import (DataGroup, chunk_bounds,
                                          chunk_sizes, gather_rows, sum_)
from bsed_tpu_torch.train import da as da_losses
from bsed_tpu_torch.train.ema import ema_update
from bsed_tpu_torch.train.losses import bce, mse
from bsed_tpu_torch.train.ramps import exp_rampup, sigmoid_rampdown
from bsed_tpu_torch.train.schedule import learning_rate
from bsed_tpu_torch.train.state import TrainState, make_optimizer
from bsed_tpu_torch.utils import weights
from bsed_tpu_torch.utils.device import resolve_device
from bsed_tpu_torch.utils.profiling import span

_NOT_FOLDABLE = ("folded_train_stem=True but the topology is not foldable "
                 "(needs non-FPN, kernel 3, glu/cg/relu/leakyrelu "
                 "activation, n_mels divisible by 8, freq pooling dividing "
                 "the fold)")


class _FoldedRestCRNN(nn.Module):
    """Blocks ``start``..N-1, squeeze, BiGRU and post-RNN dropout: the tail
    of the folded-train-stem encoder."""

    def __init__(self, cfg_model, start: int):
        super().__init__()
        m = cfg_model
        dtype = compute_dtype(m)
        cins = (m.n_in_channel,) + tuple(m.nb_filters[:-1])
        self.blocks = nn.ModuleDict({
            f"block{i}": ConvBlock(cins[i], m.nb_filters[i],
                                   tuple(m.pooling[i]), m.activation,
                                   m.kernel_size, dtype=dtype,
                                   dropout=m.dropout)
            for i in range(start, len(m.nb_filters))})
        self.rnn = BidirectionalGRU(m.nb_filters[-1], m.n_rnn_cell,
                                    m.n_layers_rnn, m.dropout_recurrent,
                                    dtype=dtype, cast_weights=False)
        self.dropout = FastDropout(m.dropout)

    def forward(self, h, gen: Optional[torch.Generator] = None):
        for blk in self.blocks.values():
            h = blk(h, gen)
        h = h.float().squeeze(2)
        return self.dropout(self.rnn(h, gen), gen)


class FoldedEncoder(nn.Module):
    """The train-mode encoder with the folded-frequency stem (the port of
    ``make_folded_encoder_fwd``): blocks 0..n_folded-1 (``stem``,
    parameters only) run on the folded layout through
    ``make_folded_train_stem``, the rest through ``_FoldedRestCRNN``.
    ``forward(x (B, T, F, 1), gen) -> (B, T', 2H)``; BatchNorm uses batch
    statistics in training mode, running ones in eval mode."""

    def __init__(self, cfg: Config, device="cuda"):
        super().__init__()
        m = cfg.model
        if not folded_train_eligible(m, cfg.audio.n_mels):
            raise ValueError(_NOT_FOLDABLE)
        self.stem_apply, n_folded = make_folded_train_stem(
            m, cfg.audio.n_mels, device=device)
        dtype = compute_dtype(m)
        cins = (m.n_in_channel,) + tuple(m.nb_filters[:-1])
        self.stem = nn.ModuleDict({
            f"block{i}": ConvBlock(cins[i], m.nb_filters[i],
                                   tuple(m.pooling[i]), m.activation,
                                   m.kernel_size, dtype=dtype)
            for i in range(n_folded)})
        self.rest = _FoldedRestCRNN(m, n_folded)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        h = self.stem_apply(self.stem, x, self.training, gen)
        return self.rest(h, gen)


class TrainModel(nn.Module):
    """Encoder + predictor head: ``forward(x, gen) -> (strong, weak,
    encoded)``. The encoder is ``FoldedEncoder`` under
    ``ModelConfig.folded_train_stem``, else the unfolded ``CRNN`` or
    ``CRNNFPN`` with float32 master weights. The 'crnn' head takes the
    generator too: its convs drop out and its BatchNorm normalises by the
    batch (the data group's, under one), as the encoder's do."""

    def __init__(self, cfg: Config, device="cuda"):
        super().__init__()
        self.folded = cfg.model.folded_train_stem
        self.encoder = (FoldedEncoder(cfg, device)
                        if self.folded
                        else make_encoder(cfg.model, cast_weights=False))
        self.predictor = make_predictor_head(cfg)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        enc = self.encoder(x, gen)
        if not self.folded:
            enc = enc[0]
        strong, weak = self.predictor(enc, gen)
        return strong, weak, enc


def _effective_da_mode(cfg: Config) -> str:
    """DA is active only in the adaptation stage (the reference builds no
    discriminator in pretrain, main_baseline.py:789-799)."""
    return cfg.da.mode if cfg.train.stage == "adaptation" else "none"


def sample_adda_choice(gen: torch.Generator, batch_size: int
                       ) -> torch.Tensor:
    """The reference's ``np.random.choice(batch_size, batch_size//2,
    replace=False)`` half-batch subset (main_scmt.py:325) on the step's
    generator. Module-level so parity tests can replay the draws."""
    return torch.randperm(batch_size, generator=gen,
                          device=gen.device)[: batch_size // 2]


def _make_discriminator(cfg: Config) -> Optional[nn.Module]:
    """The discriminator of the DA mode and level
    (``bsed_tpu/train/steps.py:107-141``), sized for its input: the
    (B, T, 2H) encoding (frame flavours per frame, clip flavours as an
    image), the randomized CDAN map (B, randomized_dim) or DANN's
    flattened (B, T·2H)."""
    mode, level, da = _effective_da_mode(cfg), cfg.da.level, cfg.da
    enc_dim = 2 * cfg.model.n_rnn_cell
    if mode == "none":
        return None
    if mode == "adda":
        if level == "clip":
            # main_scmt.py's runnable adaptation (CRNN.py:16-51)
            return ClipDiscriminatorSoftmax()
        # scmt_ada_origin's CRNN_GRL flavour has no internal GRL; the
        # main.py lineage's reverses the confusion gradient at its input
        return FrameDiscriminatorGRL(
            enc_dim, da.disc_dropout, n_out=2,
            apply_grl=da.adda_confusion != "syn_flipped")
    if mode == "cdan_frame":
        return FrameDiscriminator(enc_dim, da.disc_dropout)
    if mode == "cdan":
        if level == "clip":
            return ClipDiscriminator()
        # 1 unit over the randomized map; the loss reverses the gradient
        return FrameDiscriminatorGRL(da.randomized_dim, da.disc_dropout,
                                     n_out=1, apply_grl=False)
    if mode == "dann":
        return FrameDiscriminatorGRL(cfg.n_frames * enc_dim,
                                     da.disc_dropout, n_out=1,
                                     apply_grl=False)
    raise ValueError(mode)


@dataclasses.dataclass
class TrainModules:
    """What the train step and the predict function build their models
    from. ``build_modules`` also checks that the train step supports the
    configuration; inference (``make_predict_fn``) needs no such check, so
    evaluation builds this directly. ``norm_stats``: the dataset's
    (mean, std) of the log-mel per mel bin, as (F,) arrays, or None.
    ``rand_maps``: frame-level CDAN's (R_f, R_g) on ``device``, or None.
    ``group``: the data-parallel group the step runs in (the models'
    BatchNorm then normalises by the group's global batch), or None."""
    cfg: Config
    device: torch.device
    norm_stats: Optional[tuple] = None
    rand_maps: Optional[tuple] = None
    group: Optional[DataGroup] = None

    def make_model(self) -> TrainModel:
        return set_batchnorm_group(
            TrainModel(self.cfg, self.device).to(self.device), self.group)

    def make_discriminator(self) -> Optional[nn.Module]:
        disc = _make_discriminator(self.cfg)
        return (set_batchnorm_group(disc.to(self.device), self.group)
                if disc is not None else None)


def _check_supported(cfg: Config) -> None:
    t, m = cfg.train, cfg.model
    mode = _effective_da_mode(cfg)
    if t.isp and t.isp_flavor == "origin" and cfg.da.joint_backward and \
            mode in ("dann", "cdan", "cdan_frame"):
        # the origin forward never computes the syn-stream predictions
        # the joint domain loss conditions on (its DA is ADDA, main.py)
        raise ValueError(
            "isp_flavor='origin' is incompatible with da.joint_backward "
            "GRL modes: the origin lineage uses alternating (ADDA-style) "
            "updates; set da.joint_backward=False or da.mode='adda'")
    if mode == "cdan" and cfg.da.level != "clip" and \
            cfg.da.randomized_dim <= 0:
        # the un-randomized map over flattened frame features would be
        # (2·n_rnn_cell·n_frames)·nclass ≈ 3.2 M dims
        raise ValueError(
            "frame-level CDAN requires da.randomized_dim > 0 (the "
            "full multilinear map over flattened frame features is "
            "infeasibly large; the reference always randomizes)")
    if m.folded_train_stem and not folded_train_eligible(m,
                                                         cfg.audio.n_mels):
        raise ValueError(_NOT_FOLDABLE)


def build_modules(cfg: Config, device="cuda", norm_stats=None,
                  rand_maps=None, group=None) -> TrainModules:
    """What the step needs to build its models on ``device``;
    ``norm_stats`` is the train scaler's (mean, std) for
    ``TrainConfig.normalize``. Frame-level CDAN's randomized map gets
    ``rand_maps`` if given (moved to ``device``), else its own pair drawn
    from ``cfg.train.seed`` (``train/da.make_randomized_maps``: the same
    pair on any device, hence on every rank of ``group``, the
    data-parallel group the step will run in)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    if _effective_da_mode(cfg) == "cdan" and cfg.da.level != "clip":
        if rand_maps is None:
            rand_maps = da_losses.make_randomized_maps(
                2 * cfg.model.n_rnn_cell * cfg.n_frames, cfg.nclass,
                cfg.da.randomized_dim, seed=cfg.train.seed, device=dev)
        rand_maps = tuple((r if torch.is_tensor(r) else
                           torch.from_numpy(np.array(r, np.float32)))
                          .to(dev) for r in rand_maps)
    else:
        rand_maps = None
    return TrainModules(cfg, dev, norm_stats, rand_maps, group)


def load_train_state(modules: TrainModules, trees: Dict) -> TrainState:
    """A train state from flax-layout trees (``utils/weights``): step,
    params, batch_stats, with a mean teacher ema_params and
    ema_batch_stats, and optionally the optimizer's state (Adam: mu, nu
    and their count; SGD: trace). In the adaptation stage the state also
    holds the discriminator and the aux optimizers (the family of
    ``da.aux_optimizer``, else the main one), loaded from the trees'
    ``disc_*`` and ``enc_opt_state`` where they hold them."""
    cfg = modules.cfg
    model = modules.make_model()
    teacher = None
    if cfg.train.mean_teacher:
        teacher = modules.make_model()
        for p in teacher.parameters():
            p.requires_grad_(False)
    opt = make_optimizer(cfg, model.parameters())
    state = TrainState(step=0, model=model, ema_model=teacher, optimizer=opt)
    disc = modules.make_discriminator()
    if disc is not None:
        family = cfg.da.aux_optimizer or None
        state.discriminator = disc
        state.disc_optimizer = make_optimizer(cfg, disc.parameters(), family)
        state.enc_optimizer = make_optimizer(cfg, model.encoder.parameters(),
                                             family)
    weights.load_train_state(state, trees)
    return state


def create_train_state(cfg: Config, modules: TrainModules,
                       seed: int = 0) -> TrainState:
    """Student and, with a mean teacher, teacher from their own random
    inits, drawn from ``seed`` (the teacher's init differs from the
    student's, as in the reference, main_baseline.py:817-818), and the
    discriminator's from a third draw; fresh optimizers. Every BatchNorm
    starts with running mean 0 and variance 1, as ``bsed_tpu``'s and the
    reference's do."""
    s_seed, t_seed, d_seed = (int(v) for v in
                              np.random.SeedSequence(seed).generate_state(3))
    params, stats = weights.init_params(cfg, s_seed, perturb_stats=False)
    ema_params = ema_stats = None
    if cfg.train.mean_teacher:
        ema_params, ema_stats = weights.init_params(cfg, t_seed,
                                                    perturb_stats=False)
    state = load_train_state(modules, {
        "step": 0, "params": params, "batch_stats": stats,
        "ema_params": ema_params, "ema_batch_stats": ema_stats})
    if state.discriminator is not None:
        weights.load_named(state.discriminator,
                           *weights.init_disc_params(state.discriminator,
                                                     d_seed))
    return state


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step, seeded from (seed, step)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence((seed, step))
                        .generate_state(1)[0]))
    return gen


def step_rng(seed: int, step: int) -> np.random.Generator:
    """The host generator of one step (mixup's λ), seeded from
    (seed, step)."""
    return np.random.default_rng(np.random.SeedSequence((seed, step, 1)))


def _log_input(linear_mel: torch.Tensor) -> torch.Tensor:
    """linear mel (B, T, F) → log-mel with channel axis (B, T, F, 1)."""
    return amplitude_to_db(linear_mel)[..., None]


def _split(out, sizes):
    """A batched forward's (strong, weak, enc) split back into streams."""
    cuts = [0] + list(itertools.accumulate(sizes))
    return [tuple(o[a:b] for o in out) for a, b in zip(cuts, cuts[1:])]


def make_train_step(modules: TrainModules,
                    steps_per_epoch: Optional[int] = None,
                    grad_flow: bool = False):
    """``step(state, batch, seed, epoch) -> metrics``: one optimizer step
    of the student, then the teacher's EMA, all in place on ``state``.

    ``batch``: ``syn`` (Bs, T, F) linear mel with ``syn_strong``
    (Bs, T', C) targets, and the real stream ``real`` (Br, T, F) with
    ``real_weak`` (Br, C) and, where the loader has them, ``real_strong``
    (Br, T', C); the first half of the real stream is the labelled weak
    half (the origin layout: ¼ weak, ½ unlabelled, ¼ strong rows, and no
    syn forward). ``epoch`` drives the lr and the sigmoid cost ramp. The
    metrics are the JAX step's names, as 0-d tensors on the device (lr
    and the cost as floats).

    ``steps_per_epoch`` (= len(loader)) sizes the ``exp_step`` cost ramp,
    exp_rampup(step, n_epoch_rampup · steps_per_epoch)
    (main_scmt.py:261,515); that ramp raises without it.
    ``grad_flow=True`` adds the mean |grad| of every non-bias parameter
    as ``grad_abs/<name>``, ``<name>`` being the parameter's flax path
    joined by dots, as the JAX step names them (the reference's
    plot_grad_flow diagnostic, main_baseline.py:108-123).

    In the adaptation stage the metrics add ``domain_loss``: the GRL
    pre-step's or ADDA's (0 on a step that skips ADDA's update), or the
    joint domain loss before its ``adv_weight``.

    Under ``modules.group`` the batch holds this rank's rows of every
    stream and the step is the global batch's (the module docstring)."""
    cfg = modules.cfg
    t, da = cfg.train, cfg.da
    dev = modules.device
    mean_teacher, isp, use_mixup = t.mean_teacher, t.isp, t.mixup
    da_mode = _effective_da_mode(cfg)
    joint_da = da.joint_backward and da_mode in ("dann", "cdan",
                                                 "cdan_frame")
    if t.cost_ramp == "exp_step" and steps_per_epoch is None:
        raise ValueError(
            "cfg.train.cost_ramp='exp_step' needs steps_per_epoch "
            "(= len(syn_loader)) to size the step-based exp_rampup — "
            "pass make_train_step(modules, steps_per_epoch=len(loader))")
    # scmt/scmt_ada: only the syn stream runs shifted through the student
    # (main_scmt.py:425-430)
    isp_syn_only = t.isp_flavor in ("scmt", "scmt_ada")
    # origin (main.py): the ISP and ICT wiring is masked over ONE combined
    # real batch — ¼ weak + ½ unlabeled-PL + ¼ strong rows — and the syn
    # stream is not forwarded; only the real batch is shifted, there are
    # no teacher shift forwards, and the three ICT mixups act on the row
    # slices
    origin_masks = isp and t.isp_flavor == "origin"
    nm = None
    if modules.norm_stats is not None:
        nm = tuple(torch.as_tensor(np.asarray(a, np.float32),
                                   device=dev)[:, None]
                   for a in modules.norm_stats)

    # a step without a group is the step of a group of one, whose
    # collectives are the identity (parallel/mesh.py)
    grp = modules.group or DataGroup.single(dev)

    def rows(x) -> int:
        """The global rows of a stream of which ``x`` holds this rank's."""
        return x.shape[0] * grp.size

    def mine(v, b: int):
        """This rank's ``b`` entries of a per-row vector of the global
        batch (ISP shifts)."""
        return v[grp.rank * b:(grp.rank + 1) * b]

    def fwd_gen(gen, *streams):
        """The generator of one forward over ``cat(streams)``, each a
        stream of which this rank holds its rows."""
        spans, at = [], 0
        for x in streams:
            b = x.shape[0]
            spans.append((at + grp.rank * b, at + (grp.rank + 1) * b))
            at += rows(x)
        return row_generator(gen, spans, at)

    def everyone(x):
        """Every rank's rows of a stream, in rank order (no gradient)."""
        return gather_rows(x, grp)

    def chunk(x_all):
        """This rank's rows of a tensor that every rank holds whole (a
        mixed batch), to forward spread over the group."""
        return x_all[chunk_bounds(len(x_all), grp)]

    def chunk_gen(gen, n: int):
        sl = chunk_bounds(n, grp)
        return row_generator(gen, [(sl.start, sl.stop)], n)

    def unchunk(x, n: int):
        """Every rank's chunk of an ``n``-row tensor, whole (no
        gradient)."""
        return gather_rows(x, grp, chunk_sizes(n, grp.size))

    def mean_of(loss, p, y, lo: int = 0, hi: Optional[int] = None,
                chunk_rows: Optional[int] = None):
        """This rank's share of ``loss``'s mean over the global rows
        [lo, hi) of ``p``'s stream (of the chunked ``chunk_rows``-row
        tensor: all of it); the shares of the group add up to the mean."""
        per_row = int(np.prod(p.shape[1:]))
        if chunk_rows is not None:
            return loss(p, y, total=chunk_rows * per_row)
        hi = rows(p) if hi is None else hi
        b = p.shape[0]
        a_, b_ = (min(max(v - grp.rank * b, 0), b) for v in (lo, hi))
        return loss(p[a_:b_], y[a_:b_], total=(hi - lo) * per_row)

    def reduce_grads(params):
        """Sum the gradients over the group (each rank's is its share's)."""
        sum_([q.grad for q in params if q.grad is not None], grp)

    def _inp(lin):
        """linear mel → log-mel (+ channel axis), then the dataset
        normalisation (after the log, before the ISP rolls, as the
        reference's transform order, main.py:203-218)."""
        x = _log_input(lin)
        if nm is not None:
            x = (x - nm[0]) / nm[1]
        return x

    def grl_coeff(step: int) -> float:
        return warm_start_lambda(step, da.grl_alpha, da.grl_lo, da.grl_hi,
                                 da.grl_max_iters)

    def grl_domain_loss(disc, gen, syn_s, syn_w, syn_f, r_s, r_w, r_f,
                        coeff):
        """The configured GRL domain loss (``_grl_domain_loss``, steps.py
        445-472). The live cdan/dann callers pass the WEAK predictions as
        g; the frame-CDAN flavour discards g, and the clip CDAN runs it on
        the full (B, T, C) encoding (main_scmt_ada_weak.py:331)."""
        d_gen = fwd_gen(gen, syn_f, r_f)

        def dapply(h):
            return disc(h, d_gen)
        if da_mode == "cdan_frame" or (da_mode == "cdan"
                                       and da.level == "clip"):
            return da_losses.cdan_frame_loss(dapply, syn_s, syn_f, r_s, r_f,
                                             coeff, group=grp)
        fs = syn_f.reshape(syn_f.shape[0], -1)
        ft = r_f.reshape(r_f.shape[0], -1)
        if da_mode == "cdan":
            rf, rg = modules.rand_maps
            return da_losses.cdan_loss(dapply, syn_w, fs, r_w, ft, rf, rg,
                                       da.entropy_conditioning, coeff,
                                       group=grp)
        return da_losses.dann_loss(dapply, fs, ft, coeff, group=grp)

    def grl_pre_step(state: TrainState, x_syn, x_real, gen):
        """The discriminator pre-step (main_baseline.py:314-335): one
        backward through the reversed domain loss steps the encoder's aux
        optimizer and the discriminator's."""
        model, disc = state.model, state.discriminator
        syn_s, syn_w, syn_f = model(x_syn, fwd_gen(gen, x_syn))
        r_s, r_w, r_f = model(x_real, fwd_gen(gen, x_real))
        dl = grl_domain_loss(disc, gen, syn_s, syn_w, syn_f, r_s, r_w, r_f,
                             grl_coeff(state.step))
        state.enc_optimizer.zero_grad(set_to_none=True)
        state.disc_optimizer.zero_grad(set_to_none=True)
        params = list(model.encoder.parameters()) + list(disc.parameters())
        dl.backward(inputs=params)
        reduce_grads(params)
        state.enc_optimizer.step()
        state.disc_optimizer.step()
        return dl.detach()

    def adda_steps(state: TrainState, x_syn, x_real, gen):
        """ADDA's alternating updates every ``da.update_step`` steps
        (main_scmt.py:312-371, main.py:262-332,
        main_scmt_ada_origin.py:369-466): the discriminator on detached
        real then syn features, then the encoder's confusion step against
        the updated discriminator. The encoder forwards of the first step
        compute no encoder gradient."""
        if state.step % da.update_step != 0:
            return torch.zeros((), device=dev)
        model, disc = state.model, state.discriminator
        choice_d = sample_adda_choice(gen, rows(x_real))
        with torch.no_grad():
            _, _, r_f = model(x_real, fwd_gen(gen, x_real))
            _, _, syn_f = model(x_syn, fwd_gen(gen, x_syn))
        d_real = disc(r_f, fwd_gen(gen, r_f))
        d_syn = disc(syn_f, fwd_gen(gen, syn_f))
        dl = da_losses.adda_discriminator_loss(d_real, d_syn, choice_d,
                                               da.adv_weight,
                                               da.adda_disc_labels, grp)
        state.disc_optimizer.zero_grad(set_to_none=True)
        dl.backward()
        reduce_grads(disc.parameters())
        state.disc_optimizer.step()
        # the confusion step: main_scmt forwards the real stream and takes
        # a fresh half batch; main.py the whole real stream;
        # scmt_ada_origin the syn stream against flipped labels
        syn_conf = da.adda_confusion == "syn_flipped"
        conf_choice = (sample_adda_choice(gen, rows(x_real))
                       if da.adda_confusion == "half" else None)
        x_conf = x_syn if syn_conf else x_real
        _, _, f = model(x_conf, fwd_gen(gen, x_conf))
        cl = da_losses.adda_confusion_loss(disc(f, fwd_gen(gen, f)),
                                           conf_choice, da.adv_weight,
                                           flipped=syn_conf, group=grp)
        state.enc_optimizer.zero_grad(set_to_none=True)
        params = list(model.encoder.parameters())
        cl.backward(inputs=params)
        reduce_grads(params)
        state.enc_optimizer.step()
        return (dl + cl).detach()

    def train_step(state: TrainState, batch: Dict, seed: int,
                   epoch) -> Dict:
        with contextlib.ExitStack() as phase:
            return _train_step(state, batch, seed, epoch, phase)

    def _train_step(state: TrainState, batch: Dict, seed: int, epoch,
                    phase: contextlib.ExitStack) -> Dict:
        def enter(name):
            """End the open phase's span and open ``name``'s."""
            phase.close()
            phase.enter_context(span(name))

        enter("train.inputs")
        model, teacher = state.model, state.ema_model
        gen = step_generator(seed, state.step, dev)
        rng = step_rng(seed, state.step)
        if t.cost_ramp == "exp_step":
            # per-step exponential ramp over n_epoch_rampup epochs' steps
            rampup_value = exp_rampup(state.step,
                                      t.n_epoch_rampup * steps_per_epoch)
        else:
            # per-epoch sigmoid-shaped ramp (main_baseline.py:285)
            rampup_value = sigmoid_rampdown(epoch, t.rampdown_epochs)
        cost = t.max_consistency_cost * rampup_value
        lr = learning_rate(epoch, t.max_learning_rate, t.adjust_lr,
                           t.rampdown_epochs)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        if state.discriminator is not None:
            # the aux optimizers stay at their constant construction lr:
            # the reference's "aux = lr × 0.1" block is dead in every live
            # path (steps.py:632-642)
            for opt in (state.enc_optimizer, state.disc_optimizer):
                for group in opt.param_groups:
                    group["lr"] = t.max_learning_rate * da.aux_lr_factor

        get = lambda k: (torch.as_tensor(batch[k], device=dev)  # noqa: E731
                         if batch.get(k) is not None else None)
        syn_lin, real_lin = get("syn"), get("real")
        syn_target = get("syn_strong")                    # (Bs, Tf, C)
        real_weak_target = get("real_weak")               # (Br, C)
        real_strong_target = get("real_strong")
        if not origin_masks and (syn_lin is None or syn_target is None):
            raise KeyError("the batch needs 'syn' and 'syn_strong'")
        syn_target_weak = (syn_target.amax(dim=-2)
                           if syn_target is not None else None)
        # origin's main step trains on the combined real batch only; its
        # ADDA updates read the syn stream too
        x_syn = (_inp(syn_lin) if syn_lin is not None
                 and (not origin_masks or da_mode != "none") else None)
        x_real = _inp(real_lin) if real_lin is not None else None
        metrics: Dict = {"lr": lr, "consistency_cost": cost}

        # the domain-adaptation updates that precede the main step, in no
        # phase's span
        if da_mode != "none":
            phase.close()
            model.train()
            state.discriminator.train()
            if da_mode in ("dann", "cdan", "cdan_frame") and not joint_da:
                metrics["domain_loss"] = grl_pre_step(state, x_syn, x_real,
                                                      gen)
            elif da_mode == "adda":
                metrics["domain_loss"] = adda_steps(state, x_syn, x_real,
                                                    gen)
            enter("train.inputs")
        if (mean_teacher or isp) and real_lin is None:
            raise ValueError(
                "mean_teacher/isp presets need the real streams — build "
                "the loader with weak + unlabeled datasets (batch carries "
                "no 'real' key)")

        # teacher input: noise on the LINEAR mel, then the log
        if mean_teacher:
            x_real_t = _inp(gaussian_snr_noise(fwd_gen(gen, real_lin),
                                               real_lin, cfg.audio.noise_snr))
        # ISP shifts, shared between the streams (origin: drawn for and
        # applied to the combined real batch only)
        if isp:
            shifted = real_lin if origin_masks else syn_lin
            in_shift, pool_shift, freq_shift = (
                mine(v, shifted.shape[0]) for v in sample_isp_shifts(
                    gen, rows(shifted), t.time_shift_max, t.freq_shift_max,
                    cfg.model.pooling_time_ratio, device=dev))
            if origin_masks or not isp_syn_only:
                x_real_shift = roll_batch(x_real, in_shift, axis=1)
                x_real_freq = roll_batch(x_real, freq_shift, axis=2)
            if not origin_masks:
                x_syn_shift = roll_batch(x_syn, in_shift, axis=1)
                x_syn_freq = roll_batch(x_syn, freq_shift, axis=2)
                syn_target_shift = roll_batch(syn_target, pool_shift,
                                              axis=1)
                if mean_teacher:
                    x_real_t_shift = roll_batch(x_real_t, in_shift, axis=1)
                    x_real_t_freq = roll_batch(x_real_t, freq_shift, axis=2)

        # teacher forwards: no gradient; its BatchNorm running statistics
        # advance in the reference's call order
        teacher_out = {}
        if mean_teacher:
            enter("train.teacher")
            teacher.train()
            with torch.no_grad():
                if isp and t.fused_streams and not origin_masks:
                    parts = [x_real_t, x_real_t_shift, x_real_t_freq]
                    outs = _split(teacher(torch.cat(parts),
                                          fwd_gen(gen, *parts)),
                                  [x_real_t.shape[0]] * 3)
                    for tag, o in zip(("", "_shift", "_freq"), outs):
                        teacher_out[f"strong{tag}"] = o[0]
                        teacher_out[f"weak{tag}"] = o[1]
                else:
                    inputs = [("", x_real_t)]
                    if isp and not origin_masks:
                        inputs += [("_shift", x_real_t_shift),
                                   ("_freq", x_real_t_freq)]
                    for tag, x in inputs:
                        ts, tw, _ = teacher(x, fwd_gen(gen, x))
                        teacher_out[f"strong{tag}"] = ts
                        teacher_out[f"weak{tag}"] = tw

                # ICT unlabeled mixup-consistency targets (main.py:451-470):
                # the teacher scores the CLEAN unlabeled inputs; input and
                # both posteriors are mixed with one shared λ/permutation
                # (a group gathers the real stream: the slice and the
                # permutation cross ranks; the forwards are spread again)
                if use_mixup:
                    x_real_all = everyone(x_real)
                    b = x_real_all.shape[0]
                    x_u = (x_real_all[b // 4: 3 * b // 4] if origin_masks
                           else x_real_all[b // 2:])
                    n_u = x_u.shape[0]
                    ts_u, tw_u, _ = teacher(chunk(x_u), chunk_gen(gen, n_u))
                    mixed_x_u, mixed_strong_u, mixed_weak_u, _ = mixup(
                        gen, x_u, unchunk(ts_u, n_u), unchunk(tw_u, n_u),
                        alpha=t.mixup_usup_alpha, rng=rng)

        # student forwards and the loss
        enter("train.student")
        model.train()
        fused = t.fused_streams and real_lin is not None
        if fused:
            # one batched forward over all same-rank student streams
            if origin_masks:
                parts = [x_real, x_real_shift, x_real_freq]
            else:
                parts = [x_syn, x_real]
                if isp and not isp_syn_only:
                    parts += [x_real_shift, x_real_freq, x_syn_shift,
                              x_syn_freq]
                elif isp:
                    parts += [x_syn_shift, x_syn_freq]
            outs = _split(model(torch.cat(parts), fwd_gen(gen, *parts)),
                          [p.shape[0] for p in parts])
            if origin_masks:
                r_strong, r_weak, _ = outs[0]
                (rs_strong, rs_weak, _), (rf_strong, rf_weak, _) = outs[1:3]
            else:
                syn_strong, syn_weak, syn_enc = outs[0]
                r_strong, r_weak, r_enc = outs[1]
                if isp and not isp_syn_only:
                    ((rs_strong, rs_weak, _), (rf_strong, rf_weak, _),
                     (ss_strong, ss_weak, _), (sf_strong, sf_weak, _)) = \
                        outs[2:6]
                elif isp:
                    (ss_strong, ss_weak, _), (sf_strong, sf_weak, _) = \
                        outs[2:4]
        elif origin_masks:
            r_strong, r_weak, _ = model(x_real, fwd_gen(gen, x_real))
        else:
            # the syn forward runs (and advances the BatchNorm statistics)
            # even when supervise_on == "real" (main_baseline_ena.py:338)
            syn_strong, syn_weak, syn_enc = model(x_syn, fwd_gen(gen, x_syn))
            if x_real is not None:
                r_strong, r_weak, r_enc = model(x_real, fwd_gen(gen, x_real))

        # supervised BCE (main_baseline.py:431-475 / the ENA variant;
        # origin: masked slices of the combined real batch)
        m: Dict = {}
        if origin_masks:
            if real_strong_target is None:
                raise ValueError(
                    "the origin preset's masked ICT wiring needs the "
                    "combined real batch's strong targets — build the "
                    "loader with layout='origin' (batch carries no "
                    "'real_strong' key)")
            b34 = 3 * rows(r_weak) // 4
            weak_loss = mean_of(bce, r_weak, real_weak_target, 0, b34)
            strong_loss = mean_of(bce, r_strong, real_strong_target, b34)
        elif t.supervise_on == "real" and real_strong_target is not None:
            weak_loss = mean_of(bce, r_weak, real_strong_target.amax(dim=-2))
            if mean_teacher:
                # the ENA script counts the weak BCE twice under MT
                # (main_baseline_ena.py:434,437)
                weak_loss = 2.0 * weak_loss
            strong_loss = mean_of(bce, r_strong, real_strong_target)
        else:
            weak_loss = mean_of(bce, syn_weak, syn_target_weak)
            if real_weak_target is not None:
                if t.real_weak_bce == "full" and mean_teacher:
                    # whole real stream (main_baseline.py:435)
                    weak_loss = weak_loss + mean_of(bce, r_weak,
                                                    real_weak_target)
                elif t.real_weak_bce == "half":
                    # labelled half only, with or without a teacher
                    # (main_sct_ada_weak.py:419-423)
                    hw = rows(real_weak_target) // 2
                    weak_loss = weak_loss + mean_of(bce, r_weak,
                                                    real_weak_target, 0, hw)
            strong_loss = mean_of(bce, syn_strong, syn_target)
        m["weak_class_loss"] = weak_loss
        m["strong_class_loss"] = strong_loss
        loss = strong_loss + weak_loss

        if mean_teacher:
            c_strong = cost * mean_of(mse, r_strong, teacher_out["strong"])
            c_weak = cost * mean_of(mse, r_weak, teacher_out["weak"])
            m["consistency_strong"] = c_strong
            m["consistency_weak"] = c_weak
            loss = loss + c_strong + c_weak

        if isp and origin_masks:
            # masked combined-batch SCT (main.py:363-367,383,422-423):
            # real shift then real freq forwards; class terms on the
            # weak/strong row slices; one self-consistency MSE over the
            # whole combined batch
            b = rows(r_weak)
            b4, b34 = b // 4, 3 * b // 4
            if not fused:
                rs_strong, rs_weak, _ = model(x_real_shift,
                                              fwd_gen(gen, x_real_shift))
                rf_strong, rf_weak, _ = model(x_real_freq,
                                              fwd_gen(gen, x_real_freq))
            real_strong_shift = roll_batch(real_strong_target, pool_shift,
                                           axis=1)
            strong_shift_loss = mean_of(bce, rs_strong, real_strong_shift,
                                        b34)
            strong_freq_loss = mean_of(bce, rf_strong, real_strong_target,
                                       b34)
            weak_freq_loss = mean_of(bce, rf_weak, real_weak_target, 0, b4)
            m["strong_shift_class_loss"] = strong_shift_loss
            m["strong_freq_shift_class_loss"] = strong_freq_loss
            m["weak_freq_shift_class_loss"] = weak_freq_loss
            loss = (loss + strong_shift_loss + strong_freq_loss
                    + weak_freq_loss)
            c_shift = cost / 2 * mean_of(
                mse, rs_strong, roll_batch(r_strong.detach(), pool_shift,
                                           axis=1))
            m["consistency_shift"] = c_shift
            loss = loss + c_shift
        elif isp:
            half = rows(r_weak) // 2
            if not fused:
                if not isp_syn_only:
                    real_order = (("freq", "shift") if t.isp_flavor == "sct"
                                  else ("shift", "freq"))
                    for kind in real_order:
                        # sct (main_sct_ada_weak.py:397-400) forwards the
                        # real freq shift first
                        if kind == "shift":
                            rs_strong, rs_weak, _ = model(
                                x_real_shift, fwd_gen(gen, x_real_shift))
                        else:
                            rf_strong, rf_weak, _ = model(
                                x_real_freq, fwd_gen(gen, x_real_freq))
                ss_strong, ss_weak, _ = model(x_syn_shift,
                                              fwd_gen(gen, x_syn_shift))
                sf_strong, sf_weak, _ = model(x_syn_freq,
                                              fwd_gen(gen, x_syn_freq))

            # SCT classification: the strong terms are common to every
            # lineage
            strong_shift_loss = mean_of(bce, ss_strong, syn_target_shift)
            strong_freq_loss = mean_of(bce, sf_strong, syn_target)
            m["strong_shift_class_loss"] = strong_shift_loss
            m["strong_freq_shift_class_loss"] = strong_freq_loss
            loss = loss + strong_shift_loss + strong_freq_loss

            # the weak-freq term, per lineage
            if t.isp_flavor == "baseline":
                # syn + labelled real half (main_baseline.py:445)
                weak_freq_loss = mean_of(bce, sf_weak, syn_target_weak)
                if real_weak_target is not None:
                    weak_freq_loss = weak_freq_loss + mean_of(
                        bce, rf_weak, real_weak_target, 0, half)
                m["weak_freq_shift_class_loss"] = weak_freq_loss
                loss = loss + weak_freq_loss
            elif t.isp_flavor in ("scmt", "scmt_ada"):
                # syn only (main_scmt.py:459)
                weak_freq_loss = mean_of(bce, sf_weak, syn_target_weak)
                m["weak_freq_shift_class_loss"] = weak_freq_loss
                loss = loss + weak_freq_loss
            elif t.isp_flavor == "sct":
                # computed, never added (main_sct_ada_weak.py:428 vs :513)
                m["weak_freq_shift_class_loss"] = mean_of(bce, sf_weak,
                                                          syn_target_weak)

            # self shift consistency: the pairing differs per lineage
            syn_pred_shift = roll_batch(syn_strong.detach(), pool_shift,
                                        axis=1)
            if t.isp_flavor == "baseline":
                # each stream against its own rolled prediction
                # (main_baseline.py:524-525)
                real_pred_shift = roll_batch(r_strong.detach(), pool_shift,
                                             axis=1)
                c_shift = cost / 2 * (
                    mean_of(mse, ss_strong, syn_pred_shift)
                    + mean_of(mse, rs_strong, real_pred_shift))
            elif t.isp_flavor == "scmt":
                # syn shifted student against the rolled REAL prediction
                # (main_scmt.py:571)
                real_pred_shift = roll_batch(r_strong.detach(), pool_shift,
                                             axis=1)
                c_shift = cost / 2 * mean_of(mse, ss_strong, real_pred_shift)
            else:
                # scmt_ada (:542-544), sct (main_sct_ada_weak.py:512)
                c_shift = cost / 2 * mean_of(mse, ss_strong, syn_pred_shift)
            m["consistency_shift"] = c_shift
            loss = loss + c_shift

            # teacher shift consistencies
            if mean_teacher and t.isp_flavor == "baseline":
                # strong only, real shifted student, half weight
                # (main_baseline.py:501-513, 541)
                c_ss = cost * mean_of(mse, rs_strong,
                                      teacher_out["strong_shift"])
                c_sf = cost * mean_of(mse, rf_strong,
                                      teacher_out["strong_freq"])
                m["consistency_strong_shift"] = c_ss
                m["consistency_strong_freq_shift"] = c_sf
                loss = loss + 0.5 * (c_ss + c_sf)
            elif mean_teacher and t.isp_flavor in ("scmt", "scmt_ada"):
                # four full-weight terms: syn shifted student against the
                # real-stream shifted teacher (main_scmt.py:529-547, 579)
                c_ss = cost * mean_of(mse, ss_strong,
                                      teacher_out["strong_shift"])
                c_ws = cost * mean_of(mse, ss_weak, teacher_out["weak_shift"])
                c_sf = cost * mean_of(mse, sf_strong,
                                      teacher_out["strong_freq"])
                c_wf = cost * mean_of(mse, sf_weak, teacher_out["weak_freq"])
                m["consistency_strong_shift"] = c_ss
                m["consistency_weak_shift"] = c_ws
                m["consistency_strong_freq_shift"] = c_sf
                m["consistency_weak_freq_shift"] = c_wf
                loss = loss + c_ss + c_ws + c_sf + c_wf
            elif mean_teacher and t.isp_flavor == "sct":
                # computed, never added (main_sct_ada_weak.py:481-495)
                m["consistency_strong_shift"] = cost * mean_of(
                    mse, rs_strong, teacher_out["strong_shift"])
                m["consistency_strong_freq_shift"] = cost * mean_of(
                    mse, rf_strong, teacher_out["strong_freq"])

        if use_mixup:
            # ICT mixup in bsed_tpu's forward order (it fixes the order of
            # the BatchNorm statistics); the λ-weighted BCE pair of
            # mixup_criterion equals BCE against the λ-blended target
            def mixed_forward(x, y):
                """Mix a whole input batch and its targets on every rank
                alike (one λ, one permutation), forward it spread over
                the group, and return (outputs, this rank's mixed targets,
                rows)."""
                mixed_x, mixed_y, _ = mixup(gen, x, y, alpha=t.mixup_alpha,
                                            rng=rng)
                n = mixed_x.shape[0]
                return (model(chunk(mixed_x), chunk_gen(gen, n)),
                        chunk(mixed_y), n)

            if origin_masks:
                x_all, weak_all = everyone(x_real), everyone(real_weak_target)
                strong_all = everyone(real_strong_target)
                b = x_all.shape[0]
                b4, b34 = b // 4, 3 * b // 4
                # weak mixup on the mask_weak rows (main.py:386-392)
                (_, mw_weak, _), mixed_yw, n = mixed_forward(x_all[:b4],
                                                             weak_all[:b4])
                mix_weak_loss = mean_of(bce, mw_weak, mixed_yw, chunk_rows=n)
                m["mixup_weak_class_loss"] = mix_weak_loss
                loss = loss + mix_weak_loss
                # strong mixup on the mask_strong rows (main.py:426-432)
                (mx_strong, _, _), mixed_y, n = mixed_forward(
                    x_all[b34:], strong_all[b34:])
                mix_loss = mean_of(bce, mx_strong, mixed_y, chunk_rows=n)
                m["mixup_strong_loss"] = mix_loss
                loss = loss + mix_loss
            else:
                # generic composition: syn strong mixup, labelled real-half
                # weak mixup, unlabelled-half consistency
                (mx_strong, _, _), mixed_y, n = mixed_forward(
                    everyone(x_syn), everyone(syn_target))
                mix_loss = mean_of(bce, mx_strong, mixed_y, chunk_rows=n)
                m["mixup_strong_loss"] = mix_loss
                loss = loss + mix_loss
                if real_weak_target is not None:
                    x_all = everyone(x_real)
                    w_half = x_all.shape[0] // 2
                    (_, mw_weak, _), mixed_yw, n = mixed_forward(
                        x_all[:w_half], everyone(real_weak_target)[:w_half])
                    mix_weak_loss = mean_of(bce, mw_weak, mixed_yw,
                                            chunk_rows=n)
                    m["mixup_weak_class_loss"] = mix_weak_loss
                    loss = loss + mix_weak_loss
            # unlabelled mixup-consistency against the EMA teacher
            # (main.py:459-470), × the ramped consistency cost
            if mean_teacher:
                n_u = mixed_x_u.shape[0]
                u_strong, u_weak, _ = model(chunk(mixed_x_u),
                                            chunk_gen(gen, n_u))
                c_u_strong = (t.mixup_consistency * cost
                              * mean_of(mse, u_strong, chunk(mixed_strong_u),
                                        chunk_rows=n_u))
                c_u_weak = (t.mixup_consistency * cost
                            * mean_of(mse, u_weak, chunk(mixed_weak_u),
                                      chunk_rows=n_u))
                m["mixup_cons_strong_loss"] = c_u_strong
                m["mixup_cons_weak_loss"] = c_u_weak
                loss = loss + c_u_strong + c_u_weak
        if joint_da:
            # the domain loss on the MAIN forwards' features, added to the
            # loss (main_scmt_ada_weak.py:312-331, 527-528); one backward
            # then steps the model and the discriminator
            dl = grl_domain_loss(state.discriminator, gen, syn_strong,
                                 syn_weak, syn_enc, r_strong, r_weak, r_enc,
                                 grl_coeff(state.step))
            m["domain_loss"] = dl
            loss = loss + da.adv_weight * dl
        m["loss"] = loss

        enter("train.backward")
        state.optimizer.zero_grad(set_to_none=True)
        if joint_da:
            state.disc_optimizer.zero_grad(set_to_none=True)
        loss.backward()
        reduce_grads(itertools.chain(
            model.parameters(),
            state.discriminator.parameters() if joint_da else ()))
        if "domain_loss" in metrics:
            m["domain_loss"] = metrics.pop("domain_loss")
        # every term is this rank's share: the sum is the global value
        shares = torch.stack([v.detach().float() for v in m.values()])
        sum_([shares], grp)
        m = dict(zip(m, shares.unbind()))
        if grad_flow:
            m.update(_grad_abs(model))
        enter("train.optimizer")
        state.optimizer.step()
        if joint_da:
            state.disc_optimizer.step()
        state.step += 1
        if mean_teacher:
            enter("train.ema")
            ema_update(teacher.parameters(), model.parameters(), state.step,
                       t.ema_alpha)
            if t.ema_scope == "state_dict":
                # the state-dict EMA averages the BatchNorm statistics too;
                # with "params" (main_origin.py:86-89) the teacher's
                # statistics are those of its own forwards
                ema_update(teacher.buffers(), model.buffers(), state.step,
                           t.ema_alpha)
        metrics.update(m)
        return metrics

    return train_step


def _grad_abs(model: TrainModel) -> Dict[str, torch.Tensor]:
    """``grad_abs/<flax path>`` → mean |grad| for every parameter whose
    name has no "bias" in it (the JAX step's filter), in the order of the
    flax tree's leaves (sorted keys)."""
    out = {}
    for path, param, _ in sorted(weights.train_param_map(model),
                                 key=lambda entry: entry[0]):
        name = ".".join(path)
        if "bias" in name:
            continue
        g = param.grad
        out[f"grad_abs/{name}"] = (g.detach().abs().mean() if g is not None
                                   else param.new_zeros(()))
    return out


def make_epoch_runner(modules: TrainModules,
                      steps_per_epoch: Optional[int] = None,
                      grad_flow: bool = False):
    """One epoch of train steps on a loader's resident arrays: the port of
    the JAX package's ``make_epoch_runner`` (a ``lax.scan`` of the step
    over the epoch) as a plain loop.

    ``run_epoch(state, arrays, idx, seed, epoch) -> stacked_metrics``, with
    ``arrays`` and ``idx`` from ``ThreeStreamLoader.epoch_arrays``: step
    ``i`` trains on ``gather_batch(arrays, row i of every idx matrix)``.
    The index matrices reach the device in one copy before the loop, and
    nothing in the loop waits for the device; each metric comes back as
    one (n_steps,) tensor on the device, which the caller fetches once."""
    from bsed_tpu_torch.data.pipeline import device_index_matrices, \
        gather_batch

    step = make_train_step(modules, steps_per_epoch=steps_per_epoch,
                           grad_flow=grad_flow)
    dev = modules.device

    def run_epoch(state: TrainState, arrays: Dict, idx: Dict, seed: int,
                  epoch) -> Dict[str, torch.Tensor]:
        ids = device_index_matrices(dev, idx)
        n_steps = len(ids["syn"])
        history = [step(state, gather_batch(arrays, {k: v[i] for k, v in
                                                      ids.items()}),
                        seed, epoch)
                   for i in range(n_steps)]
        return stack_metrics(history, dev)

    return run_epoch


def stack_metrics(history, device) -> Dict[str, torch.Tensor]:
    """A list of per-step metric dicts as one (n_steps,) float32 tensor on
    ``device`` per key (float metrics such as lr are moved there)."""
    out = {}
    for k in history[0]:
        vals = [m[k] for m in history]
        if isinstance(vals[0], torch.Tensor):
            out[k] = torch.stack([v.float() for v in vals])
        else:
            out[k] = torch.tensor(vals, dtype=torch.float32, device=device)
    return out


def make_predict_fn(modules: TrainModules, norm_stats="train"):
    """Inference: ``predict(params, batch_stats, mel, inference=False,
    apply_log=True) -> (strong (B, T', C), weak (B, C))``, float32 tensors
    on ``modules.device``, with BN running averages and no dropout
    (get_predictions contract, evaluation_measures.py:163-182). ``mel`` is
    linear mel (B, T, F) (log-mel with ``apply_log=False``), a tensor on
    any device or a numpy array; it runs under ``torch.inference_mode()``.

    norm_stats: "train" uses ``modules.norm_stats``; None disables
    normalization (TestModel.py semantics); an explicit (mean, std) pair
    ((F,) arrays) normalizes with those.

    Differs from ``bsed_tpu.train.steps.make_predict_fn`` in how it reaches
    the model: the encoder is ``serve.build_encoder`` (folded stem with
    kernel K2's eval form on the card for blocks 0-2 where the topology
    folds, the BiGRU hoisted on kernel K4; ``kernels.launches_on``
    decides) and the head ``serve.build_predictor``,
    built from ``params``/``batch_stats`` (flax-layout trees) at the first
    call and again whenever a call passes other tree objects
    (``predict.prepare(params, batch_stats)`` builds them ahead)."""
    from bsed_tpu_torch.serve import build_encoder, build_predictor

    cfg, dev = modules.cfg, modules.device
    if norm_stats == "train":
        norm_stats = modules.norm_stats
    nm = None
    if norm_stats is not None:
        nm = tuple(torch.as_tensor(np.asarray(a, np.float32),
                                   device=dev)[:, None] for a in norm_stats)
    built = {}

    def models(params, batch_stats):
        if built.get("trees") != (id(params), id(batch_stats)):
            built.clear()
            built["encode"] = build_encoder(
                cfg, params["encoder"], batch_stats["encoder"], dev)
            built["predictor"] = build_predictor(
                cfg, params["predictor"], dev, batch_stats.get("predictor"))
            # the trees are held so their ids stay theirs
            built["trees"] = (id(params), id(batch_stats))
            built["held"] = (params, batch_stats)
        return built["encode"], built["predictor"]

    @torch.inference_mode()
    def predict(params, batch_stats, mel, inference=False, apply_log=True):
        encode, predictor = models(params, batch_stats)
        mel = torch.as_tensor(mel, device=dev).float()
        x = _log_input(mel) if apply_log else mel[..., None]
        if nm is not None:
            x = (x - nm[0]) / nm[1]
        return predictor(encode(x), inference=inference)

    predict.prepare = models        # build for (params, batch_stats) now
    return predict
