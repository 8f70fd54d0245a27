"""The flagship train step: mean teacher + ISP shift consistency.

Port of ``bsed_tpu/train/steps.py`` for the configuration of preset
``baseline_mt_isp`` (reference main_baseline.py:168-598): supervised BCE
on the SYN strong+weak targets and the real weak targets, the mean teacher
(EMA twin, SNR noise on its linear-mel input, MSE consistency × the
sigmoid cost ramp), and the 'baseline' ISP flavour (per-sample time/freq
rolls shared between streams, shift classification and self/teacher shift
consistency). Forwards go through the folded train stem
(``ModelConfig.folded_train_stem``), whose epilogues are kernels K2 and K3
on the card; ``TrainConfig.fused_streams`` runs the 3 teacher and the 6
student forwards as one batched forward each (BatchNorm statistics pool
over the streams), otherwise they run one by one in the reference's order.

PyTorch idiom: the student and teacher are ``nn.Module``s and the step
updates them and the Adam optimizer in place (``train/state.py``). Its
randomness — teacher noise, ISP shifts, dropout bits — comes from one
``torch.Generator`` per step, seeded from (seed, step) as the JAX step
folds the step count into its key; the draws differ from JAX's, so parity
tests inject them.

``make_epoch_runner`` runs an epoch of steps on loader arrays resident on
the device (the port of the JAX package's ``lax.scan`` over the epoch, as
a plain loop), and ``make_predict_fn`` is the port of the JAX package's
inference function; ``train/trainer.py`` drives both.

Not ported (ROADMAP items 8a and 8b): the presets other than
``baseline_mt_isp`` — the other ISP flavours, ICT mixup, domain
adaptation, the exp_step ramp, real-stream supervision, normalisation
statistics, SGD and the unfolded train encoder; ``build_modules`` refuses
them.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from bsed_tpu_torch.config import Config
from bsed_tpu_torch.models.crnn import compute_dtype
from bsed_tpu_torch.models.layers import ConvBlock
from bsed_tpu_torch.models.predictor import make_predictor_head
from bsed_tpu_torch.models.rnn import BidirectionalGRU
from bsed_tpu_torch.ops.augment import (gaussian_snr_noise, roll_batch,
                                        sample_isp_shifts)
from bsed_tpu_torch.ops.dropout import FastDropout
from bsed_tpu_torch.ops.folded_stem import (folded_train_eligible,
                                            make_folded_train_stem)
from bsed_tpu_torch.ops.mel import amplitude_to_db
from bsed_tpu_torch.train.ema import ema_update
from bsed_tpu_torch.train.losses import bce, mse
from bsed_tpu_torch.train.ramps import sigmoid_rampdown
from bsed_tpu_torch.train.schedule import learning_rate
from bsed_tpu_torch.train.state import TrainState
from bsed_tpu_torch.utils import weights
from bsed_tpu_torch.utils.device import resolve_device

_LATER = "is not ported yet (ROADMAP.md, open item 8)"


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
        return self.dropout(self.rnn(h), gen)


class FoldedEncoder(nn.Module):
    """The train-mode encoder with the folded-frequency stem (the port of
    ``make_folded_encoder_fwd``): blocks 0..n_folded-1 (``stem``,
    parameters only) run on the folded layout through
    ``make_folded_train_stem``, the rest through ``_FoldedRestCRNN``.
    ``forward(x (B, T, F, 1), gen) -> (B, T', 2H)``; BatchNorm uses batch
    statistics in training mode, running ones in eval mode."""

    def __init__(self, cfg: Config, device="cuda", use_kernels: bool = True):
        super().__init__()
        m = cfg.model
        if not folded_train_eligible(m, cfg.audio.n_mels):
            raise ValueError(
                "folded_train_stem=True but the topology is not foldable "
                "(needs non-FPN, kernel 3, glu/cg/relu/leakyrelu activation, "
                "n_mels divisible by 8, freq pooling dividing the fold)")
        self.stem_apply, n_folded = make_folded_train_stem(
            m, cfg.audio.n_mels, device=device, use_kernels=use_kernels)
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
    encoded)``."""

    def __init__(self, cfg: Config, device="cuda", use_kernels: bool = True):
        super().__init__()
        self.encoder = FoldedEncoder(cfg, device, use_kernels)
        self.predictor = make_predictor_head(cfg)

    def forward(self, x, gen: Optional[torch.Generator] = None):
        enc = self.encoder(x, gen)
        strong, weak = self.predictor(enc)
        return strong, weak, enc


@dataclasses.dataclass
class TrainModules:
    """What the train step and the predict function build their models
    from. ``build_modules`` also checks that the train step supports the
    configuration; inference (``make_predict_fn``) needs no such check, so
    evaluation builds this directly. ``norm_stats``: the dataset's
    (mean, std) of the log-mel per mel bin, as (F,) arrays, or None."""
    cfg: Config
    device: torch.device
    use_kernels: bool = True
    norm_stats: Optional[tuple] = None

    def make_model(self) -> TrainModel:
        return TrainModel(self.cfg, self.device,
                          self.use_kernels).to(self.device)


def _check_supported(cfg: Config) -> None:
    t, m = cfg.train, cfg.model
    if not (t.mean_teacher and t.isp and t.isp_flavor == "baseline"):
        raise NotImplementedError(
            f"train steps other than mean teacher + ISP flavour 'baseline' "
            f"(mean_teacher={t.mean_teacher}, isp={t.isp}, "
            f"isp_flavor={t.isp_flavor!r}) {_LATER}")
    if t.mixup:
        raise NotImplementedError(f"ICT mixup {_LATER}")
    if t.stage == "adaptation" and cfg.da.mode != "none":
        raise NotImplementedError(f"domain adaptation {_LATER}")
    if t.cost_ramp != "sigmoid_epoch":
        raise NotImplementedError(f"cost_ramp={t.cost_ramp!r} {_LATER}")
    if t.supervise_on != "syn":
        raise NotImplementedError(f"supervise_on={t.supervise_on!r} {_LATER}")
    if t.normalize:
        raise NotImplementedError(f"dataset normalisation {_LATER}")
    if t.optimizer != "adam":
        raise NotImplementedError(f"optimizer={t.optimizer!r} {_LATER}")
    if not m.folded_train_stem:
        raise NotImplementedError(
            f"the unfolded train encoder (folded_train_stem=False) {_LATER}")
    if m.predictor_head == "crnn":
        raise NotImplementedError(f"the 'crnn' predictor head {_LATER}")


def build_modules(cfg: Config, device="cuda",
                  use_kernels: bool = True) -> TrainModules:
    """What the step needs to build its models on ``device``;
    ``use_kernels=False`` runs the stem epilogue's plain versions."""
    _check_supported(cfg)
    return TrainModules(cfg, resolve_device(device), use_kernels)


def load_train_state(modules: TrainModules, trees: Dict) -> TrainState:
    """A train state from flax-layout trees (``utils/weights``): step,
    params, batch_stats, ema_params, ema_batch_stats and, optionally, the
    Adam moments mu, nu and their count."""
    model = modules.make_model()
    teacher = modules.make_model()
    for p in teacher.parameters():
        p.requires_grad_(False)
    t = modules.cfg.train
    opt = torch.optim.Adam(model.parameters(), lr=t.max_learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    state = TrainState(step=0, model=model, ema_model=teacher, optimizer=opt)
    weights.load_train_state(state, trees)
    return state


def create_train_state(cfg: Config, modules: TrainModules,
                       seed: int = 0) -> TrainState:
    """Student and teacher from their own random inits, drawn from
    ``seed`` (the teacher's init differs from the student's, as in the
    reference, main_baseline.py:817-818); zero Adam state."""
    s_seed, t_seed = (int(v) for v in
                      np.random.SeedSequence(seed).generate_state(2))
    params, stats = weights.init_params(cfg, s_seed)
    ema_params, ema_stats = weights.init_params(cfg, t_seed)
    return load_train_state(modules, {
        "step": 0, "params": params, "batch_stats": stats,
        "ema_params": ema_params, "ema_batch_stats": ema_stats})


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step, seeded from (seed, step)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence((seed, step))
                        .generate_state(1)[0]))
    return gen


def _log_input(linear_mel: torch.Tensor) -> torch.Tensor:
    """linear mel (B, T, F) → log-mel with channel axis (B, T, F, 1)."""
    return amplitude_to_db(linear_mel)[..., None]


def make_train_step(modules: TrainModules,
                    steps_per_epoch: Optional[int] = None,
                    grad_flow: bool = False):
    """``step(state, batch, seed, epoch) -> metrics``: one optimizer step
    of the student, then the teacher's EMA, all in place on ``state``.

    ``batch``: ``syn`` (Bs, T, F) and ``real`` (Br, T, F) linear mel,
    ``syn_strong`` (Bs, T', C) targets and, optionally, ``real_weak``
    (Br, C); the first half of the real stream is the labelled weak half.
    ``epoch`` drives the lr and the consistency-cost ramp. The metrics are
    the JAX step's names, as 0-d tensors on the device (lr and the cost as
    floats).

    ``steps_per_epoch`` is what the exp_step cost ramp needs (ROADMAP
    item 8a); the supported sigmoid ramp does not read it.
    ``grad_flow=True`` adds the mean |grad| of every non-bias parameter
    as ``grad_abs/<name>``, ``<name>`` being the parameter's flax path
    joined by dots, as the JAX step names them (the reference's
    plot_grad_flow diagnostic, main_baseline.py:108-123)."""
    del steps_per_epoch
    cfg = modules.cfg
    t = cfg.train
    dev = modules.device
    fused = t.fused_streams

    def train_step(state: TrainState, batch: Dict, seed: int,
                   epoch) -> Dict:
        model, teacher = state.model, state.ema_model
        gen = step_generator(seed, state.step, dev)
        cost = t.max_consistency_cost * sigmoid_rampdown(epoch,
                                                         t.rampdown_epochs)
        lr = learning_rate(epoch, t.max_learning_rate, t.adjust_lr,
                           t.rampdown_epochs)
        for group in state.optimizer.param_groups:
            group["lr"] = lr

        get = lambda k: torch.as_tensor(batch[k], device=dev)  # noqa: E731
        syn_lin, real_lin, syn_target = get("syn"), get("real"), \
            get("syn_strong")
        real_weak_target = get("real_weak") if "real_weak" in batch else None
        syn_target_weak = syn_target.amax(dim=-2)
        x_syn, x_real = _log_input(syn_lin), _log_input(real_lin)
        metrics: Dict = {"lr": lr, "consistency_cost": cost}

        # teacher input: noise on the LINEAR mel, then the log
        x_real_t = _log_input(gaussian_snr_noise(gen, real_lin,
                                                 cfg.audio.noise_snr))
        # ISP shifts, shared between the real and syn streams
        in_shift, pool_shift, freq_shift = sample_isp_shifts(
            gen, syn_lin.shape[0], t.time_shift_max, t.freq_shift_max,
            cfg.model.pooling_time_ratio, device=dev)
        x_real_shift = roll_batch(x_real, in_shift, axis=1)
        x_real_freq = roll_batch(x_real, freq_shift, axis=2)
        x_syn_shift = roll_batch(x_syn, in_shift, axis=1)
        x_syn_freq = roll_batch(x_syn, freq_shift, axis=2)
        syn_target_shift = roll_batch(syn_target, pool_shift, axis=1)
        x_real_t_shift = roll_batch(x_real_t, in_shift, axis=1)
        x_real_t_freq = roll_batch(x_real_t, freq_shift, axis=2)

        # teacher forwards: no gradient; its BatchNorm running statistics
        # advance in the reference's call order
        teacher.train()
        with torch.no_grad():
            t_inputs = [x_real_t, x_real_t_shift, x_real_t_freq]
            if fused:
                ts, tw, _ = teacher(torch.cat(t_inputs), gen)
                n_t = x_real_t.shape[0]
                t_out = [(ts[i * n_t:(i + 1) * n_t], tw[i * n_t:(i + 1) * n_t])
                         for i in range(3)]
            else:
                t_out = [teacher(x, gen)[:2] for x in t_inputs]
        (t_strong, t_weak), (t_strong_shift, _), (t_strong_freq, _) = t_out

        # student forwards: syn, real, real shift, real freq, syn shift,
        # syn freq (the baseline lineage's order, main_baseline.py:372-407)
        model.train()
        parts = [x_syn, x_real, x_real_shift, x_real_freq, x_syn_shift,
                 x_syn_freq]
        if fused:
            s_all, w_all, _ = model(torch.cat(parts), gen)
            cuts = [0] + list(itertools.accumulate(p.shape[0] for p in parts))
            outs = [(s_all[a:b], w_all[a:b]) for a, b in zip(cuts, cuts[1:])]
        else:
            outs = [model(x, gen)[:2] for x in parts]
        ((syn_strong, syn_weak), (r_strong, r_weak), (rs_strong, _),
         (rf_strong, rf_weak), (ss_strong, _), (sf_strong, sf_weak)) = outs

        # supervised BCE (main_baseline.py:431-475)
        weak_loss = bce(syn_weak, syn_target_weak)
        if real_weak_target is not None:
            if t.real_weak_bce == "full":
                weak_loss = weak_loss + bce(r_weak, real_weak_target)
            elif t.real_weak_bce == "half":
                hw = real_weak_target.shape[0] // 2
                weak_loss = weak_loss + bce(r_weak[:hw],
                                            real_weak_target[:hw])
        strong_loss = bce(syn_strong, syn_target)
        m = {"weak_class_loss": weak_loss, "strong_class_loss": strong_loss}
        loss = strong_loss + weak_loss

        c_strong = cost * mse(r_strong, t_strong)
        c_weak = cost * mse(r_weak, t_weak)
        m["consistency_strong"], m["consistency_weak"] = c_strong, c_weak
        loss = loss + c_strong + c_weak

        # SCT classification (main_baseline.py:479-480, 445)
        strong_shift_loss = bce(ss_strong, syn_target_shift)
        strong_freq_loss = bce(sf_strong, syn_target)
        m["strong_shift_class_loss"] = strong_shift_loss
        m["strong_freq_shift_class_loss"] = strong_freq_loss
        loss = loss + strong_shift_loss + strong_freq_loss
        weak_freq_loss = bce(sf_weak, syn_target_weak)
        if real_weak_target is not None:
            half = r_weak.shape[0] // 2
            weak_freq_loss = weak_freq_loss + bce(rf_weak[:half],
                                                  real_weak_target[:half])
        m["weak_freq_shift_class_loss"] = weak_freq_loss
        loss = loss + weak_freq_loss

        # self shift consistency, each stream against its own rolled
        # prediction (main_baseline.py:524-525)
        syn_pred_shift = roll_batch(syn_strong.detach(), pool_shift, axis=1)
        real_pred_shift = roll_batch(r_strong.detach(), pool_shift, axis=1)
        c_shift = cost / 2 * (mse(ss_strong, syn_pred_shift)
                              + mse(rs_strong, real_pred_shift))
        m["consistency_shift"] = c_shift
        loss = loss + c_shift

        # teacher shift consistency: strong only, real shifted student,
        # half weight (main_baseline.py:501-513, 541)
        c_ss = cost * mse(rs_strong, t_strong_shift)
        c_sf = cost * mse(rf_strong, t_strong_freq)
        m["consistency_strong_shift"] = c_ss
        m["consistency_strong_freq_shift"] = c_sf
        loss = loss + 0.5 * (c_ss + c_sf)
        m["loss"] = loss

        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if grad_flow:
            m.update(_grad_abs(model))
        state.optimizer.step()
        state.step += 1
        ema_update(teacher.parameters(), model.parameters(), state.step,
                   t.ema_alpha)
        if t.ema_scope == "state_dict":
            # the state-dict EMA averages the BatchNorm statistics too
            ema_update(teacher.buffers(), model.buffers(), state.step,
                       t.ema_alpha)
        metrics.update({k: v.detach() for k, v in m.items()})
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
    folds, the BiGRU hoisted on kernel K4; their plain versions under
    ``modules.use_kernels=False``) and the head ``serve.build_predictor``,
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
    if cfg.model.predictor_head == "crnn":
        raise NotImplementedError(f"the 'crnn' predictor head {_LATER}")
    built = {}

    def models(params, batch_stats):
        if built.get("trees") != (id(params), id(batch_stats)):
            built.clear()
            built["encode"] = build_encoder(
                cfg, params["encoder"], batch_stats["encoder"], dev,
                use_kernels=modules.use_kernels)
            built["predictor"] = build_predictor(cfg, params["predictor"],
                                                 dev)
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
