"""Epoch-level trainer: the config-driven replacement for the reference's
``__main__`` blocks (reference src/main_baseline.py:602-1093).

Port of ``bsed_tpu/train/trainer.py``:
  * build the student, the teacher and the optimizer
    (``train/steps.py``)
  * per epoch: run the train step over the three-stream loader (reference
    :981-1007), then validate the student with ``get_predictions``-style
    decoding and event-F1 / PSDS / tagging-F1 scoring (:1015-1031)
  * checkpoint every epoch + SaveBest on the configured metric
    (:1040-1077), optional EarlyStopping (:1079-1082), resume
  * metrics to TensorBoard (optional) + results.tsv (:1092)

The epoch runs one of two paths. Resident: the loader's arrays live on
the device (``ThreeStreamLoader.epoch_arrays``) and ``make_epoch_runner``
trains the whole epoch with no wait on the device inside it. Loop: the
loader's batches, produced two ahead on a thread (``data/prefetch``). On
both, the step's metrics stay on the device and the host fetches them
every 10th step and at the epoch's end; the NaN guard and the epoch
meters cover every step.

Randomness: step ``s`` draws from a generator seeded from (seed, s) and
the loader's epoch ``e`` from (seed, e), so a resumed run draws exactly
what an uninterrupted run draws.

Dataset normalisation (``TrainConfig.normalize``, the main.py lineage)
fits the train scaler on the real train streams plus SYN (main.py:681-686)
and validates with a separate val-fitted one (main.py:696-699); the
checkpoint's meta records the train scaler.

In the adaptation stage the state holds a discriminator; a resume at a
stage boundary keeps its fresh init (``Trainer.resume``), and the domain
loss reaches the meters, results.tsv and TensorBoard as ``domain_loss``.

Data parallelism (``mesh``): in a ``torch.distributed`` job of more than
one rank, ``mesh='auto'`` (the default, as in ``bsed_tpu``) trains over
the job's group (``parallel/mesh.auto_data_group``); a ``DataGroup`` may
be passed, ``'off'`` trains on this process alone. Under a group every
rank holds the same state (broadcast from rank 0 at the start and after a
resume, then kept equal by the step's summed gradients), steps with the
rows of its own loader, strided over the group's ranks
(``process_index == rank``, ``process_count == size``, as the CLI builds
it; the global batch is the ranks' batches in rank order), and takes the
loop path (``bsed_tpu`` keeps its loop for
multi-process runs). Rank 0 alone writes checkpoints, meta.json,
results.tsv and TensorBoard, and the ranks meet at a barrier after each
write. Evaluation is sharded by val batch when the loader has the val
set's original-resolution events (each rank forwards and decodes every
``size``-th batch, then the decoded events and the tagging counts are
gathered), else every rank evaluates the whole set; every rank scores the
same events.
"""
from __future__ import annotations

import copy
import csv
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from bsed_tpu_torch import kernels
from bsed_tpu_torch.config import Config, config_to_dict
from bsed_tpu_torch.data.codec import ManyHotEncoder
from bsed_tpu_torch.data.prefetch import prefetch
from bsed_tpu_torch.eval.decode import (decode_batch,
                                        groundtruth_df_from_events,
                                        gt_events_from_frame_targets,
                                        merge_prediction_dfs)
from bsed_tpu_torch.eval.psds import compute_macro_f_score
from bsed_tpu_torch.eval.sed_scores import event_based_f1
from bsed_tpu_torch.eval.tagging import TaggingF1Accumulator
from bsed_tpu_torch.parallel import mesh as pmesh
from bsed_tpu_torch.train.steps import (TrainModules, build_modules,
                                        create_train_state,
                                        make_epoch_runner, make_predict_fn,
                                        make_train_step, stack_metrics)
from bsed_tpu_torch.utils import weights
from bsed_tpu_torch.utils.checkpoint import CheckpointManager
from bsed_tpu_torch.utils.logger import create_logger
from bsed_tpu_torch.utils.meters import (AverageMeterSet, EarlyStopping,
                                         SaveBest)

FETCH_EVERY = 10          # steps between the host's fetches of the metrics


def summary_writer(log_dir: str, purge_step: Optional[int] = None):
    """The TensorBoard writer (``torch.utils.tensorboard``); raises an
    ImportError that says so when tensorboard is not installed."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise ImportError("use_tensorboard=True needs the tensorboard "
                          "package, which is not installed") from e
    return SummaryWriter(log_dir, purge_step=purge_step)


def _host_metrics(stacked: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Stacked device metrics → numpy, in one copy to the host, keyed in
    sorted order (the order of ``bsed_tpu``'s metrics pytree, hence of
    its meters and its results.tsv columns)."""
    keys = sorted(stacked)
    host = torch.stack([stacked[k] for k in keys]).cpu().numpy()
    return dict(zip(keys, host))


class Trainer:
    """Port of ``bsed_tpu.train.trainer.Trainer``: the same arguments,
    ``mesh`` included (see the module docstring), plus ``device`` (the
    card by default; under a group the group's device). Kernel or plain
    version is each kernel entry's choice (``kernels.launches_on``)."""

    def __init__(self, cfg: Config, train_loader, val_loader=None,
                 syn_eval_loader=None, store_dir: Optional[str] = None,
                 use_tensorboard: bool = False,
                 profile_dir: Optional[str] = None,
                 mesh="auto", grad_flow: bool = False,
                 scan_epoch: str = "auto", device="cuda"):
        self.cfg = cfg
        count = getattr(train_loader, "process_count", 1)
        if mesh == "auto":
            bs = cfg.train.batch_size
            mesh = pmesh.auto_data_group(bs, 2 * (bs // 2),
                                         process_count=count, device=device)
        elif mesh in (None, "off"):
            mesh = None
        self.group: Optional[pmesh.DataGroup] = mesh
        if mesh is not None:
            # each rank reads its own rows: a loader strided over the group
            # (process_index = rank, process_count = size), as the CLI's
            if (count, getattr(train_loader, "process_index", 0)) != (
                    mesh.size, mesh.rank):
                raise ValueError(
                    f"rank {mesh.rank} of {mesh.size} needs a train loader "
                    f"strided over the group (process_index={mesh.rank}, "
                    f"process_count={mesh.size}); this one has "
                    f"process_count={count}")
            device = mesh.device
            if kernels.launches_on(device):
                # rank 0 builds the kernels the ranks will load
                self._on_rank0(kernels.build)
        # grad_flow: per-parameter mean-|grad| in the step metrics +
        # gradient_flow.png per epoch (plot_grad_flow, main_baseline.py:108)
        self.grad_flow = grad_flow
        # when set, the first trained epoch is captured as a torch.profiler
        # trace (utils/profiling.py)
        self.profile_dir = profile_dir
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.syn_eval_loader = syn_eval_loader
        # dataset normalisation: the train scaler over the real train
        # streams + SYN, a separate one over the val set for validation;
        # `cli eval` never normalises (TestModel.py:225-231)
        norm_stats = None
        self.val_norm_stats = None
        if cfg.train.normalize:
            from bsed_tpu_torch.utils.scaler import fit_log_mel_stats
            norm_stats = fit_log_mel_stats(
                [train_loader.weak, train_loader.unlab, train_loader.syn])
            if val_loader is not None:
                self.val_norm_stats = fit_log_mel_stats([val_loader.dataset])
        self.norm_stats = norm_stats
        # refuses the configurations the port cannot train yet, before
        # anything else is built
        self.modules: TrainModules = build_modules(
            cfg, device=device, norm_stats=norm_stats, group=self.group)
        self.log = create_logger(f"bsed_tpu_torch/{cfg.model_name}")
        self.store_dir = store_dir or os.path.join("stored_data",
                                                   cfg.model_name)
        self.ckpt = CheckpointManager(self.store_dir)
        self.encoder_codec = ManyHotEncoder(
            cfg.bird_list, n_frames=cfg.n_frames, sr=cfg.audio.sr,
            hop_size=cfg.audio.hop_size,
            pooling_time_ratio=cfg.model.pooling_time_ratio)
        self.state = create_train_state(cfg, self.modules, cfg.train.seed)
        self._replicate()
        self.train_step = make_train_step(
            self.modules, steps_per_epoch=len(train_loader),
            grad_flow=grad_flow)
        # "auto": the resident path whenever the loader's arrays live on
        # the device; "off": the loop path always
        self.scan_epoch = scan_epoch
        self._epoch_runner = None
        self.predict = make_predict_fn(self.modules)
        # validation uses the val-fitted scaler; without normalisation the
        # two predict functions are one
        self.predict_val = (
            make_predict_fn(self.modules, norm_stats=self.val_norm_stats)
            if self.val_norm_stats is not None else self.predict)
        self.saver = SaveBest("sup")
        self.early_stopping = (
            EarlyStopping(cfg.train.early_stopping, cfg.train.es_init_wait)
            if cfg.train.early_stopping else None)
        # created in fit(): a resume passes purge_step so re-run epochs
        # don't leave duplicate scalars (main_baseline.py:656)
        self.use_tensorboard = use_tensorboard
        self.writer = None
        self.history: list = []
        self._on_rank0(self.ckpt.save_meta, {
            # full config: the checkpoint is self-describing — `cli eval
            # --store-dir X` rebuilds this exact Config with no --preset
            "config": config_to_dict(cfg),
            "model_name": cfg.model_name,
            "crnn_kwargs": {
                "nb_filters": cfg.model.nb_filters,
                "pooling": cfg.model.pooling,
                "activation": cfg.model.activation,
                "n_rnn_cell": cfg.model.n_rnn_cell,
                "n_layers_rnn": cfg.model.n_layers_rnn,
                "use_fpn": cfg.model.use_fpn,
            },
            "pooling_time_ratio": cfg.model.pooling_time_ratio,
            "many_hot_encoder": self.encoder_codec.state_dict(),
            "median_window": cfg.median_window,
            "median_window_classwise": cfg.median_window_classwise,
            # the train scaler's statistics (None unless normalize);
            # recorded for self-description, `cli eval` does not apply them
            "scaler": ({"mean": np.asarray(norm_stats[0]).tolist(),
                        "std": np.asarray(norm_stats[1]).tolist()}
                       if norm_stats is not None else None),
        })

    # ------------------------------------------------------------------
    @property
    def is_writer(self) -> bool:
        """Whether this process writes the run's files (rank 0)."""
        return self.group is None or self.group.rank == 0

    def _on_rank0(self, fn, *args) -> None:
        """``fn(*args)`` on rank 0, then every rank waits for it."""
        if self.is_writer:
            fn(*args)
        if self.group is not None:
            pmesh.barrier(self.group)

    def _replicate(self) -> None:
        """Under a group, every rank takes rank 0's state: the modules'
        parameters and buffers and the optimizers' state tensors."""
        if self.group is None:
            return
        st = self.state
        tensors = []
        for mod in (st.model, st.ema_model, st.discriminator):
            if mod is not None:
                tensors += [t.data for t in mod.state_dict().values()]
        for opt in (st.optimizer, st.enc_optimizer, st.disc_optimizer):
            if opt is not None:
                tensors += [v for slots in opt.state.values()
                            for v in slots.values() if torch.is_tensor(v)]
        pmesh.replicate(self.group, tensors)

    def resume(self, epoch: int) -> None:
        """Resume from epoch_<epoch-1>: student, teacher, the optimizers'
        states and step count, into the live modules. At the adaptation
        stage's boundaries (epoch 1 / 51, main_baseline.py:836-840) the
        discriminator, its statistics and its optimizer keep the live
        (fresh) state."""
        st = self.state
        keep = None
        if self.cfg.train.stage == "adaptation" and epoch in (1, 51) and \
                st.discriminator is not None:
            keep = (copy.deepcopy(st.discriminator.state_dict()),
                    copy.deepcopy(st.disc_optimizer.state_dict()))
        self.ckpt.restore(f"epoch_{epoch - 1}", st)
        if keep is not None:
            st.discriminator.load_state_dict(keep[0])
            st.disc_optimizer.load_state_dict(keep[1])
        self._replicate()

    def _sink_metrics(self, meters: AverageMeterSet,
                      stacked: Dict[str, np.ndarray], base_step: int,
                      first_step: int, last_step: int) -> None:
        """Feed a stacked (n,) metrics dict into the epoch meters, the
        loss-explosion guard, and (step-indexed) TensorBoard."""
        for k, vals in stacked.items():
            if not (np.isfinite(vals).all() and (vals < 1e5).all()):
                raise FloatingPointError(
                    f"Loss explosion in {k} within steps "
                    f"{first_step}..{last_step}: {vals}")
            for i, v in enumerate(vals):
                meters.update(k, float(v))
                if self.writer is not None:
                    self.writer.add_scalar(k, float(v), base_step + 1 + i)

    def _epoch_done(self, epoch: int, meters: AverageMeterSet, n_steps: int,
                    start: float, how: str) -> Dict[str, float]:
        self.last_meters = meters   # exposed for tests/inspection
        avgs = meters.averages()
        if self.grad_flow:
            from bsed_tpu_torch.utils.profiling import plot_grad_flow
            plot_grad_flow(avgs, os.path.join(self.store_dir,
                                              "gradient_flow.png"))
        self.log.info("Epoch %d: %d steps in %.1fs%s  %s", epoch, n_steps,
                      time.time() - start, how, meters)
        return avgs

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> Dict[str, float]:
        meters = AverageMeterSet()
        start = time.time()
        seed = self.cfg.train.seed
        ea = (self.train_loader.epoch_arrays(epoch)
              if self.scan_epoch != "off" and self.group is None
              and hasattr(self.train_loader, "epoch_arrays") else None)
        if ea is not None:
            arrays, idx = ea
            if self._epoch_runner is None:
                self._epoch_runner = make_epoch_runner(
                    self.modules, steps_per_epoch=len(self.train_loader),
                    grad_flow=self.grad_flow)
            stacked = _host_metrics(self._epoch_runner(
                self.state, arrays, idx, seed, float(epoch)))
            n_steps = len(idx["syn"])
            self._sink_metrics(meters, stacked, self.state.step - n_steps,
                               1, n_steps)
            return self._epoch_done(epoch, meters, n_steps, start,
                                    " (resident)")

        # the metrics stay on the device; the host fetches them every
        # FETCH_EVERY steps (so it keeps its lead over the device) and at
        # the epoch's end — the guard and the meters still see every step
        n_steps, pending = 0, []
        n_total = len(self.train_loader)
        dev = self.modules.device
        for batch in prefetch(self.train_loader.epoch(epoch), depth=2):
            pending.append(self.train_step(self.state, batch, seed,
                                           float(epoch)))
            n_steps += 1
            if n_steps % FETCH_EVERY == 0 or n_steps == n_total:
                stacked = _host_metrics(stack_metrics(pending, dev))
                n_pend, pending = len(pending), []
                self._sink_metrics(meters, stacked,
                                   self.state.step - n_pend,
                                   n_steps - n_pend + 1, n_steps)
        return self._epoch_done(epoch, meters, n_steps, start, "")

    # ------------------------------------------------------------------
    def evaluate(self, loader, thresholds=(0.5,),
                 learned_post: bool = False,
                 predict_fn=None) -> Dict[str, float]:
        """Validate the student (the reference evaluates the student; the
        EMA teacher is used for consistency only): ``weak_f1``,
        ``event_f1``, ``psds_f1``. The student's trees go through
        ``make_predict_fn`` (on the card: the folded stem with K2's eval
        form and the hoisted BiGRU on K4); decoding filters on the
        posteriors' device; the scorers run on the host."""
        cfg = self.cfg
        predict = predict_fn if predict_fn is not None else self.predict
        params, stats = weights.export_train_model(self.state.model)
        pred_dfs = []
        # GT at original second resolution when available; frame-decoded
        # reconstruction (32 ms quantized) only as fallback
        true_events = loader.groundtruth_events()
        gt_events: Dict[str, list] = true_events if true_events is not None \
            else {}
        tagging = TaggingF1Accumulator(cfg.nclass)
        # under a group with the val set's own events, each rank forwards
        # and decodes every size-th batch (the frame-target fallback needs
        # every batch's targets on every rank, so it runs whole)
        shard = self.group is not None and true_events is not None
        for bi, (mel, target, names, n_valid) in enumerate(loader):
            if shard and bi % self.group.size != self.group.rank:
                continue
            strong, weak = predict(params, stats, mel,
                                   inference=cfg.model.use_fpn)
            strong, weak = strong[:n_valid], weak[:n_valid]
            names = names[:n_valid]
            pred_dfs.append(decode_batch(strong, names, cfg.bird_list, cfg,
                                         thresholds=thresholds,
                                         learned_post=learned_post))
            target = np.asarray(target)[:n_valid]
            if target.ndim == 3:
                if true_events is None:
                    gt_events.update(gt_events_from_frame_targets(
                        target, names, self.encoder_codec, cfg))
                tagging.update(weak, target.max(axis=1))
            else:
                tagging.update(weak, target)

        if shard:
            pred_dfs, tagging = self._gather_eval(pred_dfs, tagging)
        merged = merge_prediction_dfs(pred_dfs)
        pred_df = merged[thresholds[0]]
        gt_df = groundtruth_df_from_events(gt_events)
        results = {"weak_f1": tagging.macro_f1()}
        if len(gt_df):
            results["event_f1"] = event_based_f1(gt_df, pred_df)
            _, psds_f1, _ = compute_macro_f_score(pred_df, gt_df)
            results["psds_f1"] = psds_f1
        else:
            results["event_f1"] = 0.0
            results["psds_f1"] = 0.0
        return results

    def _gather_eval(self, pred_dfs, tagging):
        """Every rank's decoded batches, in batch order (rank r decoded
        batches r, r + size, ...), and the tagging counts summed over the
        group: the port of ``bsed_tpu``'s ``_allgather_eval``, with
        ``all_gather_object`` carrying the event tables."""
        import torch.distributed as dist

        counts = (tagging.tp, tagging.fp, tagging.fn, tagging.tn)
        local = (pred_dfs, counts)
        gathered = [None] * self.group.size
        dist.all_gather_object(gathered, local,
                               group=self.group.process_group)
        n = sum(len(dfs) for dfs, _ in gathered)
        ordered = [gathered[i % self.group.size][0][i // self.group.size]
                   for i in range(n)]
        summed = TaggingF1Accumulator(self.cfg.nclass)
        for attr, i in (("tp", 0), ("fp", 1), ("fn", 2), ("tn", 3)):
            setattr(summed, attr, sum(c[i] for _, c in gathered))
        return ordered, summed

    # ------------------------------------------------------------------
    def fit(self, n_epochs: Optional[int] = None,
            start_epoch: int = 0) -> Dict[str, float]:
        cfg = self.cfg
        n_epochs = n_epochs if n_epochs is not None else cfg.train.n_epoch
        if self.use_tensorboard and self.writer is None and self.is_writer:
            # purge on resume in STEP units, matching how train_epoch
            # indexes its scalars (the reference's epoch-unit purge_step,
            # main_baseline.py:656, would wipe nearly all earlier curves)
            self.writer = summary_writer(
                os.path.join(self.store_dir, "log"),
                purge_step=start_epoch * len(self.train_loader)
                if start_epoch > 0 else None)
        if start_epoch > 0:
            self.resume(start_epoch)
        best = {}
        for epoch in range(start_epoch, n_epochs):
            if self.profile_dir and epoch == start_epoch:
                from bsed_tpu_torch.utils.profiling import trace
                with trace(self.profile_dir):
                    train_metrics = self.train_epoch(epoch)
            else:
                train_metrics = self.train_epoch(epoch)
            row = {"epoch": epoch, **train_metrics}
            if self.syn_eval_loader is not None:
                syn_scores = self.evaluate(self.syn_eval_loader)
                row.update({f"syn_{k}": v for k, v in syn_scores.items()})
            if self.val_loader is not None:
                val_scores = self.evaluate(self.val_loader,
                                           predict_fn=self.predict_val)
                row.update({f"val_{k}": v for k, v in val_scores.items()})
                metric_key = ("val_weak_f1"
                              if cfg.train.best_metric == "weak_f1"
                              else "val_event_f1")
                score = row.get(metric_key, 0.0)
                if self.writer is not None:
                    # val scalars at the END-OF-EPOCH global step, so the
                    # step-unit purge_step on resume covers them too
                    self.writer.add_scalar(
                        metric_key, score,
                        (epoch + 1) * len(self.train_loader))
                if cfg.train.checkpoint_epochs and \
                        epoch % cfg.train.checkpoint_epochs == 0:
                    self._on_rank0(self.ckpt.save, f"epoch_{epoch}",
                                   self.state)
                if self.saver.apply(score, epoch):
                    self._on_rank0(self.ckpt.save, "best", self.state)
                    best = dict(row)
                if self.early_stopping is not None and \
                        self.early_stopping.apply(score, epoch):
                    self.log.info("Early stopping at epoch %d", epoch)
                    self.history.append(row)
                    break
            else:
                if cfg.train.checkpoint_epochs and \
                        epoch % cfg.train.checkpoint_epochs == 0:
                    self._on_rank0(self.ckpt.save, f"epoch_{epoch}",
                                   self.state)
            self.history.append(row)
        self._on_rank0(self._write_results)
        return best or (self.history[-1] if self.history else {})

    def _write_results(self) -> None:
        """results.tsv: one row per epoch of this run, the columns the
        union of the rows' keys in first-seen order (what
        ``pandas.DataFrame(rows).to_csv(sep='\\t', index=False)`` writes),
        a missing value an empty field."""
        if not self.history:
            return
        columns = list(dict.fromkeys(k for row in self.history for k in row))
        with open(os.path.join(self.store_dir, "results.tsv"), "w",
                  newline="") as fh:
            writer = csv.DictWriter(fh, columns, delimiter="\t",
                                    restval="", lineterminator="\n")
            writer.writeheader()
            writer.writerows(self.history)
