"""Epoch-level trainer: the config-driven replacement for the reference's
``__main__`` blocks (reference src/main_baseline.py:602-1093).

Port of ``bsed_tpu/train/trainer.py``:
  * build the student, the teacher and Adam (``train/steps.py``)
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

Not ported: data parallelism and the multi-host evaluation exchange
(ROADMAP item 9), dataset normalisation and the discriminator's re-init
at stage boundaries on resume (items 8a, 8b: ``build_modules`` refuses
those configurations).
"""
from __future__ import annotations

import csv
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

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
    """Port of ``bsed_tpu.train.trainer.Trainer``: the same arguments
    without ``mesh`` (one device; data parallelism is ROADMAP item 9),
    plus ``device`` (the card by default) and ``use_kernels`` (False runs
    the kernels' plain versions)."""

    def __init__(self, cfg: Config, train_loader, val_loader=None,
                 syn_eval_loader=None, store_dir: Optional[str] = None,
                 use_tensorboard: bool = False,
                 profile_dir: Optional[str] = None,
                 grad_flow: bool = False, scan_epoch: str = "auto",
                 device="cuda", use_kernels: bool = True):
        self.cfg = cfg
        # grad_flow: per-parameter mean-|grad| in the step metrics +
        # gradient_flow.png per epoch (plot_grad_flow, main_baseline.py:108)
        self.grad_flow = grad_flow
        # when set, the first trained epoch is captured as a torch.profiler
        # trace (utils/profiling.py)
        self.profile_dir = profile_dir
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.syn_eval_loader = syn_eval_loader
        # refuses the configurations the port cannot train yet, before
        # anything else is built
        self.modules: TrainModules = build_modules(cfg, device=device,
                                                   use_kernels=use_kernels)
        self.log = create_logger(f"bsed_tpu_torch/{cfg.model_name}")
        self.store_dir = store_dir or os.path.join("stored_data",
                                                   cfg.model_name)
        self.ckpt = CheckpointManager(self.store_dir)
        self.encoder_codec = ManyHotEncoder(
            cfg.bird_list, n_frames=cfg.n_frames, sr=cfg.audio.sr,
            hop_size=cfg.audio.hop_size,
            pooling_time_ratio=cfg.model.pooling_time_ratio)
        self.state = create_train_state(cfg, self.modules, cfg.train.seed)
        self.train_step = make_train_step(
            self.modules, steps_per_epoch=len(train_loader),
            grad_flow=grad_flow)
        # "auto": the resident path whenever the loader's arrays live on
        # the device; "off": the loop path always
        self.scan_epoch = scan_epoch
        self._epoch_runner = None
        self.predict = make_predict_fn(self.modules)
        self.saver = SaveBest("sup")
        self.early_stopping = (
            EarlyStopping(cfg.train.early_stopping, cfg.train.es_init_wait)
            if cfg.train.early_stopping else None)
        # created in fit(): a resume passes purge_step so re-run epochs
        # don't leave duplicate scalars (main_baseline.py:656)
        self.use_tensorboard = use_tensorboard
        self.writer = None
        self.history: list = []
        self.ckpt.save_meta({
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
            # train+syn scaler stats: normalisation is not ported yet
            "scaler": None,
        })

    # ------------------------------------------------------------------
    def resume(self, epoch: int) -> None:
        """Resume from epoch_<epoch-1>: student, teacher, Adam's moments
        and step count, into the live modules."""
        self.ckpt.restore(f"epoch_{epoch - 1}", self.state)

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
              if self.scan_epoch != "off"
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
        for mel, target, names, n_valid in loader:
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

    # ------------------------------------------------------------------
    def fit(self, n_epochs: Optional[int] = None,
            start_epoch: int = 0) -> Dict[str, float]:
        cfg = self.cfg
        n_epochs = n_epochs if n_epochs is not None else cfg.train.n_epoch
        if self.use_tensorboard and self.writer is None:
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
                val_scores = self.evaluate(self.val_loader)
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
                    self.ckpt.save(f"epoch_{epoch}", self.state)
                if self.saver.apply(score, epoch):
                    self.ckpt.save("best", self.state)
                    best = dict(row)
                if self.early_stopping is not None and \
                        self.early_stopping.apply(score, epoch):
                    self.log.info("Early stopping at epoch %d", epoch)
                    self.history.append(row)
                    break
            else:
                if cfg.train.checkpoint_epochs and \
                        epoch % cfg.train.checkpoint_epochs == 0:
                    self.ckpt.save(f"epoch_{epoch}", self.state)
            self.history.append(row)
        self._write_results()
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
