"""Checkpoint evaluation — the reference's TestModel.py as a library.

Port of ``bsed_tpu/eval/test_model.py`` (reference src/TestModel.py: load
the best checkpoint, rebuild model/encoder/median-window state from it
(:34-120), run ``get_predictions`` + ``compute_metrics`` on the validation
set and write a cross-trigger confusion-matrix CSV (:262-265)).

The checkpoint source is either this framework's own store
(``store_dir``: the student's trees of a tag, ``utils/checkpoint.py``) or
the reference's torch pickle, in the layout ``bsed_tpu`` reads and writes
(``load_torch_checkpoint`` / ``export_torch_checkpoint`` round-trip with
its functions).

On the card the whole path runs there: the loader's features are resident
(``data.pipeline.EvalLoader``), ``train.steps.make_predict_fn`` runs the
folded stem with kernel K2 and the BiGRU on kernel K4, and decoding
binarizes and median-filters the posteriors on the card before one copy
of the binary events to the host; the scorers run on the host.
"""
from __future__ import annotations

import csv
import time
from typing import Dict, Optional

import numpy as np
import torch

from bsed_tpu_torch.config import Config
from bsed_tpu_torch.data.codec import ManyHotEncoder
from bsed_tpu_torch.eval.decode import (decode_batch,
                                        groundtruth_df_from_events,
                                        gt_events_from_frame_targets,
                                        merge_prediction_dfs)
from bsed_tpu_torch.eval.psds import compute_macro_f_score
from bsed_tpu_torch.eval.sed_scores import (event_based_counts,
                                            per_class_report)
from bsed_tpu_torch.train.steps import TrainModules, make_predict_fn
from bsed_tpu_torch.utils import torch_compat as tc
from bsed_tpu_torch.utils.checkpoint import CheckpointManager
from bsed_tpu_torch.utils.device import resolve_device
from bsed_tpu_torch.utils.logger import create_logger
from bsed_tpu_torch.utils.tables import missing

log = create_logger("bsed_tpu_torch/test_model")


def load_torch_checkpoint(path: str, cfg: Config):
    """Reference torch pickle → (params, batch_stats), flax-layout trees of
    numpy arrays (``utils/weights.py``)."""
    if cfg.model.predictor_head == "crnn":
        raise ValueError(
            "predictor_head='crnn' has no reference checkpoint layout to "
            "load from: the reference's CRNN_pred-as-head wiring "
            "(main_scmt_ada_weak_seperate_2_crnn.py:673-687) is commented "
            "out; only the 'linear' and 'mlp' heads round-trip")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    crnn_sd = ckpt["model"]["state_dict"]
    pred_sd = ckpt["model_p"]["state_dict"]
    params, stats = tc.convert_crnn(
        {k: v for k, v in crnn_sd.items()},
        n_blocks=len(cfg.model.nb_filters),
        num_layers_rnn=cfg.model.n_layers_rnn,
        activation=cfg.model.activation,
        fpn=cfg.model.use_fpn)
    p_params = tc.convert_predictor({k: v for k, v in pred_sd.items()})
    return ({"encoder": params, "predictor": p_params},
            {"encoder": stats})


def export_torch_checkpoint(cfg: Config, params: Dict, batch_stats: Dict,
                            path: str, epoch: int = 0) -> str:
    """(params, batch_stats) → reference torch pickle.

    Writes the exact layout the reference saves (main_baseline.py:895-971)
    and its TestModel.py consumes — incl. rebuildable ``kwargs`` — so a
    model trained here can be evaluated/resumed by the reference's own
    tooling. Inverse of ``load_torch_checkpoint``."""
    m = cfg.model
    if m.predictor_head == "crnn":
        raise ValueError(
            "predictor_head='crnn' has no reference checkpoint layout to "
            "export to (see load_torch_checkpoint); only 'linear' and "
            "'mlp' heads round-trip")
    crnn_sd = tc.export_crnn(params["encoder"], batch_stats["encoder"],
                             n_blocks=len(m.nb_filters),
                             num_layers_rnn=m.n_layers_rnn,
                             activation=m.activation, fpn=m.use_fpn)
    pred_sd = tc.export_predictor(params["predictor"])
    as_t = lambda sd: {k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in sd.items()}
    n = len(m.nb_filters)
    crnn_kwargs = {
        "n_in_channel": 1, "nclass": cfg.nclass, "attention": True,
        "n_RNN_cell": m.n_rnn_cell, "n_layers_RNN": m.n_layers_rnn,
        "activation": m.activation, "dropout": m.dropout,
        "kernel_size": n * [m.kernel_size], "padding": n * [1],
        "stride": n * [1], "nb_filters": list(m.nb_filters),
        "pooling": [list(p) for p in m.pooling],
    }
    encoder = ManyHotEncoder(cfg.bird_list, n_frames=cfg.n_frames,
                             sr=cfg.audio.sr, hop_size=cfg.audio.hop_size,
                             pooling_time_ratio=m.pooling_time_ratio)
    torch.save({
        "model": {"name": "CRNN_fpn" if m.use_fpn else "CRNN", "args": "",
                  "kwargs": crnn_kwargs, "state_dict": as_t(crnn_sd)},
        "model_p": {"name": ("Predictor_2" if m.predictor_head == "mlp"
                             else "Predictor"), "args": "",
                    "kwargs": {"nclass": cfg.nclass, "attention": True,
                               "n_RNN_cell": m.n_rnn_cell},
                    "state_dict": as_t(pred_sd)},
        "pooling_time_ratio": m.pooling_time_ratio,
        "many_hot_encoder": encoder.state_dict(),
        "median_window": cfg.median_window,
        "epoch": epoch,
    }, path)
    return path


def load_params(cfg: Config, store_dir: Optional[str] = None,
                torch_ckpt: Optional[str] = None, tag: str = "best"):
    """(params, batch_stats) of the student, flax-layout numpy trees: from
    the reference pickle ``torch_ckpt`` when given, else from ``tag`` of
    the store ``store_dir``."""
    if torch_ckpt is not None:
        return load_torch_checkpoint(torch_ckpt, cfg)
    trees = CheckpointManager(store_dir).load(tag)
    return trees["params"], trees["batch_stats"]


def _write_confusion_csv(path: str, ct: np.ndarray, classes) -> None:
    """The cross-trigger matrix with class names as header and index (what
    ``bsed_tpu`` writes with ``DataFrame.to_csv``)."""
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow([""] + list(classes))
        for name, row in zip(classes, ct):
            writer.writerow([name] + [repr(float(v)) for v in row])


def evaluate_checkpoint(cfg: Config, loader,
                        store_dir: Optional[str] = None,
                        torch_ckpt: Optional[str] = None,
                        tag: str = "best",
                        thresholds=(0.5,),
                        learned_post: bool = False,
                        confusion_csv: Optional[str] = None,
                        device="cuda", use_kernels: bool = True,
                        keep_posteriors: bool = False) -> Dict:
    """Score a checkpoint on ``loader``'s clips
    (``data.pipeline.EvalLoader``): the student of ``tag`` in the store
    ``store_dir``, or the reference-format pickle ``torch_ckpt`` (which
    wins when both are given); ``{"event_f1", "psds_f1",
    "per_class_f1"}`` (plus ``"event_f1_per_threshold"`` with several
    thresholds), as ``bsed_tpu``'s function returns them.

    The port adds: ``device`` (the card by default; raises if none is
    present) and ``use_kernels`` (False runs the kernels' plain versions);
    ``"seconds"``, the wall time of each phase (load: checkpoint, model and
    the loader's arrays; predict; decode, on the posteriors' device up to
    the event tables; score, on the host), the device synchronised at each
    phase's end; ``"posteriors"``, the strong posteriors of every clip as
    one (N, T', C) float32 numpy array, with ``keep_posteriors``."""
    if store_dir is None and torch_ckpt is None:
        raise ValueError("evaluate_checkpoint needs store_dir or torch_ckpt")
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    seconds = {"load": 0.0, "predict": 0.0, "decode": 0.0, "score": 0.0}
    t0 = time.perf_counter()
    params, stats = load_params(cfg, store_dir, torch_ckpt, tag)
    predict = make_predict_fn(TrainModules(cfg, dev, use_kernels))
    predict.prepare(params, stats)
    codec = ManyHotEncoder(cfg.bird_list, n_frames=cfg.n_frames,
                           sr=cfg.audio.sr, hop_size=cfg.audio.hop_size,
                           pooling_time_ratio=cfg.model.pooling_time_ratio)
    if hasattr(loader, "prepare"):
        loader.prepare()
    # GT at original second resolution (evaluation_measures.py:226-248);
    # frame-decoded reconstruction only when annotations are unavailable
    true_events = loader.groundtruth_events()
    gt_events = true_events if true_events is not None else {}
    sync()
    seconds["load"] = time.perf_counter() - t0

    pred_dfs, kept = [], []
    for mel, target, names, n_valid in loader:
        t0 = time.perf_counter()
        strong, _ = predict(params, stats, mel,
                            inference=cfg.model.use_fpn)
        strong = strong[:n_valid]
        sync()
        t1 = time.perf_counter()
        names = names[:n_valid]
        pred_dfs.append(decode_batch(strong, names, cfg.bird_list, cfg,
                                     thresholds=thresholds,
                                     learned_post=learned_post))
        if true_events is None:
            gt_events.update(gt_events_from_frame_targets(
                np.asarray(target)[:n_valid], names, codec, cfg))
        t2 = time.perf_counter()
        seconds["predict"] += t1 - t0
        seconds["decode"] += t2 - t1
        if keep_posteriors:
            kept.append(strong.cpu().numpy())

    t0 = time.perf_counter()
    merged = merge_prediction_dfs(pred_dfs)
    gt_df = groundtruth_df_from_events(gt_events)

    # score EVERY requested threshold (the primary/reported one is
    # thresholds[0], matching the reference's single 0.5 headline —
    # evaluation_measures.py:518-526); extra thresholds land in
    # per_threshold instead of being silently discarded
    per_threshold = {}
    for thr in thresholds:
        c = event_based_counts(gt_df, merged[thr])
        per_threshold[thr] = float(
            np.mean([cc.f_measure for cc in c.values()])) if c else 0.0
    pred_df = merged[thresholds[0]]
    counts = event_based_counts(gt_df, pred_df)
    event_f1 = per_threshold[thresholds[0]]
    ct, psds_f1, per_class = compute_macro_f_score(pred_df, gt_df)
    log.info("event F1=%.4f  psds F1=%.4f", event_f1, psds_f1)
    report = per_class_report(counts)
    log.info("\n%s", "\n".join(
        "\t".join(str(v) for v in row)
        for row in zip(*([k] + list(v) for k, v in report.items()))))

    if confusion_csv:
        classes = sorted({c for c in gt_df.event_label if not missing(c)}
                         | {c for c in pred_df.event_label
                            if not missing(c)})
        _write_confusion_csv(confusion_csv, ct, classes)

    results = {"event_f1": event_f1, "psds_f1": psds_f1,
               "per_class_f1": {k: c.f_measure for k, c in counts.items()}}
    if len(thresholds) > 1:
        results["event_f1_per_threshold"] = per_threshold
    seconds["score"] = time.perf_counter() - t0
    results["seconds"] = seconds
    if keep_posteriors:
        results["posteriors"] = np.concatenate(kept)
    return results
