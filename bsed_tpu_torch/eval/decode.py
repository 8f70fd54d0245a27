"""Posterior → event-list decoding.

Port of ``bsed_tpu/eval/decode.py`` (reference
src/evaluation_measures.py:123-283, ``get_predictions``). The per-clip,
per-threshold host loop (binarize → scipy median filter → contiguous
regions → seconds) becomes:

  1. one pass binarizing + median-filtering ALL clips and ALL thresholds
     at once on the posteriors' device (ops/median.py),
  2. a single device→host transfer (as uint8),
  3. vectorized numpy run-length extraction per clip into event tables.

Where ``bsed_tpu`` returns pandas DataFrames, these functions return
``utils.tables.EventTable``s with the same columns, rows and dtypes;
``durations_df`` returns its two columns as a dict of numpy arrays.

Frame→second conversion matches the reference exactly:
``pooling_time_ratio / (sr / hop_size)`` seconds per pooled frame, clipped
to [0, max_len_seconds] (evaluation_measures.py:208-209).
"""
from __future__ import annotations

import csv
import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from bsed_tpu_torch.config import Config
from bsed_tpu_torch.ops.median import threshold_and_filter
from bsed_tpu_torch.utils.tables import EventTable


def decode_batch(
    strong_probs,
    filenames: Sequence[str],
    labels: Sequence[str],
    cfg: Config,
    thresholds: Sequence[float] = (0.5,),
    learned_post: bool = False,
) -> Dict[float, EventTable]:
    """(B, T, C) frame posteriors → {threshold: events table}.

    ``strong_probs`` is a tensor, filtered on its own device, or a numpy
    array, filtered on the CPU. Table columns: event_label, onset, offset
    (seconds), filename.
    """
    thresholds = list(thresholds)
    probs = torch.as_tensor(strong_probs)
    windows = cfg.median_window_classwise if learned_post else None
    filtered = threshold_and_filter(probs, thresholds,
                                    window=cfg.median_window,
                                    windows=windows)
    filtered = filtered.to(torch.uint8).cpu().numpy()    # (K, B, T, C)

    sec_per_frame = cfg.model.pooling_time_ratio / (cfg.audio.sr / cfg.audio.hop_size)
    k_idx, b_idx, c_idx, on_t, off_t = extract_events_batch(filtered)
    onset = np.clip(on_t * sec_per_frame, 0.0, cfg.audio.max_len_seconds)
    offset = np.clip(off_t * sec_per_frame, 0.0, cfg.audio.max_len_seconds)
    label_arr = np.asarray(labels, dtype=object)
    fname_arr = np.asarray(list(filenames), dtype=object)

    out: Dict[float, EventTable] = {}
    for k, th in enumerate(thresholds):
        m = k_idx == k
        out[th] = EventTable(label_arr[c_idx[m]], onset[m], offset[m],
                             fname_arr[b_idx[m]])
    return out


def extract_events_batch(act: np.ndarray):
    """All contiguous 1-runs of a (K, B, T, C) binary activity tensor in one
    vectorized pass (no per-clip/per-class Python loop — the reference loops
    clip × threshold × class on host, evaluation_measures.py:188-215).

    Returns (k_idx, b_idx, c_idx, onset_frame, offset_frame) int arrays, one
    entry per event, offsets exclusive, ordered lexicographically by
    (k, b, c, onset). Equivalent to find_contiguous_regions per column.
    """
    k, b, t, c = act.shape
    # (K, B, C, T) zero-padded along time: diff == +1 at onsets, -1 at the
    # frame AFTER the last active one (exclusive offset), both in-range.
    padded = np.zeros((k, b, c, t + 2), np.int8)
    padded[..., 1:-1] = act.transpose(0, 1, 3, 2)
    d = np.diff(padded, axis=-1)
    on_k, on_b, on_c, on_t = np.nonzero(d == 1)
    _, _, _, off_t = np.nonzero(d == -1)
    # np.nonzero is lexicographic in (k, b, c, t) and every run opens before
    # it closes, so onsets and offsets pair positionally within each column.
    # d[i] = padded[i+1] - padded[i] with padded[j] = a[j-1]: d[i] == +1 ⇒
    # a[i] starts a run (onset = i); d[i] == −1 ⇒ a[i-1] was the last active
    # frame (exclusive stop = i) — matching find_contiguous_regions exactly.
    return on_k, on_b, on_c, on_t, off_t


def merge_prediction_dfs(dfs: Sequence[Dict[float, EventTable]]
                         ) -> Dict[float, EventTable]:
    """Concatenate per-batch decodes into one table per threshold."""
    out: Dict[float, EventTable] = {}
    if not dfs:
        return out
    for th in dfs[0]:
        out[th] = EventTable.concat([d[th] for d in dfs])
    return out


def _cell(value) -> str:
    """A value as pandas' ``to_csv(float_format="%.3f")`` writes it."""
    if isinstance(value, (float, np.floating)):
        return "" if value != value else f"{value:.3f}"
    return "" if value is None else str(value)


def save_prediction_dfs(dfs, base_path: str) -> list:
    """Per-threshold prediction TSV dump (evaluation_measures.py:250-270):
    one file per threshold named <base>/<threshold:.3f>.tsv (single
    threshold: <base>.tsv). The bytes ``bsed_tpu`` writes with pandas."""
    thresholds = list(dfs)
    paths = []
    if len(thresholds) == 1:
        paths = [base_path if base_path.endswith(".tsv")
                 else base_path + ".tsv"]
    else:
        base, _ = os.path.splitext(base_path)
        os.makedirs(base, exist_ok=True)
        paths = [os.path.join(base, f"{th:.3f}.tsv") for th in thresholds]
    for th, path in zip(thresholds, paths):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        table = dfs[th]
        with open(path, "w", newline="") as fh:
            writer = csv.writer(fh, delimiter="\t", lineterminator="\n")
            writer.writerow(table.columns)
            writer.writerows([_cell(v) for v in row]
                             for row in table.rows())
    return paths


def gt_events_from_frame_targets(targets: np.ndarray, names: Sequence[str],
                                 codec, cfg: Config
                                 ) -> Dict[str, list]:
    """Fallback ground-truth reconstruction from (B, T_frames, C) frame
    targets when original-second annotations are unavailable: run-length
    decode each clip's target matrix and convert pooled-frame indices to
    seconds (quantized at pooling_time_ratio/(sr/hop) ≈ 32 ms — the
    second-resolution path via ``EvalLoader.groundtruth_events`` is
    preferred, evaluation_measures.py:226-248)."""
    sec = cfg.model.pooling_time_ratio / (cfg.audio.sr / cfg.audio.hop_size)
    out: Dict[str, list] = {}
    for b, name in enumerate(names):
        events = codec.decode_strong(targets[b])
        out[name] = [(label, a * sec, b_ * sec)
                     for (label, a, b_) in events]
    return out


def groundtruth_df_from_events(
    per_file_events: Dict[str, Sequence[Tuple[str, float, float]]]
) -> EventTable:
    rows = [(label, onset, offset, fname)
            for fname, events in per_file_events.items()
            for (label, onset, offset) in events]
    return EventTable.from_rows(rows)


def durations_df(filenames: Sequence[str], duration: float = 10.0
                 ) -> Dict[str, np.ndarray]:
    """Fixed clip-duration metadata (evaluation_measures.py:227-230):
    ``{"filename": ..., "duration": ...}`` columns."""
    uniq = list(dict.fromkeys(filenames))
    return {"filename": np.asarray(uniq, dtype=object),
            "duration": np.full(len(uniq), float(duration))}
