"""Multi-threshold operating-point sweep for PSDS.

Port of ``bsed_tpu/eval/operating_points.py``, with
``utils.tables.EventTable`` where ``bsed_tpu`` takes pandas DataFrames.

Reference flow: get_predictions over a list of thresholds →
PSDSEval.add_operating_point per threshold → psds_score
(evaluation_measures.py:123-283, 287-315, 505-510). Here the threshold
sweep runs in ONE batched pass on the posteriors' device
(ops/median.threshold_and_filter
binarizes + median-filters all K thresholds at once) and the host decodes
each threshold's events.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

from bsed_tpu_torch.config import Config
from bsed_tpu_torch.eval.decode import decode_batch, merge_prediction_dfs
from bsed_tpu_torch.eval.psds import (OperatingPointCounts,
                                      evaluate_operating_point,
                                      psds_score_report)
from bsed_tpu_torch.utils.tables import EventTable


def default_thresholds(n: int = 50) -> List[float]:
    """n evenly spaced operating points in (0, 1), the DCASE convention."""
    return [round((i + 1) / (n + 1), 4) for i in range(n)]


def sweep_operating_points(
    predict_batches: Iterable,
    cfg: Config,
    ground_truth: EventTable,
    thresholds: Sequence[float] = None,
    dtc_threshold: float = 0.5,
    gtc_threshold: float = 0.5,
    cttc_threshold: float = 0.3,
    total_duration_s: float = None,
) -> Dict:
    """predict_batches yields (strong_probs (B,T,C), filenames). Returns
    {'operating_points': [...], 'psds': {...}, 'predictions': {...}}.

    Classes cover the FULL label set (cfg.bird_list) so false positives of
    classes absent from the ground truth are counted; dataset duration is
    derived from the number of EVALUATED clips (including event-free ones),
    overridable via ``total_duration_s``.
    """
    thresholds = list(thresholds or default_thresholds())
    per_batch = []
    eval_files = set()
    for probs, names in predict_batches:
        per_batch.append(decode_batch(probs, names, cfg.bird_list, cfg,
                                      thresholds=thresholds))
        eval_files.update(names)
    merged = merge_prediction_dfs(per_batch)

    classes = list(cfg.bird_list)
    n_files = len(eval_files) or len(set(ground_truth.filename)) or 1
    total_duration = (total_duration_s if total_duration_s is not None
                      else n_files * cfg.audio.max_len_seconds)

    ops: List[OperatingPointCounts] = []
    for th in thresholds:
        ops.append(evaluate_operating_point(
            merged[th], ground_truth, dtc_threshold, gtc_threshold,
            cttc_threshold, classes=classes))

    return {
        "thresholds": thresholds,
        "operating_points": ops,
        "predictions": merged,
        "psds": psds_score_report(ops, total_duration),
        # exposed so callers recomputing PSDS variants (ROC dumps) use the
        # SAME duration basis as the report above
        "total_duration_s": total_duration,
    }
