"""PSDS-style intersection-criterion scoring with cross-trigger accounting.

Port of ``bsed_tpu/eval/psds.py``; detections and ground truth are
``utils.tables.EventTable``s where ``bsed_tpu`` takes pandas DataFrames,
and ``compute_macro_f_score`` returns the per-class F1 as a dict where it
returns a pandas Series. psds_eval is not a dependency; this module
natively implements what the reference uses it for (reference
src/evaluation_measures.py:505-526):

  * ``compute_macro_f_score`` — per-class F1 at one operating point where
    true positives are defined by the PSDS intersection criteria (Bilen et
    al. 2020) instead of collars:
      - DTC (detection tolerance): a detection is valid when the fraction of
        its duration intersecting same-class ground truth >= dtc_threshold.
      - GTC (ground-truth intersection): a ground-truth event is detected
        when the fraction of its duration covered by DTC-valid detections
        >= gtc_threshold.
    FP = DTC-invalid detections; FN = undetected ground truths.
  * the cross-trigger (CT) confusion matrix — DTC-invalid detections whose
    intersection with OTHER-class ground truth meets cttc_threshold.
  * multi-operating-point PSDS: area under the mean-TPR vs effective-FPR
    curve with cross-trigger (alpha_ct) and across-class-variance (alpha_st)
    penalties, normalized to max_efpr.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bsed_tpu_torch.eval.sed_scores import group_by_file_class
from bsed_tpu_torch.utils.tables import EventTable, missing


def _intersections(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise intersection durations between (N,2) and (M,2) intervals."""
    if not len(a) or not len(b):
        return np.zeros((len(a), len(b)))
    lo = np.maximum(a[:, None, 0], b[None, :, 0])
    hi = np.minimum(a[:, None, 1], b[None, :, 1])
    return np.maximum(0.0, hi - lo)


@dataclasses.dataclass
class OperatingPointCounts:
    classes: List[str]
    tp: np.ndarray        # (C,) ground truths detected
    fp: np.ndarray        # (C,) DTC-invalid detections
    n_ref: np.ndarray     # (C,) ground-truth event counts
    ct: np.ndarray        # (C, C) cross-trigger counts [detected_as, gt_class]
    # (C,) total ground-truth annotation duration per class in seconds —
    # the PSDS cross-trigger rate CTR_{c,k} normalizes CT counts by the
    # OTHER class's annotation duration T_k (Bilen et al. 2020, eq. 3)
    gt_dur: Optional[np.ndarray] = None


def evaluate_operating_point(
    detections: EventTable,
    ground_truth: EventTable,
    dtc_threshold: float = 0.5,
    gtc_threshold: float = 0.5,
    cttc_threshold: float = 0.3,
    classes: Optional[Sequence[str]] = None,
) -> OperatingPointCounts:
    if classes is None:
        classes = sorted({c for c in ground_truth.event_label
                          if not missing(c)} |
                         {c for c in detections.event_label
                          if not missing(c)})
    classes = list(classes)
    idx = {c: i for i, c in enumerate(classes)}
    n = len(classes)
    tp = np.zeros(n)
    fp = np.zeros(n)
    n_ref = np.zeros(n)
    ct = np.zeros((n, n))

    det_map = group_by_file_class(detections, False)
    gt_map = group_by_file_class(ground_truth, False)

    gt_dur = np.zeros(n)
    for fname, gt_classes in gt_map.items():
        for label, ev in gt_classes.items():
            if label in idx:
                n_ref[idx[label]] += len(ev)
                gt_dur[idx[label]] += float((ev[:, 1] - ev[:, 0]).sum())

    files = set(det_map) | set(gt_map)
    for fname in files:
        dets = det_map.get(fname, {})
        gts = gt_map.get(fname, {})
        for label, det_ev in dets.items():
            if label not in idx:
                continue
            c = idx[label]
            gt_ev = gts.get(label, np.zeros((0, 2)))
            inter = _intersections(det_ev, gt_ev)        # (ndet, ngt)
            det_dur = det_ev[:, 1] - det_ev[:, 0]
            det_dur = np.maximum(det_dur, 1e-12)
            dtc_frac = inter.sum(axis=1) / det_dur
            dtc_valid = dtc_frac >= dtc_threshold
            fp[c] += int((~dtc_valid).sum())

            if len(gt_ev):
                ev_dur = np.maximum(gt_ev[:, 1] - gt_ev[:, 0], 1e-12)
                covered = inter[dtc_valid].sum(axis=0) / ev_dur
                tp[c] += int((covered >= gtc_threshold).sum())

            # cross-triggers: DTC-invalid detections vs other-class GT
            invalid_ev = det_ev[~dtc_valid]
            if len(invalid_ev):
                for other, o_ev in gts.items():
                    if other == label or other not in idx:
                        continue
                    o_inter = _intersections(invalid_ev, o_ev)
                    frac = o_inter.sum(axis=1) / np.maximum(
                        invalid_ev[:, 1] - invalid_ev[:, 0], 1e-12)
                    ct[c, idx[other]] += int((frac >= cttc_threshold).sum())

    return OperatingPointCounts(classes, tp, fp, n_ref, ct, gt_dur)


def compute_macro_f_score(detections: EventTable,
                          ground_truth: EventTable,
                          dtc_threshold: float = 0.5,
                          gtc_threshold: float = 0.5,
                          cttc_threshold: float = 0.3
                          ) -> Tuple[np.ndarray, float, Dict[str, float]]:
    """Mirror of PSDSEval.compute_macro_f_score's return contract used at
    evaluation_measures.py:522-523: (ct_matrix, macro_f1, per_class_f1),
    the last as {class: F1} in class order."""
    op = evaluate_operating_point(detections, ground_truth, dtc_threshold,
                                  gtc_threshold, cttc_threshold)
    fn = op.n_ref - op.tp
    denom = 2 * op.tp + op.fp + fn
    f1 = np.where(denom > 0, 2 * op.tp / np.maximum(denom, 1), 0.0)
    per_class = {c: float(v) for c, v in zip(op.classes, f1)}
    return op.ct, float(f1.mean()) if len(f1) else 0.0, per_class


@dataclasses.dataclass
class PSDSResult:
    value: float
    efpr: np.ndarray
    etpr: np.ndarray


def psds_score_report(operating_points: Sequence[OperatingPointCounts],
                      total_duration_s: float) -> Dict[str, float]:
    """The reference's three headline PSDS variants
    (evaluation_measures.py:294-303): (α_ct, α_st) = (0,0), (1,0), (0,1),
    all at max_efpr=100."""
    out = {}
    for name, a_ct, a_st in (("psds_ct0_st0", 0.0, 0.0),
                             ("psds_ct1_st0", 1.0, 0.0),
                             ("psds_ct0_st1", 0.0, 1.0)):
        out[name] = compute_psds(operating_points, total_duration_s,
                                 alpha_ct=a_ct, alpha_st=a_st,
                                 max_efpr=100.0).value
    return out


def _class_rates(op: OperatingPointCounts, hours: float, alpha_ct: float
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(efpr_c, tpr_c) per class for one operating point.

    TPR_c = TP_c / N_c;  FPR_c = FP_c / dataset hours (per-hour rate);
    CTR_{c,k} = CT_{c,k} / T_k with T_k the total annotated duration of
    class k in hours (Bilen et al. 2020 eq. 3 — cross-triggers are rated
    against the OTHER class's annotation duration);
    eFPR_c = FPR_c + alpha_ct · mean_{k≠c} CTR_{c,k}  (eq. 4)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        tpr = np.where(op.n_ref > 0, op.tp / np.maximum(op.n_ref, 1), 0.0)
    fpr = op.fp / hours
    n = len(op.classes)
    if alpha_ct == 0.0 or n <= 1:
        return fpr, tpr
    gt_dur = op.gt_dur
    if gt_dur is None:       # legacy counts without durations: rate against
        gt_dur = np.full(n, hours * 3600.0)   # the dataset duration
    dur_h = np.maximum(gt_dur / 3600.0, 1e-12)
    ctr = op.ct / dur_h[None, :]                       # (C, C) per hour
    off_diag_mean = (ctr.sum(axis=1) - np.diag(ctr)) / (n - 1)
    return fpr + alpha_ct * off_diag_mean, tpr


def _support_curve(xs: np.ndarray, ys: np.ndarray, max_x: float
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Monotone ROC support curve through (0,0): sort by x, running-max y,
    one point per unique x, points beyond max_x dropped (a TPR only
    achievable at an inadmissible eFPR must not enter the integration)."""
    keep = xs <= max_x
    xs = np.concatenate([[0.0], xs[keep]])
    ys = np.concatenate([[0.0], ys[keep]])
    order = np.argsort(xs, kind="stable")
    xs, ys = xs[order], np.maximum.accumulate(ys[order])
    ux, last = np.unique(xs, return_index=False), None
    # per unique x keep the max (== last after running max)
    out_y = np.empty_like(ux)
    j = 0
    for i, x in enumerate(ux):
        while j < len(xs) and xs[j] == x:
            last = ys[j]
            j += 1
        out_y[i] = last
    return ux, out_y


def _align_classes(
    ops: Sequence[OperatingPointCounts],
) -> Tuple[List[str], List[OperatingPointCounts]]:
    """Re-index every operating point onto the union class list.

    ``evaluate_operating_point`` with ``classes=None`` derives each OP's
    class list from groundtruth ∪ detections, so a class detected only at
    some thresholds appears in some OPs and not others; stacking those
    per-class arrays positionally would crash (ragged) or silently pair
    different classes. A class absent from an OP had no groundtruth and no
    detections there, so zero counts are its exact values."""
    union = sorted(set().union(*(op.classes for op in ops)))
    if all(list(op.classes) == union for op in ops):
        return union, list(ops)
    idx = {c: i for i, c in enumerate(union)}
    n = len(union)
    aligned = []
    for op in ops:
        rows = np.asarray([idx[c] for c in op.classes], dtype=int)
        tp = np.zeros(n)
        fp = np.zeros(n)
        n_ref = np.zeros(n)
        ct = np.zeros((n, n))
        tp[rows] = op.tp
        fp[rows] = op.fp
        n_ref[rows] = op.n_ref
        ct[np.ix_(rows, rows)] = op.ct
        gt_dur = None
        if op.gt_dur is not None:
            gt_dur = np.zeros(n)
            gt_dur[rows] = op.gt_dur
        aligned.append(OperatingPointCounts(union, tp, fp, n_ref, ct,
                                            gt_dur))
    return union, aligned


def compute_psds(
    operating_points: Sequence[OperatingPointCounts],
    total_duration_s: float,
    alpha_ct: float = 0.0,
    alpha_st: float = 0.0,
    max_efpr: float = 100.0,
) -> PSDSResult:
    """PSDS via the psds_eval PSD-ROC construction (the algorithm behind
    ``psds.psds(alpha_ct, alpha_st, max_efpr)`` that the reference calls at
    evaluation_measures.py:287-315; Bilen et al., ICASSP 2020):

      1. per class, collect (eFPR_c, TPR_c) over all operating points (with
         the alpha_ct cross-trigger term folded into each class's eFPR) and
         take the monotone ROC *support* curve through (0, 0);
      2. linearly interpolate every class's support curve onto the union
         grid of all classes' eFPR values (constant beyond its last point);
      3. effective TPR(e) = mean_c TPR_c(e) − alpha_st · std_c TPR_c(e),
         clamped at 0 (std is the population std across classes, eq. 9);
      4. PSDS = ∫_0^{max_efpr} eTPR(e) de / max_efpr — trapezoidal, exact
         for the piecewise-linear interpolated curve.

    This is structurally different from collapsing each OP to one
    (mean eFPR, mean TPR − α·std) point: per-class interpolation lets each
    class contribute its best admissible TPR at every eFPR, which is what
    psds_eval reports. The old pointwise estimator remains available as
    ``compute_psds_pointwise`` (fast preview)."""
    hours = total_duration_s / 3600.0
    if not operating_points:
        grid = np.asarray([0.0, max_efpr])
        return PSDSResult(0.0, grid, np.zeros(2))
    classes, operating_points = _align_classes(operating_points)
    n = len(classes)
    per_op = [_class_rates(op, hours, alpha_ct) for op in operating_points]
    efpr_mat = np.stack([e for e, _ in per_op])        # (n_ops, C)
    tpr_mat = np.stack([t for _, t in per_op])

    curves_x, curves_y = [], []
    for c in range(n):
        xs, ys = _support_curve(efpr_mat[:, c], tpr_mat[:, c], max_efpr)
        curves_x.append(xs)
        curves_y.append(ys)

    grid = np.unique(np.concatenate(curves_x + [[0.0, max_efpr]]))
    grid = grid[grid <= max_efpr]
    interp = np.stack([np.interp(grid, xs, ys)
                       for xs, ys in zip(curves_x, curves_y)])   # (C, G)
    etpr = np.maximum(interp.mean(axis=0)
                      - alpha_st * interp.std(axis=0), 0.0)
    value = float(np.trapezoid(etpr, grid)) / max_efpr
    return PSDSResult(value, grid, etpr)


def compute_psds_pointwise(
    operating_points: Sequence[OperatingPointCounts],
    total_duration_s: float,
    alpha_ct: float = 0.0,
    alpha_st: float = 0.0,
    max_efpr: float = 100.0,
) -> PSDSResult:
    """Fast preview estimator (NOT psds_eval's algorithm): collapse each
    operating point to one (mean eFPR, mean TPR − alpha_st·std) point and
    integrate the upper envelope. Kept for cheap epoch-level monitoring;
    report ``compute_psds`` numbers."""
    hours = total_duration_s / 3600.0
    pts = [(0.0, 0.0)]
    for op in operating_points:
        efpr_c, tpr_c = _class_rates(op, hours, alpha_ct)
        e_fpr = float(np.mean(efpr_c))
        e_tpr = float(np.mean(tpr_c) - alpha_st * np.std(tpr_c))
        pts.append((e_fpr, max(0.0, e_tpr)))

    pts = [(x, y) for x, y in pts if x <= max_efpr]
    pts.sort()
    xs, ys = [0.0], [0.0]
    best = 0.0
    for x, y in pts:
        best = max(best, y)
        xs.append(x)
        ys.append(best)
    xs.append(max_efpr)
    ys.append(best)
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    auc = float(np.trapezoid(ys, xs))
    return PSDSResult(auc / max_efpr, xs, ys)
