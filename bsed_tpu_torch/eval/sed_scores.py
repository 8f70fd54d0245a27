"""Event-based and segment-based SED metrics.

Port of ``bsed_tpu/eval/sed_scores.py``; event tables are
``utils.tables.EventTable``s where ``bsed_tpu`` takes pandas DataFrames,
and ``per_class_report`` returns its columns as a dict of numpy arrays.
sed_eval is not a dependency, so this module natively implements the
metrics the reference computes through it (reference
src/evaluation_measures.py:47-120, 318-325), following the
published definitions (Mesaros et al. 2016, "Metrics for polyphonic sound
event detection"):

  * Event-based: an estimated event matches a reference event of the same
    class in the same file when |onset difference| <= t_collar and
    |offset difference| <= max(t_collar, percentage_of_length * ref
    duration) (both conditions inclusive). Matching is one-to-one MAXIMUM
    bipartite matching over the hit matrix — sed_eval resolves collisions
    with its ``_bipartite_match`` (Hopcroft–Karp-style augmenting paths),
    NOT greedily, and a greedy matcher undercounts TPs whenever an earlier
    reference event takes the only estimate a later reference could use
    (pinned by golden fixtures in the tests). Class-wise
    F1 = 2·TP / (Nref + Nsys); the headline number is the class-wise
    (macro) average over the union of classes present in reference and
    estimate, with empty system output scoring zero ('zero_score' handling,
    evaluation_measures.py:72).
  * Segment-based: activity is rasterized into fixed-length segments per
    file; per-class TP/FP/FN counted per segment.

File-set semantics (both metrics): only files present in the REFERENCE
dataframe are evaluated (evaluation_measures.py:61,100) — the reference's
groundtruth assembly concatenates per-clip annotation txts, so clips with
zero events contribute no rows and system detections in them are never
counted as false positives. (psds_eval differs: it scores detections in
every file — see eval/psds.py.)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from bsed_tpu_torch.utils.tables import EventTable, missing


@dataclasses.dataclass
class ClassCounts:
    tp: int = 0
    n_ref: int = 0
    n_sys: int = 0

    @property
    def precision(self) -> float:
        return self.tp / self.n_sys if self.n_sys else 0.0

    @property
    def recall(self) -> float:
        return self.tp / self.n_ref if self.n_ref else 0.0

    @property
    def f_measure(self) -> float:
        denom = self.n_ref + self.n_sys
        return 2.0 * self.tp / denom if denom else 0.0


def _classes_union(reference: EventTable, estimated: EventTable
                   ) -> List[str]:
    classes = set()
    for t in (reference, estimated):
        classes.update(c for c in t.event_label if not missing(c))
    return sorted(classes)


def _evaluated_files(reference: EventTable) -> List[str]:
    """The set of files that gets scored at all: the reference table's
    filenames in order of appearance (evaluation_measures.py:61,100 —
    ``evaluated_files = reference["filename"].unique()``). Files that
    appear only in the system output are never evaluated, so their
    detections do NOT count as false positives; files present in the
    reference with a NaN event_label marker row
    (get_event_list_current_file, :34-38) ARE evaluated as empty."""
    return list(dict.fromkeys(reference.filename))


def group_by_file_class(t: EventTable, sort_onsets: bool
                        ) -> Dict[str, Dict[str, np.ndarray]]:
    """{filename: {label: (n, 2) float64 [onset, offset]}}, the groups of
    pandas' ``groupby(["filename", "event_label"])``: keys in sorted
    order, rows in table order (by onset, stable, with ``sort_onsets``),
    rows with a missing key left out."""
    groups: Dict[tuple, list] = {}
    for i, key in enumerate(zip(t.filename, t.event_label)):
        if not (missing(key[0]) or missing(key[1])):
            groups.setdefault(key, []).append(i)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for fname, label in sorted(groups):
        rows = np.asarray(groups[(fname, label)])
        ev = np.stack([t.onset[rows], t.offset[rows]], axis=1)
        if sort_onsets:
            ev = ev[np.argsort(ev[:, 0], kind="stable")]
        out.setdefault(fname, {})[label] = ev
    return out


def event_based_counts(reference: EventTable, estimated: EventTable,
                       t_collar: float = 0.2,
                       percentage_of_length: float = 0.2
                       ) -> Dict[str, ClassCounts]:
    classes = _classes_union(reference, estimated)
    ref_map = group_by_file_class(reference, True)
    est_map = group_by_file_class(estimated, True)
    counts = {c: ClassCounts() for c in classes}

    for fname in _evaluated_files(reference):
        for label in classes:
            ref_ev = ref_map.get(fname, {}).get(label, np.zeros((0, 2)))
            est_ev = est_map.get(fname, {}).get(label, np.zeros((0, 2)))
            cc = counts[label]
            cc.n_ref += len(ref_ev)
            cc.n_sys += len(est_ev)
            if not len(ref_ev) or not len(est_ev):
                continue
            # pairwise hit matrix
            onset_ok = (np.abs(est_ev[None, :, 0] - ref_ev[:, None, 0])
                        <= t_collar)
            off_collar = np.maximum(
                t_collar,
                percentage_of_length * (ref_ev[:, 1] - ref_ev[:, 0]))
            offset_ok = (np.abs(est_ev[None, :, 1] - ref_ev[:, None, 1])
                         <= off_collar[:, None])
            hits = onset_ok & offset_ok
            cc.tp += _max_bipartite_tp(hits)
    return counts


def _max_bipartite_tp(hits: np.ndarray) -> int:
    """Maximum one-to-one matching size over the (n_ref, n_est) hit matrix
    — sed_eval's collision resolution (its ``_bipartite_match``); greedy
    matching is NOT equivalent (see module docstring). Delegates to
    scipy's Hopcroft–Karp (C, no recursion-depth limits on dense files)."""
    if not hits.any():
        return 0
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_bipartite_matching

    perm = maximum_bipartite_matching(csr_matrix(hits), perm_type="column")
    return int((perm != -1).sum())


def segment_based_counts(reference: EventTable, estimated: EventTable,
                         time_resolution: float = 1.0,
                         file_duration: float = 10.0
                         ) -> Dict[str, ClassCounts]:
    classes = _classes_union(reference, estimated)
    ref_map = group_by_file_class(reference, True)
    est_map = group_by_file_class(estimated, True)
    counts = {c: ClassCounts() for c in classes}
    n_seg = int(np.ceil(file_duration / time_resolution))
    files = _evaluated_files(reference)

    def rasterize(ev: np.ndarray) -> np.ndarray:
        grid = np.zeros(n_seg, dtype=bool)
        for onset, offset in ev:
            a = int(np.floor(onset / time_resolution))
            b = int(np.ceil(offset / time_resolution))
            grid[max(a, 0):min(b, n_seg)] = True
        return grid

    for fname in files:
        for label in classes:
            r = rasterize(ref_map.get(fname, {}).get(label, np.zeros((0, 2))))
            e = rasterize(est_map.get(fname, {}).get(label, np.zeros((0, 2))))
            cc = counts[label]
            cc.tp += int((r & e).sum())
            cc.n_ref += int(r.sum())
            cc.n_sys += int(e.sum())
    return counts


def macro_f_measure(counts: Dict[str, ClassCounts]) -> float:
    if not counts:
        return 0.0
    return float(np.mean([c.f_measure for c in counts.values()]))


def micro_f_measure(counts: Dict[str, ClassCounts]) -> float:
    tp = sum(c.tp for c in counts.values())
    denom = sum(c.n_ref + c.n_sys for c in counts.values())
    return 2.0 * tp / denom if denom else 0.0


def event_based_f1(reference: EventTable, estimated: EventTable,
                   t_collar: float = 0.2,
                   percentage_of_length: float = 0.2) -> float:
    """Headline metric: class-wise-average event F1
    (evaluation_measures.py:519-520)."""
    return macro_f_measure(
        event_based_counts(reference, estimated, t_collar,
                           percentage_of_length))


def segment_based_f1(reference: EventTable, estimated: EventTable,
                     time_resolution: float = 1.0) -> float:
    return macro_f_measure(
        segment_based_counts(reference, estimated, time_resolution))


def per_class_report(counts: Dict[str, ClassCounts]
                     ) -> Dict[str, np.ndarray]:
    """Per-class counts and scores, sorted by label, as the columns
    event_label, n_ref, n_sys, tp, precision, recall, f_measure."""
    rows = [(label, c.n_ref, c.n_sys, c.tp, c.precision, c.recall,
             c.f_measure) for label, c in sorted(counts.items())]
    names = ("event_label", "n_ref", "n_sys", "tp", "precision", "recall",
             "f_measure")
    return {n: np.asarray([r[i] for r in rows],
                          dtype=object if i == 0 else None)
            for i, n in enumerate(names)}
