"""Raven-annotation cleanup and 10-second segmentation, vectorized.

The port's copy of ``bsed_tpu/data/annotations.py``; annotation tables
are ``utils.tables.EventTable``s where ``bsed_tpu`` uses pandas frames
(the same values and row order). Capability parity with the reference's
src/data/preprocess.py:47-233 — the ENA field-recording annotation
pipeline — re-expressed as pure event-list transforms over numpy arrays
instead of row-by-row pandas loops:

  * rename Raven columns, filter to the bird list       (preprocess.py:186-187)
  * merge same-label events whose gap is < merge_gap    (preprocess.py:123-150)
  * drop events with duration <= min_dur                (preprocess.py:193)
  * split events straddling a segment boundary          (preprocess.py:47-65)
  * union overlapping same-label events per segment     (preprocess.py:67-101)

Events are (label: str, onset: float, offset: float) tuples in seconds.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from bsed_tpu_torch.utils.tables import EventTable, read_tsv

Event = Tuple[str, float, float]

RAVEN_COLUMN_MAP = {
    "Begin Time (s)": "onset",
    "End Time (s)": "offset",
    "Species": "event_label",
}

BOUNDARY_EPS = 1e-6  # preprocess.py:59 sets pre-boundary offset to t - 1e-6


def load_raven_annotations(path: str, bird_list: Sequence[str]
                           ) -> EventTable:
    """Read a Raven .txt selection table; rename columns; filter species.
    An ``EventTable`` without a filename column (``bsed_tpu`` returns a
    frame with the columns onset, offset, event_label)."""
    cols = {RAVEN_COLUMN_MAP.get(k, k): v for k, v in read_tsv(path).items()}
    birds = set(bird_list)
    keep = [i for i, label in enumerate(cols["event_label"])
            if label in birds]
    return EventTable([cols["event_label"][i] for i in keep],
                      [float(cols["onset"][i]) for i in keep],
                      [float(cols["offset"][i]) for i in keep])


def _to_arrays(events: Sequence[Event]):
    if len(events) == 0:
        return (np.array([], dtype=object), np.array([], dtype=np.float64),
                np.array([], dtype=np.float64))
    labels = np.array([e[0] for e in events], dtype=object)
    onsets = np.array([e[1] for e in events], dtype=np.float64)
    offsets = np.array([e[2] for e in events], dtype=np.float64)
    return labels, onsets, offsets


def merge_close_events(events: Sequence[Event], gap: float = 0.15) -> List[Event]:
    """Chain-merge same-label events separated by less than ``gap`` seconds.

    The reference merges a row into its predecessor when
    |prev_offset − onset| < 0.15 (preprocess.py:132); transitively, a run of
    events each within the gap collapses into one [min onset, max offset].
    """
    out: List[Event] = []
    labels, onsets, offsets = _to_arrays(events)
    for label in dict.fromkeys(labels):  # preserve first-seen order
        m = labels == label
        o, f = onsets[m], offsets[m]
        order = np.argsort(o, kind="stable")
        o, f = o[order], f[order]
        cur_on, cur_off = o[0], f[0]
        for i in range(1, len(o)):
            if abs(o[i] - cur_off) < gap or o[i] <= cur_off:
                cur_off = max(cur_off, f[i])
            else:
                out.append((label, cur_on, cur_off))
                cur_on, cur_off = o[i], f[i]
        out.append((label, cur_on, cur_off))
    return out


def drop_short_events(events: Sequence[Event], min_dur: float = 0.2) -> List[Event]:
    """Keep events with duration strictly greater than min_dur
    (preprocess.py:193 uses ``>``)."""
    return [e for e in events if (e[2] - e[1]) > min_dur]


def split_at_boundary(events: Sequence[Event], time: float) -> List[Event]:
    """Split every event straddling ``time`` into [onset, time−eps] + [time,
    offset] (preprocess.py:47-65)."""
    out: List[Event] = []
    for label, onset, offset in events:
        if onset < time < offset:
            out.append((label, onset, time - BOUNDARY_EPS))
            out.append((label, time, offset))
        else:
            out.append((label, onset, offset))
    return out


def union_same_label_overlaps(events: Sequence[Event]) -> List[Event]:
    """Union transitively-overlapping same-label events.

    Equivalent to the reference's dense connected-components over the
    pairwise interval-overlap graph (preprocess.py:91-97) but O(n log n):
    sort per label and sweep, since interval-graph components are exactly
    runs where each interval starts before the running max offset.
    """
    out: List[Event] = []
    labels, onsets, offsets = _to_arrays(events)
    for label in dict.fromkeys(labels):
        m = labels == label
        o, f = onsets[m], offsets[m]
        order = np.argsort(o, kind="stable")
        o, f = o[order], f[order]
        cur_on, cur_off = o[0], f[0]
        for i in range(1, len(o)):
            if o[i] <= cur_off:  # graph edge: start <= end (closed intervals)
                cur_off = max(cur_off, f[i])
            else:
                out.append((label, cur_on, cur_off))
                cur_on, cur_off = o[i], f[i]
        out.append((label, cur_on, cur_off))
    return out


def segment_annotations(events: Sequence[Event], n_segments: int,
                        seg_sec: float = 10.0) -> List[List[Event]]:
    """Chop a recording's events into per-10s-segment lists, splitting events
    at every boundary and unioning same-label overlaps inside each segment
    (preprocess.py:201-224). Returned times are segment-relative."""
    per_segment: List[List[Event]] = []
    current = list(events)
    for k in range(n_segments):
        t0, t1 = k * seg_sec, (k + 1) * seg_sec
        current = split_at_boundary(current, t1)
        inside = [(l, a - t0, b - t0) for (l, a, b) in current
                  if a >= t0 and b < t1]
        if inside:
            inside = union_same_label_overlaps(inside)
            # reference drop_duplicates after union
            inside = list(dict.fromkeys(inside))
        per_segment.append(inside)
    return per_segment


def clean_annotations(table, merge_gap: float = 0.15,
                      min_dur: float = 0.2) -> List[Event]:
    """merge-close + drop-short over a loaded annotation table (any table
    with event_label/onset/offset columns, such as ``EventTable``)."""
    events = [(label, float(onset), float(offset))
              for label, onset, offset in zip(table["event_label"],
                                              table["onset"],
                                              table["offset"])]
    events = merge_close_events(events, gap=merge_gap)
    events = drop_short_events(events, min_dur=min_dur)
    return events


def events_to_frame(events: Sequence[Event], filename: str = ""
                    ) -> EventTable:
    """Events as an ``EventTable``, with a filename column when
    ``filename`` is given."""
    table = EventTable.from_rows(events, ("event_label", "onset", "offset"))
    if filename:
        table.filename = np.full(len(table), filename, dtype=object)
    return table


def seeded_split(filenames: Sequence[str], seed: int = 1215):
    """Reference data split (preprocess.py:234-293): python-random seeded
    sample of 50% train / 50% val; train further split 25% weak / 75%
    unlabeled. Sampling is over a set() like the reference, so we sort first
    to make the split deterministic across processes (python set order of
    strings is stable within a run but not across hash randomization; the
    reference relies on PYTHONHASHSEED defaults — we pin by sorting)."""
    import random as _random
    rng = _random.Random(seed)
    files = sorted(filenames)
    train = set(rng.sample(files, int(len(files) / 2)))
    val = [f for f in files if f not in train]
    train_sorted = sorted(train)
    weak = set(rng.sample(train_sorted, int(len(train) / 4)))
    unlabeled = [f for f in train_sorted if f not in weak]
    return sorted(weak), unlabeled, val
