"""Many-hot label codec: weak (clip) and strong (frame) encodings.

The port's copy of ``bsed_tpu/data/codec.py``: capability parity with the
reference's src/utilities/ManyHotEncoder.py and the frame-target
construction duplicated in src/data/dataload.py:79-81. Encoding
is vectorized numpy (no per-row pandas iteration); decoding returns
(label, onset_frame, offset_frame) event tuples via run-length extraction,
replacing dcase_util's DecisionEncoder.find_contiguous_regions.

Frame conversion uses the reference's exact floor-division chain:
    frame = int(seconds * sr // hop_size // pooling_time_ratio)
(ManyHotEncoder.py:121-122) — ``seconds * sr`` is floored by // at each stage.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

Event = Tuple[str, float, float]  # (label, onset_s, offset_s)


class ManyHotEncoder:
    def __init__(self, labels: Sequence[str], n_frames: int = None,
                 sr: int = 32000, hop_size: int = 255,
                 pooling_time_ratio: int = 4):
        self.labels = list(labels)
        self.n_frames = n_frames
        self.sr = sr
        self.hop_size = hop_size
        self.pooling_time_ratio = pooling_time_ratio
        self._index = {l: i for i, l in enumerate(self.labels)}

    # -- weak ---------------------------------------------------------------
    def encode_weak(self, labels) -> np.ndarray:
        """List of label strings (possibly comma-joined) → (nclass,) 0/1.

        The string "empty" encodes to all −1, the reference's sentinel for
        unlabeled clips (ManyHotEncoder.py:38-41).
        """
        if isinstance(labels, str):
            if labels == "empty":
                return np.zeros(len(self.labels)) - 1
            labels = [labels]
        y = np.zeros(len(self.labels))
        for label in labels:
            if label is None or (isinstance(label, float) and np.isnan(label)):
                continue
            for event in str(label).split(","):
                event = event.strip()
                if event:
                    y[self._index[event]] = 1
        return y

    def decode_weak(self, encoded: np.ndarray) -> List[str]:
        return [self.labels[i] for i, v in enumerate(encoded) if v == 1]

    # -- strong -------------------------------------------------------------
    def seconds_to_frame(self, t: float) -> int:
        return int(t * self.sr // self.hop_size // self.pooling_time_ratio)

    def encode_strong(self, events: Iterable[Event]) -> np.ndarray:
        """Events in seconds → (n_frames, nclass) frame activity matrix."""
        assert self.n_frames is not None
        y = np.zeros((self.n_frames, len(self.labels)), dtype=np.float64)
        for label, onset, offset in events:
            i = self._index[label]
            a = self.seconds_to_frame(onset)
            b = self.seconds_to_frame(offset)
            y[a:b, i] = 1
        return y

    def encode_strong_df(self, label_df) -> np.ndarray:
        """A table with event_label/onset/offset columns (seconds), such as
        ``utils.tables.EventTable`` (``bsed_tpu`` takes a pandas frame)."""
        events = zip(label_df["event_label"], label_df["onset"],
                     label_df["offset"])
        return self.encode_strong(events)

    def decode_strong(self, frame_activity: np.ndarray) -> List[List]:
        """(n_frames, nclass) binary → [[label, onset_frame, offset_frame]].

        offset_frame is exclusive, matching find_contiguous_regions.
        """
        out: List[List] = []
        act = np.asarray(frame_activity)
        for i in range(act.shape[1]):
            for a, b in find_contiguous_regions(act[:, i]):
                out.append([self.labels[i], a, b])
        return out

    # -- (de)serialization --------------------------------------------------
    def state_dict(self) -> Dict:
        return {"labels": self.labels, "n_frames": self.n_frames,
                "sr": self.sr, "hop_size": self.hop_size,
                "pooling_time_ratio": self.pooling_time_ratio}

    @classmethod
    def load_state_dict(cls, state: Dict) -> "ManyHotEncoder":
        return cls(state["labels"], state.get("n_frames"),
                   state.get("sr", 32000), state.get("hop_size", 255),
                   state.get("pooling_time_ratio", 4))


def find_contiguous_regions(activity: np.ndarray) -> np.ndarray:
    """Onset/offset index pairs of 1-runs in a binary vector.

    Vectorized equivalent of dcase_util DecisionEncoder.find_contiguous_regions
    (used at ManyHotEncoder.py:159): returns an (n_regions, 2) int array of
    [start, stop) indices.
    """
    a = np.asarray(activity).astype(bool)
    if a.size == 0:
        return np.zeros((0, 2), dtype=int)
    change = np.diff(a.astype(np.int8))
    onsets = np.flatnonzero(change == 1) + 1
    offsets = np.flatnonzero(change == -1) + 1
    if a[0]:
        onsets = np.r_[0, onsets]
    if a[-1]:
        offsets = np.r_[offsets, a.size]
    return np.stack([onsets, offsets], axis=1)
