"""Event tables and TSV reading without pandas.

``bsed_tpu`` passes events between its decoders and scorers as pandas
DataFrames with the columns ``event_label``, ``onset``, ``offset`` and
``filename``. The port passes an ``EventTable``: the same four columns as
equal-length numpy arrays, in the DataFrame's row order and dtypes (labels
and filenames as object arrays of ``str``, times as float64). A label or
filename that is ``None`` or a float NaN is a missing value, as pandas'
``dropna`` sees it. ``read_tsv`` stands in for ``pd.read_csv(sep="\\t")``
where the repo reads its own annotation and pseudo-label files.
"""
from __future__ import annotations

import csv
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

COLUMNS = ("event_label", "onset", "offset", "filename")


def missing(value) -> bool:
    """True for the values pandas' ``dropna`` drops: None and float NaN."""
    return value is None or (isinstance(value, float) and value != value)


def _objects(values) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = list(values)
    return out


@dataclasses.dataclass
class EventTable:
    """Events as four equal-length numpy columns (see the module
    docstring). ``filename`` is None for a table without that column, as
    ``bsed_tpu``'s annotation frames have none."""
    event_label: np.ndarray
    onset: np.ndarray
    offset: np.ndarray
    filename: Optional[np.ndarray] = None

    def __post_init__(self):
        self.event_label = _objects(self.event_label)
        self.onset = np.asarray(self.onset, dtype=np.float64).reshape(-1)
        self.offset = np.asarray(self.offset, dtype=np.float64).reshape(-1)
        if self.filename is not None:
            self.filename = _objects(self.filename)
        n = len(self.event_label)
        sizes = {n, len(self.onset), len(self.offset)}
        if self.filename is not None:
            sizes.add(len(self.filename))
        if len(sizes) != 1:
            raise ValueError(f"EventTable columns differ in length: {sizes}")

    @classmethod
    def from_rows(cls, rows: Iterable[Sequence],
                  columns: Sequence[str] = COLUMNS) -> "EventTable":
        """Rows of values in the order of ``columns`` (any order of the
        four names; ``filename`` may be left out)."""
        rows = list(rows)
        cols = {c: [r[i] for r in rows] for i, c in enumerate(columns)}
        return cls(cols["event_label"], cols["onset"], cols["offset"],
                   cols.get("filename"))

    @classmethod
    def empty(cls) -> "EventTable":
        return cls([], [], [], [])

    @staticmethod
    def concat(tables: Sequence["EventTable"]) -> "EventTable":
        """Rows of every table in turn (``pd.concat(ignore_index=True)``)."""
        if not tables:
            return EventTable.empty()
        cat = lambda name: np.concatenate(  # noqa: E731
            [getattr(t, name) for t in tables])
        with_f = all(t.filename is not None for t in tables)
        return EventTable(cat("event_label"), cat("onset"), cat("offset"),
                          cat("filename") if with_f else None)

    @property
    def columns(self) -> List[str]:
        return [c for c in COLUMNS
                if c != "filename" or self.filename is not None]

    def __len__(self) -> int:
        return len(self.event_label)

    def __getitem__(self, column: str) -> np.ndarray:
        """A column by name, as a DataFrame's ``df[column]``."""
        if column not in self.columns:
            raise KeyError(column)
        return getattr(self, column)

    def rows(self) -> List[tuple]:
        """The rows as tuples in ``columns`` order."""
        return list(zip(*(getattr(self, c) for c in self.columns)))


def read_tsv(path: str) -> Dict[str, List[str]]:
    """A tab-separated file with a header line as ``{column: [str]}``."""
    with open(path, newline="") as fh:
        reader = csv.reader(fh, delimiter="\t")
        header = next(reader, None)
        if header is None:
            return {}
        cols: Dict[str, List[str]] = {h: [] for h in header}
        for row in reader:
            if not row:
                continue
            row = row + [""] * (len(header) - len(row))
            for h, v in zip(header, row):
                cols[h].append(v)
    return cols


def read_event_tsv(path: str) -> EventTable:
    """An annotation TSV with ``event_label``, ``onset`` and ``offset``
    columns as an ``EventTable`` without filenames; empty fields read as
    NaN, as pandas reads them."""
    cols = read_tsv(path)
    times = lambda c: [float(v) if v != "" else np.nan  # noqa: E731
                       for v in cols[c]]
    labels = [v if v != "" else np.nan for v in cols["event_label"]]
    return EventTable(labels, times("onset"), times("offset"))
