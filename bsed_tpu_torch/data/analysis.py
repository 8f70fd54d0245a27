"""Dataset analysis + review tooling.

The port's copy of ``bsed_tpu/data/analysis.py``, without pandas: the
annotations come back as an ``utils/tables.EventTable``, the
co-occurrence matrix as an integer array in ``bird_list`` order and the
duration statistics as rows of dicts; the CSVs are written in the layout
pandas gives them (the matrix with its index column under an empty header
cell, the statistics without one).

References:
  * src/data/dataset_analysis.py — class co-occurrence matrix
    (→ occurence_analysis.csv) and per-species duration statistics
    (→ dataset_time_analysis.csv).
  * src/data/data_save_audio.py — cut every annotated event into
    per-species review WAVs.
"""
from __future__ import annotations

import csv
import os
from glob import glob
from typing import Dict, List, Sequence

import numpy as np

from bsed_tpu_torch.config import Config
from bsed_tpu_torch.data.annotations import load_raven_annotations
from bsed_tpu_torch.utils.tables import EventTable, read_event_tsv

STAT_COLUMNS = ("event_label", "count", "total_s", "mean_s", "min_s",
                "max_s")


def collect_annotations(annotation_dir: str, bird_list: Sequence[str]
                        ) -> EventTable:
    """All per-clip annotation txts under a preprocess dir → one table,
    each row with its clip's name as filename."""
    tables = []
    for path in sorted(glob(os.path.join(annotation_dir, "*.txt"))):
        table = read_event_tsv(path)
        if not len(table):
            continue
        table.filename = np.full(
            len(table), os.path.splitext(os.path.basename(path))[0],
            dtype=object)
        tables.append(table)
    return EventTable.concat(tables)


def cooccurrence_matrix(events: EventTable, bird_list: Sequence[str],
                        out_csv: str = None) -> np.ndarray:
    """Clip-level class co-occurrence counts: (C, C) int64, rows and
    columns in ``bird_list`` order."""
    birds = list(bird_list)
    index = {c: i for i, c in enumerate(birds)}
    mat = np.zeros((len(birds), len(birds)), np.int64)
    by_clip: Dict[str, List[str]] = {}
    for name, label in zip(events.filename, events.event_label):
        present = by_clip.setdefault(name, [])
        if label in index and label not in present:
            present.append(label)
    for present in by_clip.values():
        for a in present:
            for b in present:
                mat[index[a], index[b]] += 1
    if out_csv:
        with open(out_csv, "w", newline="") as fh:
            writer = csv.writer(fh, lineterminator="\n")
            writer.writerow(["", *birds])
            writer.writerows([c, *mat[i].tolist()]
                             for i, c in enumerate(birds))
    return mat


def duration_stats(events: EventTable, bird_list: Sequence[str],
                   out_csv: str = None) -> List[Dict]:
    """Per-species event counts + duration statistics, one dict a species
    with the keys of ``STAT_COLUMNS`` (sums and means skip missing times,
    as pandas does)."""
    rows = []
    for cls in bird_list:
        m = events.event_label == cls
        durs = events.offset[m] - events.onset[m]
        rows.append({
            "event_label": cls,
            "count": len(durs),
            "total_s": float(np.nansum(durs)) if len(durs) else 0.0,
            "mean_s": float(np.nanmean(durs)) if len(durs) else 0.0,
            "min_s": float(np.nanmin(durs)) if len(durs) else 0.0,
            "max_s": float(np.nanmax(durs)) if len(durs) else 0.0,
        })
    if out_csv:
        with open(out_csv, "w", newline="") as fh:
            writer = csv.writer(fh, lineterminator="\n")
            writer.writerow(STAT_COLUMNS)
            writer.writerows([r[c] for c in STAT_COLUMNS] for r in rows)
    return rows


def export_event_audio(dataset_root: str, out_dir: str, cfg: Config,
                       pad_s: float = 0.0) -> int:
    """Cut every annotated event into per-species review wavs
    (data_save_audio.py capability)."""
    from scipy.io import wavfile

    from bsed_tpu_torch.data.preprocess import read_wav, recording_domains

    annotation_root = os.path.join(dataset_root, "annotation")
    recording_root = os.path.join(dataset_root, "wav")
    n_written = 0
    for domain in recording_domains(dataset_root):
        for wav_path in sorted(glob(os.path.join(recording_root, domain,
                                                 "*.wav"))):
            stem = os.path.splitext(os.path.basename(wav_path))[0]
            matches = glob(os.path.join(annotation_root, domain,
                                        stem + "*.txt"))
            if not matches:
                continue
            audio = read_wav(wav_path, cfg.audio.sr)
            table = load_raven_annotations(matches[0], cfg.bird_list)
            for i, (label, onset, offset) in enumerate(
                    zip(table.event_label, table.onset, table.offset)):
                cls_dir = os.path.join(out_dir, label)
                os.makedirs(cls_dir, exist_ok=True)
                a = max(0, int((onset - pad_s) * cfg.audio.sr))
                b = min(len(audio), int((offset + pad_s) * cfg.audio.sr))
                if b <= a:
                    continue
                wavfile.write(
                    os.path.join(cls_dir, f"{stem}_{i}.wav"),
                    cfg.audio.sr,
                    (audio[a:b] * 32767).astype(np.int16))
                n_written += 1
    return n_written


def mix_audio_files(paths: Sequence[str], out_path: str,
                    sr: int = 32000) -> str:
    """Equal-weight mix of audio files into one wav — the reference's
    review-mix tool (dataset/SYN_test/generated_mix/mix.py: load N wavs at
    32 kHz, average, write). Shorter inputs are zero-padded to the
    longest."""
    from scipy.io import wavfile

    from bsed_tpu_torch.utils.audio import read_audio

    audios = [read_audio(p, sr)[0] for p in paths]
    n = max(len(a) for a in audios)
    mix = np.zeros(n, dtype=np.float32)
    for a in audios:
        mix[:len(a)] += a
    mix /= len(audios)
    wavfile.write(out_path, sr, mix)
    return out_path
