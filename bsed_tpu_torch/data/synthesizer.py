"""Native synthetic-soundscape generator (scaper/desed replacement).

The port's copy of ``bsed_tpu/data/synthesizer.py``, without pandas:
annotation files are written with ``csv`` as pandas writes them, and
``generate_dataset`` returns its rows as an ``utils/tables.EventTable``.
``np.random.default_rng(seed)`` is consumed in ``bsed_tpu``'s order, so
the WAVs and TSVs come out byte-identical.

Reference: src/synth_data/synth_data_preprocess.py — the
reference drives desed's ``SoundscapesGenerator.generate_by_label_occurence``
with a class co-occurrence JSON (:166-175), removes soundscapes with
polyphony > 4 (:179), merges same-label overlaps into output.tsv (:181-183),
then mel-dumps every generated clip (``syn_preprocess``, :82-114). scaper /
desed / pydub are not installed here, so generation is implemented natively:

  * co-occurrence JSON format (dataset/*/metadata/event_occurences/*.json):
      {class: {"proba": p, "co-occurences": {"max_events": m,
       "mean_events": mu, "classes": [...], "probas": [...]}}}
  * background drawn from a pool of 10 s beds (NIPS4B "Empty" clips in the
    reference; any wav dir, or synthetic noise when none is given),
  * events drawn from per-class foreground pools, placed at random onsets
    with random event-to-background SNR, peak-normalized mixing,
  * polyphony cap + same-label overlap union on the generated labels.
"""
from __future__ import annotations

import csv
import json
import os
from dataclasses import dataclass, field
from glob import glob
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bsed_tpu_torch.config import Config
from bsed_tpu_torch.data.annotations import union_same_label_overlaps
from bsed_tpu_torch.utils.logger import create_logger
from bsed_tpu_torch.utils.tables import EventTable

log = create_logger("bsed_tpu_torch/synthesizer")

Event = Tuple[str, float, float]


@dataclass
class SoundscapeConfig:
    duration: float = 10.0
    sr: int = 32000
    ref_db: float = -55.0
    snr_range: Tuple[float, float] = (6.0, 30.0)
    max_polyphony: int = 4
    max_events_cap: int = 5


class ForegroundPool:
    """Per-class event clips: real wavs from <fg_dir>/<class>/*.wav, or
    deterministic synthetic chirps when no directory is given."""

    def __init__(self, classes: Sequence[str], fg_dir: Optional[str] = None,
                 sr: int = 32000, seed: int = 0):
        self.classes = list(classes)
        self.sr = sr
        self.seed = seed
        self.files: Dict[str, List[str]] = {}
        if fg_dir:
            for c in self.classes:
                self.files[c] = sorted(glob(os.path.join(fg_dir, c, "*.wav")))

    def sample(self, cls: str, rng: np.random.Generator) -> np.ndarray:
        files = self.files.get(cls, [])
        if files:
            from bsed_tpu_torch.data.preprocess import read_wav
            return read_wav(files[rng.integers(len(files))], self.sr)
        # synthetic chirp: class-coded frequency sweep, 0.3–2 s
        dur = float(rng.uniform(0.3, 2.0))
        n = int(dur * self.sr)
        t = np.arange(n) / self.sr
        f0 = 1000.0 + 700.0 * (self.classes.index(cls) % 20)
        f1 = f0 * float(rng.uniform(1.1, 1.6))
        phase = 2 * np.pi * (f0 * t + (f1 - f0) * t ** 2 / (2 * dur))
        env = np.hanning(n)
        return (np.sin(phase) * env).astype(np.float32)


class BackgroundPool:
    def __init__(self, bg_dir: Optional[str] = None, sr: int = 32000):
        self.sr = sr
        self.files = sorted(glob(os.path.join(bg_dir, "*.wav"))) \
            if bg_dir else []

    def sample(self, n_samples: int, rng: np.random.Generator) -> np.ndarray:
        if self.files:
            from bsed_tpu_torch.data.preprocess import read_wav
            bg = read_wav(self.files[rng.integers(len(self.files))], self.sr)
            if len(bg) >= n_samples:
                start = rng.integers(0, len(bg) - n_samples + 1)
                return bg[start:start + n_samples].copy()
            reps = int(np.ceil(n_samples / max(len(bg), 1)))
            return np.tile(bg, reps)[:n_samples].copy()
        return (0.01 * rng.standard_normal(n_samples)).astype(np.float32)


def build_background_pool_from_nips4b(annotation_csv: str, audio_dir: str,
                                      out_dir: str) -> List[str]:
    """Copy 'Empty'-labeled NIPS4B clips into a background folder
    (synth_data_preprocess.py:141-153)."""
    import shutil
    os.makedirs(out_dir, exist_ok=True)
    with open(annotation_csv, newline="") as fh:
        lines = fh.read().splitlines()[2:]
    empties = [r["Filename"] for r in csv.DictReader(lines)
               if _is_one(r["Empty"])]
    copied = []
    for name in empties:
        src = os.path.join(audio_dir, name)
        if os.path.exists(src):
            shutil.copy(src, out_dir)
            copied.append(name)
    return copied


def _is_one(value: str) -> bool:
    """A CSV field that pandas would read as the number 1."""
    try:
        return float(value) == 1.0
    except (TypeError, ValueError):
        return False


def _rms_db(x: np.ndarray) -> float:
    return 20.0 * np.log10(np.sqrt(np.mean(np.square(x)) + 1e-12))


def generate_soundscape(rng: np.random.Generator,
                        co_occur: Dict,
                        fg_pool: ForegroundPool,
                        bg_pool: BackgroundPool,
                        sc: SoundscapeConfig) -> Tuple[np.ndarray, List[Event]]:
    """One 10 s mixture + its event list, driven by the co-occurrence
    priors (generate_by_label_occurence semantics)."""
    n = int(sc.duration * sc.sr)
    mix = bg_pool.sample(n, rng).astype(np.float64)
    bg_db = _rms_db(mix)

    # pick the seed class by prior probability
    classes = list(co_occur.keys())
    probs = np.array([co_occur[c].get("proba", 1.0) for c in classes])
    probs = probs / probs.sum()
    seed_cls = classes[rng.choice(len(classes), p=probs)]
    co = co_occur[seed_cls].get("co-occurences", {})
    mean_ev = co.get("mean_events", 2)
    max_ev = min(co.get("max_events", sc.max_events_cap), sc.max_events_cap)
    n_events = int(np.clip(rng.poisson(max(mean_ev, 1)), 1, max(max_ev, 1)))

    event_classes = [seed_cls]
    co_classes = co.get("classes", [])
    co_probs = np.array(co.get("probas", []), dtype=np.float64)
    for _ in range(n_events - 1):
        if len(co_classes) and co_probs.sum() > 0:
            p = co_probs / co_probs.sum()
            event_classes.append(co_classes[rng.choice(len(co_classes), p=p)])
        else:
            event_classes.append(classes[rng.choice(len(classes), p=probs)])

    events: List[Event] = []
    for cls in event_classes:
        clip = fg_pool.sample(cls, rng).astype(np.float64)
        if len(clip) >= n:
            clip = clip[:n - 1]
        onset_s = float(rng.uniform(0.0, sc.duration - len(clip) / sc.sr))
        start = int(onset_s * sc.sr)
        snr = float(rng.uniform(*sc.snr_range))
        target_db = bg_db + snr
        gain = 10.0 ** ((target_db - _rms_db(clip)) / 20.0)
        mix[start:start + len(clip)] += gain * clip
        events.append((cls, onset_s, onset_s + len(clip) / sc.sr))

    peak = np.abs(mix).max()
    if peak > 1.0:
        mix = mix / peak
    return mix.astype(np.float32), events


def polyphony(events: Sequence[Event], resolution: float = 0.01) -> int:
    if not events:
        return 0
    edges = []
    for _, a, b in events:
        edges.append((a, 1))
        edges.append((b, -1))
    edges.sort()
    cur = peak = 0
    for _, d in edges:
        cur += d
        peak = max(peak, cur)
    return peak


def generate_dataset(out_dir: str, co_occur_json: str, n_soundscapes: int,
                     cfg: Config, fg_dir: Optional[str] = None,
                     bg_dir: Optional[str] = None, seed: int = 2023,
                     write_wav: bool = True,
                     sc: Optional[SoundscapeConfig] = None) -> EventTable:
    """Generate soundscapes + output.tsv; drops polyphony>4 scenes
    (rm_high_polyphony) and unions same-label overlaps
    (post_process_txt_labels). Returns output.tsv's rows as an
    ``EventTable`` with filenames."""
    from bsed_tpu_torch.data.preprocess import write_events_txt

    sc = sc or SoundscapeConfig(sr=cfg.audio.sr,
                                duration=cfg.audio.max_len_seconds)
    with open(co_occur_json) as f:
        co_occur = json.load(f)
    rng = np.random.default_rng(seed)
    fg_pool = ForegroundPool(list(co_occur.keys()), fg_dir, sc.sr, seed)
    bg_pool = BackgroundPool(bg_dir, sc.sr)
    os.makedirs(out_dir, exist_ok=True)

    rows = []
    kept = 0
    attempts = 0
    while kept < n_soundscapes and attempts < n_soundscapes * 3:
        attempts += 1
        audio, events = generate_soundscape(rng, co_occur, fg_pool, bg_pool,
                                            sc)
        if polyphony(events) > sc.max_polyphony:       # rm_high_polyphony
            continue
        events = union_same_label_overlaps(events)      # post_process merge
        name = f"soundscape_{kept:05d}"
        if write_wav:
            from scipy.io import wavfile
            wavfile.write(os.path.join(out_dir, name + ".wav"), sc.sr,
                          (audio * 32767).astype(np.int16))
        write_events_txt(os.path.join(out_dir, name + ".txt"), events)
        for (l, a, b) in events:
            rows.append((name + ".wav", a, b, l))
        kept += 1

    with open(os.path.join(out_dir, "output.tsv"), "w", newline="") as fh:
        writer = csv.writer(fh, delimiter="\t", lineterminator="\n")
        writer.writerow(["filename", "onset", "offset", "event_label"])
        writer.writerows(rows)
    log.info("generated %d soundscapes (%d attempts)", kept, attempts)
    return EventTable.from_rows(rows, ("filename", "onset", "offset",
                                       "event_label"))


def syn_preprocess(generated_dir: str, out_dir: str, cfg: Config,
                   batch_size: int = 16, device="cuda") -> List[str]:
    """Mel-dump every generated soundscape + copy its annotation txt
    (synth_data_preprocess.py:82-114) — batched on ``device`` through the
    dense front end in float32 (``data/preprocess.mel_dumps``)."""
    from bsed_tpu_torch.data.preprocess import mel_dumps, read_wav
    from bsed_tpu_torch.ops.mel import MelFrontEnd

    fe = MelFrontEnd(cfg.audio, device=device)
    mel_dir = os.path.join(out_dir, "wav")
    ann_dir = os.path.join(out_dir, "annotation")
    os.makedirs(mel_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    wavs = sorted(glob(os.path.join(generated_dir, "*.wav")))
    names = []
    n_samples = int(cfg.audio.max_len_seconds * cfg.audio.sr)
    for start in range(0, len(wavs), batch_size):
        chunk = wavs[start:start + batch_size]
        clips = []
        for p in chunk:
            a = read_wav(p, cfg.audio.sr)[:n_samples]
            clips.append(np.pad(a, (0, n_samples - len(a))))
        mels = mel_dumps(fe, np.stack(clips), cfg.audio.max_frames)
        for j, p in enumerate(chunk):
            stem = os.path.splitext(os.path.basename(p))[0]
            np.save(os.path.join(mel_dir, stem), mels[j])
            txt = os.path.join(generated_dir, stem + ".txt")
            if os.path.exists(txt):
                import shutil
                shutil.copy(txt, os.path.join(ann_dir, stem + ".txt"))
            names.append(stem)
    return names


def mix_pairs(audio_a: np.ndarray, audio_b: np.ndarray,
              weight: float = 0.5) -> np.ndarray:
    """Two-file mixer (dataset/SYN_test/generated_mix/mix.py capability)."""
    n = min(len(audio_a), len(audio_b))
    return (weight * audio_a[:n] + (1 - weight) * audio_b[:n]).astype(
        np.float32)
