"""Offline dataset fabrication: ENA field recordings → per-clip feature
dumps, with the mel extraction running batched on the run's device.

The port's copy of ``bsed_tpu/data/preprocess.py``, without pandas.
Reference: src/data/preprocess.py:152-298 (``ena_data_preprocess`` +
``data_split``). Differences by design, as in ``bsed_tpu``:
  * librosa.load + per-clip CPU mel → one batched pass per recording
    through the dense front end (``ops/mel.MelFrontEnd``, float32 with
    TF32 off: ``bsed_tpu`` dumps at precision 'highest') writing the same
    ``<wav>_<i>.npy`` linear-mel dumps (1255×128 float32) and
    ``<wav>_<i>.txt`` annotations;
  * wav IO via scipy (soundfile/librosa are not installed); resampling via
    polyphase filtering (scipy.signal.resample_poly);
  * the annotation cleanup/segmentation ops live in
    ``data/annotations.py`` (vectorized, tested).

``preprocess_recording`` and ``ena_data_preprocess`` take the device and,
optionally, a ``seconds`` dict into which they add the wall seconds of
each part (read, annotations, mel, write).
"""
from __future__ import annotations

import csv
import os
import time
from fractions import Fraction
from glob import glob
from typing import Dict, List, Optional

import numpy as np

from bsed_tpu_torch.config import Config
from bsed_tpu_torch.data.annotations import (clean_annotations,
                                             load_raven_annotations,
                                             seeded_split,
                                             segment_annotations)
from bsed_tpu_torch.utils.logger import create_logger
from bsed_tpu_torch.utils.profiling import span

log = create_logger("bsed_tpu_torch/preprocess")

ANNOTATION_COLUMNS = ("onset", "offset", "event_label")


def read_wav(path: str, target_sr: int) -> np.ndarray:
    """Load a wav file as mono float32 at ``target_sr``; the resample is
    the span ``bsed.predict.resample`` (``utils/profiling.span``)."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    sr, data = wavfile.read(path)
    if data.dtype.kind == "i":
        data = data.astype(np.float32) / np.iinfo(data.dtype).max
    elif data.dtype.kind == "u":
        info = np.iinfo(data.dtype)
        data = (data.astype(np.float32) - info.max / 2) / (info.max / 2)
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if sr != target_sr:
        frac = Fraction(target_sr, sr).limit_denominator(1000)
        with span("predict.resample"):
            data = resample_poly(data, frac.numerator, frac.denominator
                                 ).astype(np.float32)
    return data


def segment_audio(audio: np.ndarray, seg_samples: int) -> np.ndarray:
    """Non-overlapping full segments (librosa.util.frame semantics —
    trailing partial segment dropped)."""
    n = len(audio) // seg_samples
    return audio[:n * seg_samples].reshape(n, seg_samples)


def write_events_txt(path: str, events) -> None:
    """(label, onset, offset) events as the onset/offset/event_label TSV
    that ``bsed_tpu`` writes with pandas (header line, "\\n" line ends,
    times in ``repr`` form; no events: the header alone)."""
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh, delimiter="\t", lineterminator="\n")
        writer.writerow(ANNOTATION_COLUMNS)
        writer.writerows((float(a), float(b), label)
                         for label, a, b in events)


def mel_dumps(front_end, clips: np.ndarray, n_frames: int) -> np.ndarray:
    """Linear mel of a (B, n_samples) batch on the front end's device,
    float32 with TF32 off, padded or cut to ``n_frames``; a host array."""
    import torch

    from bsed_tpu_torch.data.datasets import pad_or_trunc
    from bsed_tpu_torch.utils.device import float32_precision

    with float32_precision("highest"), torch.inference_mode():
        mel = front_end(torch.from_numpy(np.ascontiguousarray(clips))
                        .to(front_end.device))
        return pad_or_trunc(mel.cpu().numpy(), n_frames)


def _add(seconds: Optional[Dict[str, float]], key: str, t0: float) -> float:
    t1 = time.perf_counter()
    if seconds is not None:
        seconds[key] = seconds.get(key, 0.0) + (t1 - t0)
    return t1


def preprocess_recording(wav_path: str, annotation_path: Optional[str],
                         cfg: Config, mel_out_dir: str, ann_out_dir: str,
                         front_end=None, batch_size: int = 16,
                         device="cuda",
                         seconds: Optional[Dict[str, float]] = None
                         ) -> List[str]:
    """One recording → per-10s npy/txt dumps. Returns dump basenames.
    ``front_end`` defaults to the dense ``MelFrontEnd`` on ``device``."""
    from bsed_tpu_torch.ops.mel import MelFrontEnd

    fe = front_end or MelFrontEnd(cfg.audio, device=device)
    os.makedirs(mel_out_dir, exist_ok=True)
    os.makedirs(ann_out_dir, exist_ok=True)

    t0 = time.perf_counter()
    audio = read_wav(wav_path, cfg.audio.sr)
    seg_samples = int(cfg.audio.max_len_seconds * cfg.audio.sr)
    segments = segment_audio(audio, seg_samples)
    t0 = _add(seconds, "read", t0)
    if not len(segments):
        return []

    if annotation_path is not None:
        table = load_raven_annotations(annotation_path, cfg.bird_list)
        events = clean_annotations(table, cfg.data.merge_gap_s,
                                   cfg.data.min_event_dur_s)
    else:
        events = []
    per_segment = segment_annotations(events, len(segments),
                                      cfg.audio.max_len_seconds)
    t0 = _add(seconds, "annotations", t0)

    stem = os.path.splitext(os.path.basename(wav_path))[0]
    names = []
    for start in range(0, len(segments), batch_size):
        chunk = segments[start:start + batch_size]
        # one batched device pass, normalized to exactly max_frames
        mels = mel_dumps(fe, chunk, cfg.audio.max_frames)
        t0 = _add(seconds, "mel", t0)
        for j in range(len(chunk)):
            i = start + j
            name = f"{stem}_{i}"
            np.save(os.path.join(mel_out_dir, name), mels[j])
            write_events_txt(os.path.join(ann_out_dir, name + ".txt"),
                             per_segment[i])
            names.append(name)
        t0 = _add(seconds, "write", t0)
    return names


def recording_domains(dataset_root: str) -> List[str]:
    """The domains of an ENA-layout root: the subdirectories of
    ``<root>/annotation`` whose name contains "Recording", sorted."""
    annotation_root = os.path.join(dataset_root, "annotation")
    if not os.path.isdir(annotation_root):
        return []
    return [d for d in sorted(os.listdir(annotation_root))
            if "Recording" in d]


def ena_data_preprocess(dataset_root: str, cfg: Config,
                        out_subdir: Optional[str] = None, device="cuda",
                        seconds: Optional[Dict[str, float]] = None
                        ) -> List[str]:
    """All domains/recordings under <root>/wav + <root>/annotation
    (preprocess.py:152-233 layout)."""
    from bsed_tpu_torch.ops.mel import MelFrontEnd

    out = os.path.join(dataset_root, out_subdir or cfg.data.feature_subdir)
    mel_dir = os.path.join(out, "wav")
    ann_dir = os.path.join(out, "annotation")
    fe = MelFrontEnd(cfg.audio, device=device)

    all_names = []
    annotation_root = os.path.join(dataset_root, "annotation")
    recording_root = os.path.join(dataset_root, "wav")
    for domain in recording_domains(dataset_root):
        for wav_path in sorted(glob(os.path.join(recording_root, domain,
                                                 "*.wav"))):
            stem = os.path.splitext(os.path.basename(wav_path))[0]
            matches = glob(os.path.join(annotation_root, domain,
                                        stem + "*.txt"))
            ann = matches[0] if matches else None
            names = preprocess_recording(wav_path, ann, cfg, mel_dir,
                                         ann_dir, front_end=fe,
                                         seconds=seconds)
            all_names.extend(names)
            log.info("%s/%s → %d segments", domain, stem, len(names))
    return all_names


def data_split(dataset_root: str, cfg: Config) -> None:
    """Seeded 50% val / 12.5% weak / 37.5% unlabeled copy-split of the
    dumps (preprocess.py:234-293)."""
    import shutil

    src = os.path.join(dataset_root, cfg.data.feature_subdir)
    mel_dir = os.path.join(src, "wav")
    ann_dir = os.path.join(src, "annotation")
    files = [os.path.splitext(os.path.basename(p))[0]
             for p in glob(os.path.join(mel_dir, "*.npy"))]
    weak, unlabeled, val = seeded_split(files, cfg.train.dataset_seed)

    for subdir, names in ((cfg.data.train_weak_subdir, weak),
                          (cfg.data.train_unlabeled_subdir, unlabeled),
                          (cfg.data.val_subdir, val)):
        dst = os.path.join(dataset_root, subdir)
        os.makedirs(os.path.join(dst, "wav"), exist_ok=True)
        os.makedirs(os.path.join(dst, "annotation"), exist_ok=True)
        for name in names:
            shutil.copy(os.path.join(mel_dir, name + ".npy"),
                        os.path.join(dst, "wav"))
            shutil.copy(os.path.join(ann_dir, name + ".txt"),
                        os.path.join(dst, "annotation"))
    log.info("split: %d weak / %d unlabeled / %d val", len(weak),
             len(unlabeled), len(val))
