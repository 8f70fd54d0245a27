"""Audio IO helpers.

The port's copy of ``bsed_tpu/utils/audio.py``, without pandas: the
duration table is written with ``csv`` and returned as rows. Capability
parity with the reference's src/utilities/utils.py:19-37 (``read_audio``),
utils.py:235-251 (``generate_tsv_wav_durations``) and
src/synth_data/mp3_to_wav.py (gated: no mp3 decoder is available —
pydub/ffmpeg absent).
"""
from __future__ import annotations

import csv
import os
from glob import glob
from typing import List, Tuple

import numpy as np


def read_audio(path: str, target_sr: int) -> Tuple[np.ndarray, int]:
    """Load + resample like the reference's soundfile/librosa combo."""
    from bsed_tpu_torch.data.preprocess import read_wav
    return read_wav(path, target_sr), target_sr


def wav_duration_s(path: str) -> float:
    import wave
    with wave.open(path, "rb") as w:
        return w.getnframes() / w.getframerate()


def generate_tsv_wav_durations(audio_dir: str, out_tsv: str
                               ) -> List[Tuple[str, float]]:
    """filename/duration TSV over a wav directory (utils.py:235-251);
    returns the rows (``bsed_tpu`` returns them as a DataFrame). The file
    is the one pandas writes: tab-separated, "\\n" line ends, floats in
    ``repr`` form."""
    rows = [(os.path.basename(p), wav_duration_s(p))
            for p in sorted(glob(os.path.join(audio_dir, "*.wav")))]
    with open(out_tsv, "w", newline="") as fh:
        writer = csv.writer(fh, delimiter="\t", lineterminator="\n")
        writer.writerow(["filename", "duration"])
        writer.writerows(rows)
    return rows


def mp3_to_wav(mp3_path: str, wav_path: str) -> None:
    """The reference converts NIPS4B mp3 foregrounds with pydub
    (mp3_to_wav.py:5-20). No mp3 decoder ships in this environment."""
    raise NotImplementedError(
        "mp3 decoding requires pydub/ffmpeg, which are not available in "
        "this image; provide wav foregrounds instead (the synthesizer and "
        "preprocess pipeline consume wav directly)")
