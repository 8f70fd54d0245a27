"""Raw-audio sound-event inference: WAV/npy recordings → decoded events.

The library side of the CLI's ``predict`` (port of ``bsed_tpu/cli.py``
``cmd_predict``): each recording is read (and resampled) on the host, cut
into clip windows and served through ``serve.make_fast_forward`` (on the
card: the mel kernel K1 once, the stem-epilogue kernel K2 three times and
the GRU kernel K4 twice a forward call at precision 'high' or 'fast'),
re-assembled on one timeline (``serve.predict_long_recording``),
binarized and median-filtered on the posteriors' device
(``ops/median.threshold_and_filter``), fetched once, and decoded into
events on the host (``eval/decode.extract_events_batch``). On a host with
several cards the windows are served data-parallel, as ``bsed_tpu``'s
``cmd_predict`` serves them over its data mesh: ``auto_data_mesh`` picks
the most cards that divide the batch, and ``serve.make_sharded_forward``
runs a replica on each (a ragged tail padded to the batch and cut back).

The precision tier also sets TF32 for the length of the call
(``utils/device.float32_precision``): 'highest' and 'high' compute in
full float32, 'fast' lets matmuls and cuDNN convolutions round to TF32;
'highest' serves the dense front end, 'high' and 'fast' the mel kernel.

Under a ``torch.profiler`` profile a call marks its parts as spans
(``utils/profiling.span``): ``bsed.predict.build`` (the forward, built
once a call), ``read`` (a recording to float32 at the model's rate, with
``bsed.predict.resample`` inside where the file's rate differs),
``forward`` (the ``bsed.serve.*`` spans inside), ``filter`` and
``decode``; the returned ``seconds`` time the same regions.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from bsed_tpu_torch.config import Config
from bsed_tpu_torch.utils.profiling import span

TSV_COLUMNS = ("filename", "event_label", "onset", "offset")

Row = Tuple[str, str, float, float]


def load_recording(path: str, sr: int) -> np.ndarray:
    """A raw-audio ``.npy`` as float32, or a wav file as mono float32 at
    ``sr`` (``data/preprocess.read_wav``)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    from bsed_tpu_torch.utils.audio import read_audio
    return read_audio(path, sr)[0]


def frame_seconds(cfg: Config) -> float:
    """Seconds of one output frame."""
    return cfg.model.pooling_time_ratio / (cfg.audio.sr / cfg.audio.hop_size)


def decode_events(strong, cfg: Config, threshold: float = 0.5,
                  learned_post: bool = False, device=None,
                  seconds: Dict[str, float] = None
                  ) -> List[Tuple[str, float, float]]:
    """(label, onset s, offset s) events of one recording's (T, C) frame
    posteriors: binarized at ``threshold`` and median-filtered (the fixed
    window, or ``cfg.median_window_classwise`` with ``learned_post``) on
    ``device`` (default: where ``strong`` lies), then one copy to the host
    and the run-length decode there. ``seconds``, if given, gains the wall
    seconds of the filter (with the copy) and of the decode."""
    from bsed_tpu_torch.eval.decode import extract_events_batch
    from bsed_tpu_torch.ops.median import threshold_and_filter

    with span("predict.filter", seconds, "filter"):
        probs = torch.as_tensor(strong, dtype=torch.float32, device=device)
        act = threshold_and_filter(
            probs[None], [threshold], window=cfg.median_window,
            windows=cfg.median_window_classwise if learned_post else None)
        act = act.cpu().numpy()
    with span("predict.decode", seconds, "decode"):
        _, _, c_idx, on_t, off_t = extract_events_batch(act)
        sec = frame_seconds(cfg)
        events = [(cfg.bird_list[c], a * sec, b * sec)
                  for c, a, b in zip(c_idx, on_t, off_t)]
    return events


def predict_recordings(cfg: Config, params: Dict, batch_stats: Dict,
                       paths: Sequence[str], *, device="cuda",
                       precision: str = "high", threshold: float = 0.5,
                       learned_post: bool = False, hop_seconds: float = None,
                       batch_size: int = 32,
                       keep_posteriors: bool = False,
                       devices=None) -> Dict:
    """Events of every recording in ``paths`` with the flax-layout weights
    ``params``/``batch_stats`` on ``device``, served by
    ``make_fast_forward`` (kernel or plain version as
    ``kernels.launches_on`` decides). ``devices``: serve over these devices a replica each
    (``make_sharded_forward``); None: over ``auto_data_mesh(batch_size)``
    of the visible cards when ``device`` is a card, else on ``device``.

    Returns a dict: ``rows`` [(filename, label, onset s, offset s)] in
    ``bsed_tpu``'s order, ``seconds`` by part (read, forward, filter,
    decode; wall seconds, the card synchronised by each part's copy to the
    host), ``audio_seconds`` (the recordings' length), ``batches`` (per
    recording, the batch size of each forward call, a padded ragged tail
    included), ``tf32`` (the TF32 settings in force during the call) and,
    with ``keep_posteriors``, ``posteriors``: each recording's (T, C) frame
    posteriors."""
    if cfg.model.htsat is not None:
        raise ValueError("predict decodes the CRNN's frame grid; an HTS-AT "
                         "configuration is served by "
                         "serve.make_fast_forward alone")
    from bsed_tpu_torch.parallel.mesh import auto_data_mesh
    from bsed_tpu_torch.serve import (make_fast_forward,
                                      make_sharded_forward,
                                      predict_long_recording)
    from bsed_tpu_torch.utils.device import float32_precision, resolve_device

    dev = resolve_device(device)
    if devices is None and dev.type == "cuda":
        devices = auto_data_mesh(batch_size)
    seconds = {"read": 0.0, "forward": 0.0, "filter": 0.0, "decode": 0.0}
    out = {"rows": [], "seconds": seconds, "audio_seconds": 0.0,
           "batches": [], "posteriors": []}
    with float32_precision(precision) as tf32:
        out["tf32"] = dict(tf32)
        with span("predict.build"):
            if devices is None:
                forward = make_fast_forward(cfg, params, batch_stats,
                                            device=dev, precision=precision)
            else:
                sharded = make_sharded_forward(cfg, params, batch_stats,
                                               devices, precision=precision)

                def forward(chunk):
                    b = len(chunk)
                    if b != batch_size:   # pad a ragged tail to the batch
                        chunk = np.concatenate(
                            [chunk, np.repeat(chunk[-1:], batch_size - b, 0)])
                    strong, weak = sharded(chunk)
                    return strong[:b], weak[:b]
        for path in paths:
            with span("predict.read", seconds, "read"):
                audio = load_recording(path, cfg.audio.sr)
            batches = []

            def counted(chunk):
                batches.append(len(chunk))
                return forward(chunk)
            with span("predict.forward", seconds, "forward"):
                strong, _ = predict_long_recording(
                    counted, audio, cfg, batch_size=batch_size,
                    hop_seconds=hop_seconds)
            events = decode_events(strong, cfg, threshold, learned_post,
                                   device=dev, seconds=seconds)
            name = os.path.basename(path)
            out["rows"].extend((name, label, a, b) for label, a, b in events)
            out["batches"].append(batches)
            out["audio_seconds"] += len(audio) / cfg.audio.sr
            if keep_posteriors:
                out["posteriors"].append(strong)
    return out


def write_event_tsv(rows: Sequence[Row], path: str) -> None:
    """The events TSV as ``bsed_tpu`` writes it with pandas: the header
    filename/event_label/onset/offset, tab-separated, "\\n" line ends,
    times as "%.3f"; no events: the header alone."""
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh, delimiter="\t", lineterminator="\n")
        writer.writerow(TSV_COLUMNS)
        writer.writerows((name, label, "%.3f" % a, "%.3f" % b)
                         for name, label, a, b in rows)
