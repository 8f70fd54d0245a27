"""Runner ``predict``: the user's raw-audio path,
``bsed_tpu_torch.predict.predict_recordings``, over a directory of WAV
recordings, a few files a call.

Set-up makes the weights on the device from the seed, sets each block's
BatchNorm statistics from synthetic clips at the model's rate, and writes
the recordings under ``TMPDIR``: mono 16-bit WAVs, synthetic field audio
(``synth.py``), with the same set of lengths and sample rates for every
seed (the quantiles of the mix's duration range, the rates in equal
shares) in an order the seed draws. It then warms the path with one call
on the pool's first files. A unit is one call on the next ``per_call``
recordings of the cycling pool; its work is their length in seconds. For
the check, a sample of the window's calls drawn from the seed keeps its
posteriors and events; once the window has closed the reference reads
the same files, computes their posteriors and decodes the program's
posteriors itself.

Mix keys: ``recordings``, ``per_call``, ``batch_size``, ``precision``,
``durations_s`` [lo, hi], ``rates_hz``, ``threshold``, ``checked_calls``,
``calibration_clips``, ``audio`` (``synth.py``), ``traced``.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Dict, List, Tuple

import numpy as np

from portbench.harness import stats as S
from portbench.harness import synth
from portbench.harness import weights as Wt
from portbench.harness.port import port_config


def median_window(audio, model, seconds: float) -> int:
    from portbench.reference.recording import frame_seconds
    return max(int(seconds / frame_seconds(audio, model)), 1)


# the mix cut to a CPU test's size (``tests/tiny_cells.py``)
TINY = {"recordings": 6, "per_call": 2, "durations_s": [2.0, 5.0],
        "rates_hz": [4800, 4410, 3200], "checked_calls": [2, 3],
        "batch_size": 4, "calibration_clips": 4}


class Runner:
    unit_name = "call"
    kind = "predict"

    def __init__(self, run):
        self.run = run
        self.device = run.device
        self.mix = run.mix
        self.model = run.config["model"]
        self.audio = run.config["audio"]
        self.kept: Dict[int, Tuple[List[str], Dict]] = {}
        self.calls: List[Dict] = []
        self.dir = None

    def _write_pool(self, seed: int) -> None:
        import torch
        from scipy.io import wavfile

        mix = self.mix
        n = mix["recordings"]
        lo, hi = mix["durations_s"]
        durations = lo + (hi - lo) * (np.arange(n) + 0.5) / n
        rates = [mix["rates_hz"][i % len(mix["rates_hz"])] for i in range(n)]
        rng = np.random.default_rng(seed)
        order = rng.permutation(n)
        self.dir = tempfile.mkdtemp(prefix="portbench-wav-")
        self.paths = []
        for i, j in enumerate(order):
            rate = rates[j]
            x = synth.clips(seed + i, 1, dict(self.audio, sr=rate),
                            mix["audio"], self.device,
                            seconds=float(durations[j]))[0]
            pcm = (x.clamp(-1.0, 1.0) * 32767.0).round().to(torch.int16)
            path = os.path.join(self.dir, f"rec{i:03d}_{rate}.wav")
            wavfile.write(path, rate, pcm.cpu().numpy())
            self.paths.append(path)

    def setup(self) -> None:
        import torch
        from portbench.reference import crnn as R
        from portbench.reference.frontend import log_mel
        from portbench.harness.device import tf32

        run, mix = self.run, self.mix
        w_seed, a_seed, f_seed, k_seed = run.seeds(4)
        self.cfg = port_config(run.config, self.kind, mix)
        self.params = Wt.make_params(self.model, w_seed, self.device)
        calib = synth.clips(a_seed, mix["calibration_clips"], self.audio,
                            mix["audio"], self.device)
        with torch.no_grad(), tf32(False):
            self.stats = {"encoder": {"cnn": R.block_input_stats(
                log_mel(calib, self.audio), self.params, self.model)}}
        del calib
        self._write_pool(f_seed % (2 ** 62))
        self.np_params = Wt.to_numpy(self.params)
        self.np_stats = Wt.to_numpy(self.stats)
        rng = np.random.default_rng(k_seed)
        self.check_at = set(rng.choice(mix["checked_calls"][1],
                                       mix["checked_calls"][0],
                                       replace=False).tolist())
        self.predict = self._program() if run.control is None else \
            self._control(run.control)
        if run.fault is not None:
            self.predict = run.fault(self.predict)
        self.predict(self.paths[:mix["per_call"]])          # warm-up

    def _program(self):
        from bsed_tpu_torch.predict import predict_recordings

        def call(paths):
            return predict_recordings(
                self.cfg, self.np_params, self.np_stats, paths,
                device=self.device, precision=self.mix["precision"],
                threshold=self.mix["threshold"],
                batch_size=self.mix["batch_size"], keep_posteriors=True)
        return call

    def _control(self, control):
        """The reference at the control's precision in the program's
        place, returning what ``predict_recordings`` returns."""
        from portbench.reference import recording as RC

        def call(paths):
            t0 = time.perf_counter()
            out = {"posteriors": [], "rows": [], "audio_seconds": 0.0,
                   "seconds": {"read": 0.0}}
            for p in paths:
                x = RC.read_wav(p, self.audio["sr"])
                out["posteriors"].append(self._timeline(x, control))
                out["audio_seconds"] += len(x) / self.audio["sr"]
            out["seconds"]["read"] = time.perf_counter() - t0
            return out
        return call

    def _timeline(self, x, control=None):
        import torch
        from portbench.reference import crnn as R, recording as RC
        from portbench.reference.frontend import log_mel
        from portbench.reference import quant
        from portbench.harness.device import tf32

        q = control.q if control is not None else quant.identity
        on = control.tf32 if control is not None else False

        def forward(win):
            with torch.no_grad(), tf32(on):
                a = torch.as_tensor(win, device=self.device)
                s, _ = R.forward(log_mel(a, self.audio), self.params,
                                 self.stats, self.model, q)
                return s.cpu().numpy()
        frames = (1 + int(self.audio["sr"] * self.audio["max_len_seconds"])
                  // self.audio["hop_size"])
        for pt, _ in self.model["pooling"]:
            frames //= pt
        return RC.timeline(x, forward, self.audio, self.model, frames)

    def unit(self, k: int) -> float:
        m = self.mix["per_call"]
        n = len(self.paths)
        paths = [self.paths[(k * m + i) % n] for i in range(m)]
        t0 = time.perf_counter()
        out = self.predict(paths)
        wall = time.perf_counter() - t0
        self.calls.append({"wall": wall, "read": out["seconds"]["read"]})
        if k in self.check_at:
            self.kept[k] = (paths, out)
        return float(out["audio_seconds"])

    def drain(self) -> float:
        return time.perf_counter()

    def end_to_end(self, window) -> Dict[str, float]:
        return {"predict_audio_s_per_s": S.rate(window.units, window.start)}

    def read_share(self) -> float:
        wall = sum(c["wall"] for c in self.calls)
        return 100.0 * sum(c["read"] for c in self.calls) / wall

    def flops_per_unit(self) -> float:
        raise NotImplementedError("no mfu is read for predict")

    def release(self) -> None:
        self.predict = None

    def check(self, limits) -> Tuple[List[Tuple[str, float]], int]:
        """The widest gap between a kept call's frame posteriors and the
        reference's, and the recordings whose events differ from the
        reference's decode of the program's own posteriors."""
        from portbench.reference import recording as RC

        sec = RC.frame_seconds(self.audio, self.model)
        win = median_window(self.audio, self.model,
                            self.run.config["median_window_s"])
        names = self.run.config["classes"]
        gap, mismatched, failed = 0.0, 0, 0
        for k, (paths, out) in sorted(self.kept.items()):
            bad = False
            for i, p in enumerate(paths):
                want = self._timeline(RC.read_wav(p, self.audio["sr"]))
                got = np.asarray(out["posteriors"][i], np.float32)
                g = (float(np.abs(got - want).max())
                     if got.shape == want.shape else float("inf"))
                gap = max(gap, g)
                bad |= g > limits["frame_posterior_gap"]
                if "rows" in out and self.run.control is None:
                    name = os.path.basename(p)
                    mine = sorted((names[c], a, b) for c, a, b in RC.events(
                        got, self.mix["threshold"], win, sec))
                    theirs = sorted((lab, a, b) for f, lab, a, b
                                    in out["rows"] if f == name)
                    same = len(mine) == len(theirs) and all(
                        x[0] == y[0] and abs(x[1] - y[1]) < 1e-6
                        and abs(x[2] - y[2]) < 1e-6
                        for x, y in zip(mine, theirs))
                    mismatched += not same
                    bad |= not same
            failed += bad
        if not self.kept:
            gap, failed = float("inf"), 1
        return [("frame_posterior_gap", gap),
                ("event_mismatches", float(mismatched))], failed

    def close(self) -> None:
        if self.dir:
            shutil.rmtree(self.dir, ignore_errors=True)
            self.dir = None


# --- faults planted under the timed path (the check's tests and readings)

def posteriors_altered(predict):
    """One recording's posteriors shifted by 0.2."""
    def f(paths):
        out = predict(paths)
        out["posteriors"][0] = out["posteriors"][0] + 0.2
        return out
    return f


def event_altered(predict):
    """One event too many in a call's rows."""
    def f(paths):
        out = predict(paths)
        name = paths[0].rsplit("/", 1)[-1]
        out["rows"] = list(out["rows"]) + [(name, "EATO", 0.0, 0.5)]
        return out
    return f


FAULTS = (posteriors_altered, event_altered)
