"""Runner ``serve``: a closed loop of one caller serving batches of clips
through ``bsed_tpu_torch.serve.make_fast_forward``.

Set-up makes the weights and a pool of distinct audio batches on the
device from the seed, sets each block's BatchNorm statistics from the
pool's first clips (the reference's ``block_input_stats``), builds the
forward and runs every pool batch through it (the only shape the window
uses). A unit calls the forward on the next pool batch and copies its
frame and clip posteriors to the host. For the check, the posteriors of
one occurrence of each pool batch, drawn from the seed, are kept, and the
reference computes the same batches once the window has closed.

Mix keys: ``batch``, ``pool_batches``, ``precision`` (the entry's tier),
``calibration_clips``, ``occurrences`` (the kept occurrence is drawn
from the first this many), ``audio`` (``synth.py``), ``traced``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np

from portbench.harness import stats as S
from portbench.harness import synth
from portbench.harness import weights as Wt
from portbench.harness.port import port_config
from portbench.harness.window import span


# the mix cut to a CPU test's size (``tests/tiny_cells.py``)
TINY = {"batch": 4, "pool_batches": 3, "calibration_clips": 4}


class Runner:
    unit_name = "batch"
    kind = "serve"

    def __init__(self, run):
        self.run = run
        self.device = run.device
        self.mix = run.mix
        self.model = run.config["model"]
        self.audio = run.config["audio"]
        self.kept: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def setup(self) -> None:
        import torch
        from bsed_tpu_torch.serve import make_fast_forward
        from portbench.reference import crnn as R
        from portbench.reference.frontend import log_mel
        from portbench.harness.device import tf32

        run, mix = self.run, self.mix
        w_seed, a_seed, k_seed = run.seeds(3)
        self.cfg = port_config(run.config, self.kind, mix)
        self.params = Wt.make_params(self.model, w_seed, self.device)
        b, n = mix["batch"], mix["pool_batches"]
        self.pool = synth.clips(a_seed, n * b, self.audio, mix["audio"],
                                self.device).reshape(n, b, -1)
        with torch.no_grad(), tf32(False):
            lm = log_mel(self.pool[0, :mix["calibration_clips"]], self.audio)
            self.stats = {"encoder": {"cnn": R.block_input_stats(
                lm, self.params, self.model)}}
        rng = np.random.default_rng(k_seed)
        self.keep_at = rng.integers(0, mix["occurrences"], size=n)
        if run.control is not None:
            self.forward = self._control(run.control)
        else:
            self.forward = make_fast_forward(
                self.cfg, Wt.to_numpy(self.params), Wt.to_numpy(self.stats),
                device=self.device, precision=mix["precision"])
        if run.fault is not None:
            self.forward = run.fault(self.forward)
        for j in range(n):                          # warm-up: every batch
            strong, weak = self.forward(self.pool[j])
            strong.cpu(), weak.cpu()
        self.kept.clear()

    def _control(self, control):
        """The reference at the control's precision in the program's
        place (``reference/controls.py``)."""
        import torch
        from portbench.reference import crnn as R
        from portbench.reference.frontend import log_mel
        from portbench.harness.device import tf32

        def forward(audio):
            with torch.no_grad(), tf32(control.tf32):
                return R.forward(log_mel(audio, self.audio), self.params,
                                 self.stats, self.model, control.q)
        return forward

    def unit(self, k: int) -> float:
        n = self.mix["pool_batches"]
        j = k % n
        with span(self, "forward"):
            strong, weak = self.forward(self.pool[j])
        with span(self, "fetch"):
            s, w = strong.cpu(), weak.cpu()
        if k // n <= self.keep_at[j]:
            self.kept[j] = (s.numpy(), w.numpy())
        return float(self.mix["batch"])

    def drain(self) -> float:
        return time.perf_counter()

    def end_to_end(self, window) -> Dict[str, float]:
        return {"serve_clips_per_s": S.rate(window.units, window.start),
                "serve_batch_p95_ms":
                    S.percentile(S.latencies(window.units), 95) * 1e3}

    def flops_per_unit(self) -> float:
        from portbench.harness.work import forward_flops
        per_clip = sum(forward_flops(self.run.config, True).values())
        return per_clip * self.mix["batch"]

    def release(self) -> None:
        self.forward = None

    def check(self, limits: Dict[str, float]
              ) -> Tuple[List[Tuple[str, float]], int]:
        """([(name, value)], failed): the widest gaps between the kept
        posteriors and the reference's over every kept batch, and how
        many kept batches exceed a limit."""
        import torch
        from portbench.reference import crnn as R
        from portbench.reference.frontend import log_mel
        from portbench.harness.device import tf32

        gap_s = gap_w = 0.0
        failed = 0
        missing = self.mix["pool_batches"] - len(self.kept)
        with torch.no_grad(), tf32(False):
            for j, (s, w) in sorted(self.kept.items()):
                rs, rw = R.forward(log_mel(self.pool[j], self.audio),
                                   self.params, self.stats, self.model)
                gs = float(np.abs(s - rs.cpu().numpy()).max())
                gw = float(np.abs(w - rw.cpu().numpy()).max())
                failed += (gs > limits["frame_posterior_gap"]
                           or gw > limits["clip_posterior_gap"])
                gap_s, gap_w = max(gap_s, gs), max(gap_w, gw)
        if missing:
            gap_s = gap_w = float("inf")
        return [("frame_posterior_gap", gap_s),
                ("clip_posterior_gap", gap_w)], failed + missing


# --- faults planted under the timed path (the check's tests and readings)

def answer_altered(forward):
    """One clip's frame posteriors flipped."""
    def f(audio):
        strong, weak = forward(audio)
        strong = strong.clone()
        strong[0] = 1.0 - strong[0]
        return strong, weak
    return f


def half_left_out(forward):
    """The first half of the batch served, its answers reused for the
    rest."""
    import torch

    def f(audio):
        n = len(audio) // 2
        strong, weak = forward(audio[:n])
        return torch.cat([strong, strong]), torch.cat([weak, weak])
    return f


FAULTS = (answer_altered, half_left_out)
