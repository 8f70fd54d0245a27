"""Runner ``serve_beats``: ``serve``'s closed loop of one caller, on a
configuration with a BEATs encoder fused into the CRNN (its ``beats``
and ``fusion`` blocks), through the same entry,
``bsed_tpu_torch.serve.make_fast_forward``.

Set-up first checks that the port has the BEATs branch
(``bsed_tpu_torch.config.BeatsConfig``) and refuses the cell at once
where it has not. It then makes the CRNN's weights, BEATs' state dict and
the fusion's ``cat_tf`` from the seed (``harness/beats.py``), the pool of
audio batches and the CNN's BatchNorm statistics as ``serve`` does, and
builds and warms the forward. Units, the end-to-end metrics and the kept
posteriors are ``serve``'s; beside each kept batch's posteriors the
runner keeps the BEATs embeddings that the same timed call produced (a
forward hook on the port's encoder module, ``forward.beats.encoder``,
holds a reference to its output: no copy in the window). The check
compares both with ``reference/beats.encode`` (float32, TF32 off) after
the window: the widest frame and clip posterior gaps, as ``serve``'s, and
the largest relative gap ‖e − r‖/‖r‖ of a kept batch's embeddings, which
sees a fault in the attention before the BiGRU and the head damp it.

Mix keys: ``serve``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from portbench.harness import beats as B
from portbench.harness import synth
from portbench.harness import weights as Wt
from portbench.harness.port import port_config
from portbench.runners import serve as S
from portbench.runners.serve import answer_altered, half_left_out

TINY = S.TINY


def port_has_beats() -> bool:
    from bsed_tpu_torch import config as C
    return hasattr(C, "BeatsConfig") and "beats" in {
        f.name for f in dataclasses.fields(C.ModelConfig)}


class Runner(S.Runner):

    def setup(self) -> None:
        import torch
        if not port_has_beats():
            raise RuntimeError("the port has no BEATs branch "
                               "(bsed_tpu_torch.config.BeatsConfig): it "
                               "cannot serve this configuration")
        from bsed_tpu_torch.config import BeatsConfig
        from bsed_tpu_torch.serve import make_fast_forward
        from portbench.reference import crnn as R
        from portbench.reference.frontend import log_mel
        from portbench.harness.device import tf32

        run, mix, config = self.run, self.mix, self.run.config
        w_seed, a_seed, k_seed, b_seed = run.seeds(4)
        fusion = config["fusion"]
        if (fusion["in_features"] != self.model["nb_filters"][-1]
                + config["beats"]["encoder_embed_dim"]
                or fusion["out_features"] != self.model["nb_filters"][-1]):
            raise ValueError(f"the fusion's widths {fusion} do not join "
                             "the CNN's channels and BEATs' width")
        cfg = port_config(config, self.kind, mix)
        self.cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, beats=BeatsConfig(**config["beats"])))
        self.params = B.make_params(config, w_seed, b_seed, self.device)
        b, n = mix["batch"], mix["pool_batches"]
        self.pool = synth.clips(a_seed, n * b, self.audio, mix["audio"],
                                self.device).reshape(n, b, -1)
        with torch.no_grad(), tf32(False):
            lm = log_mel(self.pool[0, :mix["calibration_clips"]], self.audio)
            self.stats = {"encoder": {"cnn": R.block_input_stats(
                lm, self.params, self.model)}}
        rng = np.random.default_rng(k_seed)
        self.keep_at = rng.integers(0, mix["occurrences"], size=n)
        self.emb, self.kept_emb = None, {}
        if run.control is not None:
            self.forward = self._control(run.control)
        else:
            self.forward = make_fast_forward(
                self.cfg, Wt.to_numpy(self.params), Wt.to_numpy(self.stats),
                device=self.device, precision=mix["precision"])
            self.forward.beats.encoder.register_forward_hook(self._note)
        if run.fault is not None:
            self.forward = run.fault(self.forward)
        for j in range(n):                          # warm-up: every batch
            strong, weak = self.forward(self.pool[j])
            strong.cpu(), weak.cpu()
        self.kept.clear()
        self.kept_emb.clear()

    def _note(self, module, inputs, out) -> None:
        self.emb = out

    def _control(self, control):
        import torch
        from portbench.reference import beats as RB
        from portbench.reference import crnn as R
        from portbench.harness.device import tf32

        def forward(audio):
            with torch.no_grad(), tf32(control.tf32):
                h, self.emb = RB.encode(audio, self.params, self.stats,
                                        self.run.config, control.q)
                return R.predictor(h, self.params["predictor"])
        return forward

    def unit(self, k: int) -> float:
        n = self.mix["pool_batches"]
        j = k % n
        out = super().unit(k)
        if k // n <= self.keep_at[j]:
            self.kept_emb[j] = self.emb
        return out

    def flops_per_unit(self) -> float:
        from portbench.harness.work import forward_flops
        config = self.run.config
        per_clip = (sum(B.beats_flops(config).values())
                    + B.fusion_flops(config)
                    + sum(forward_flops(config, True).values()))
        return per_clip * self.mix["batch"]

    def check(self, limits: Dict[str, float]
              ) -> Tuple[List[Tuple[str, float]], int]:
        """``serve``'s check and the embeddings' gap, against
        ``reference/beats.encode``; an embedding of another shape than
        the reference's reads as an infinite gap."""
        import torch
        from portbench.reference import beats as RB
        from portbench.reference import crnn as R

        gap_s = gap_w = gap_e = 0.0
        failed = 0
        missing = self.mix["pool_batches"] - len(self.kept)
        with torch.no_grad():
            for j, (s, w) in sorted(self.kept.items()):
                h, r_emb = RB.encode(self.pool[j], self.params, self.stats,
                                     self.run.config)
                rs, rw = R.predictor(h, self.params["predictor"])
                gs = float(np.abs(s - rs.cpu().numpy()).max())
                gw = float(np.abs(w - rw.cpu().numpy()).max())
                emb = self.kept_emb[j]
                ge = (float((emb.float() - r_emb).norm() / r_emb.norm())
                      if emb.shape == r_emb.shape else float("inf"))
                failed += (gs > limits["frame_posterior_gap"]
                           or gw > limits["clip_posterior_gap"]
                           or ge > limits["embedding_gap"])
                gap_s, gap_w = max(gap_s, gs), max(gap_w, gw)
                gap_e = max(gap_e, ge)
        if missing:
            gap_s = gap_w = gap_e = float("inf")
        return [("frame_posterior_gap", gap_s),
                ("clip_posterior_gap", gap_w),
                ("embedding_gap", gap_e)], failed + missing


# --- faults planted under the timed path: the attention's entry replaced
# for the length of each forward call (carrying its launch counter, as a
# harness span's wrapper does)

def _attention_replaced(forward, make):
    from bsed_tpu_torch.ops import rel_attention as RA

    def f(audio):
        entry = RA.gated_rel_attention
        stand_in = make(entry)
        stand_in.launches = entry.launches
        RA.gated_rel_attention = stand_in
        try:
            return forward(audio)
        finally:
            entry.launches = stand_in.launches
            RA.gated_rel_attention = entry
    return f


def rel_bias_left_out(forward):
    """The attention without g ⊙ P."""
    import torch
    return _attention_replaced(forward, lambda entry: (
        lambda q, k, v, gate, bias: entry(q, k, v, gate,
                                          torch.zeros_like(bias))))


def gate_left_out(forward):
    """The attention with g fixed at 1."""
    import torch
    return _attention_replaced(forward, lambda entry: (
        lambda q, k, v, gate, bias: entry(q, k, v, torch.ones_like(gate),
                                          bias)))


FAULTS = (answer_altered, half_left_out, rel_bias_left_out, gate_left_out)
