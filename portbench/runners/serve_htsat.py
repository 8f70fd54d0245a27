"""Runner ``serve_htsat``: ``serve``'s closed loop of one caller, on a
configuration served by HTS-AT in place of the CRNN, through the same
entry, ``bsed_tpu_torch.serve.make_fast_forward``.

Set-up first checks that the port has HTS-AT
(``bsed_tpu_torch.config.HtsatConfig``) and refuses the cell at once
where it has not. It then makes the state dict from the seed
(``harness/htsat.py``), the pool of audio batches as ``serve`` does,
bn0's statistics from the pool's first clips through the reference's
front end, and builds and warms the forward. Units, the end-to-end
metrics and the kept posteriors are ``serve``'s; beside each kept batch's
posteriors the runner keeps two sets of tokens that the same timed call
produced: the last stage's after the final LayerNorm and the first
stage's after its patch merge (forward hooks on the port's module,
``forward.htsat``, and on its ``layers[0]`` hold a reference to each
output: no copy in the window). The check compares them with
``reference/htsat.forward`` (float32, TF32 off) after the window: the
widest frame and clip posterior gaps, as ``serve``'s, and the largest
relative gap ‖e − r‖/‖r‖ of a kept batch's last-stage tokens and of its
first-stage tokens in the band the shifted windows wrap (``wrap_band``).
The last stage's tokens see a fault in the attention or the merges
before the head's mean over time damps it; the band sees the shift's
mask, which alters no other token, before three more stages dilute it.

Mix keys: ``serve``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from portbench.harness import htsat as H
from portbench.harness import synth
from portbench.harness import weights as Wt
from portbench.runners import serve as S
from portbench.runners.serve import answer_altered, half_left_out

TINY = S.TINY


def port_has_htsat() -> bool:
    from bsed_tpu_torch import config as C
    return hasattr(C, "HtsatConfig") and "htsat" in {
        f.name for f in dataclasses.fields(C.ModelConfig)}


def port_config(config, mix):
    """The port's ``Config``: the configuration's serving preset with its
    audio geometry, HTS-AT's settings and the compute dtype it states."""
    from bsed_tpu_torch.config import HtsatConfig, get_config
    cfg = get_config(mix.get("preset", config["presets"]["serve"]))
    if config["nclass"] != cfg.nclass:
        raise ValueError(f"nclass {config['nclass']} but the preset lists "
                         f"{cfg.nclass} classes")
    hc = {k: tuple(v) if isinstance(v, list) else v
          for k, v in config["htsat"].items()}
    return cfg.replace(
        audio=dataclasses.replace(cfg.audio, **config["audio"]),
        model=dataclasses.replace(
            cfg.model, htsat=HtsatConfig(**hc),
            compute_dtype=mix.get("compute_dtype",
                                  config["precision"]["serve"])))


class Runner(S.Runner):

    def __init__(self, run):
        self.run, self.device, self.mix = run, run.device, run.mix
        self.audio = run.config["audio"]
        self.kept: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def setup(self) -> None:
        import torch
        if not port_has_htsat():
            raise RuntimeError("the port has no HTS-AT "
                               "(bsed_tpu_torch.config.HtsatConfig): it "
                               "cannot serve this configuration")
        from bsed_tpu_torch.serve import make_fast_forward
        from portbench.reference import htsat as RH

        run, mix, config = self.run, self.mix, self.run.config
        w_seed, a_seed, k_seed = run.seeds(3)
        self.cfg = port_config(config, mix)
        self.params = H.make_params(config, w_seed, self.device)
        b, n = mix["batch"], mix["pool_batches"]
        self.pool = synth.clips(a_seed, n * b, self.audio, mix["audio"],
                                self.device).reshape(n, b, -1)
        with torch.no_grad(), RH._no_tf32():
            self.stats = H.bn0_stats(RH.log_mel(
                self.pool[0, :mix["calibration_clips"]], self.audio))
        rng = np.random.default_rng(k_seed)
        self.keep_at = rng.integers(0, mix["occurrences"], size=n)
        self.tokens, self.kept_tokens = None, {}
        self.stage1, self.kept_stage1 = None, {}
        if run.control is not None:
            self.forward = self._control(run.control)
        else:
            self.forward = make_fast_forward(
                self.cfg, Wt.to_numpy(self.params), Wt.to_numpy(self.stats),
                device=self.device, precision=mix["precision"])
            self.forward.htsat.register_forward_hook(self._note)
            self.forward.htsat.layers[0].register_forward_hook(
                self._note_stage1)
        if run.fault is not None:
            self.forward = run.fault(self.forward)
        for j in range(n):                          # warm-up: every batch
            strong, weak = self.forward(self.pool[j])
            strong.cpu(), weak.cpu()
        self.kept.clear()
        self.kept_tokens.clear()
        self.kept_stage1.clear()

    def _note(self, module, inputs, out) -> None:
        self.tokens = out

    def _note_stage1(self, module, inputs, out) -> None:
        self.stage1 = out

    def _control(self, control):
        import torch
        from portbench.reference import htsat as RH

        def forward(audio):
            with torch.no_grad():
                strong, weak, self.tokens, self.stage1 = RH.forward(
                    audio, self.params, self.stats, self.run.config,
                    control.q)
                return strong, weak
        return forward

    def unit(self, k: int) -> float:
        n = self.mix["pool_batches"]
        j = k % n
        out = super().unit(k)
        if k // n <= self.keep_at[j]:
            self.kept_tokens[j] = self.tokens
            self.kept_stage1[j] = self.stage1
        return out

    def flops_per_unit(self) -> float:
        config = self.run.config
        per_clip = (sum(H.htsat_flops(config).values())
                    + H.frontend_flops(config))
        return per_clip * self.mix["batch"]

    def check(self, limits: Dict[str, float]
              ) -> Tuple[List[Tuple[str, float]], int]:
        """``serve``'s check and the two token gaps, against
        ``reference/htsat.forward``; tokens of another shape than the
        reference's read as an infinite gap."""
        import torch
        from portbench.reference import htsat as RH

        gap_s = gap_w = gap_t = gap_b = 0.0
        failed = 0
        missing = self.mix["pool_batches"] - len(self.kept)
        band = wrap_band(self.run.config).to(self.device)
        with torch.no_grad():
            for j, (s, w) in sorted(self.kept.items()):
                rs, rw, r_tok, r_1 = RH.forward(self.pool[j], self.params,
                                                self.stats, self.run.config)
                gs = float(np.abs(s - rs.cpu().numpy()).max()) \
                    if s.shape == tuple(rs.shape) else float("inf")
                gw = float(np.abs(w - rw.cpu().numpy()).max()) \
                    if w.shape == tuple(rw.shape) else float("inf")
                gt = _relative_gap(self.kept_tokens[j], r_tok)
                e1 = self.kept_stage1[j]
                gb = (_relative_gap(e1[:, band], r_1[:, band])
                      if e1.shape == r_1.shape else float("inf"))
                failed += (gs > limits["frame_posterior_gap"]
                           or gw > limits["clip_posterior_gap"]
                           or gt > limits["token_gap"]
                           or gb > limits["stage1_band_gap"])
                gap_s, gap_w = max(gap_s, gs), max(gap_w, gw)
                gap_t, gap_b = max(gap_t, gt), max(gap_b, gb)
        if missing:
            gap_s = gap_w = gap_t = gap_b = float("inf")
        return [("frame_posterior_gap", gap_s),
                ("clip_posterior_gap", gap_w),
                ("token_gap", gap_t),
                ("stage1_band_gap", gap_b)], failed + missing


def wrap_band(config):
    """Which tokens of the first stage's merged map the shifted windows'
    wrap-around reaches: on the stage's own map those within the shift,
    w/2, of an edge, so within w/4 on the map the merge halves. Leaving
    out the shift's mask alters only these."""
    import torch
    hc = config["htsat"]
    side = hc["spec_size"] // hc["patch_stride"]
    width = min(hc["window_size"], side) // 4
    idx = torch.arange(side // 2)
    edge = (idx < width) | (idx >= side // 2 - width)
    return (edge[:, None] | edge[None, :]).reshape(-1)


def _relative_gap(e, r) -> float:
    """‖e − r‖/‖r‖, or infinity where the shapes differ."""
    return (float((e.float() - r).norm() / r.norm())
            if e.shape == r.shape else float("inf"))


# --- faults planted under the timed path: the served module altered in
# place once, before the warm-up (its block biases are built again from
# what changed)

def _altered(forward, alter):
    import torch
    with torch.no_grad():
        for blk in (b for stage in forward.htsat.layers
                    for b in stage.blocks):
            alter(blk)
    return forward


def shift_left_out(forward):
    """The odd blocks neither rolled nor masked."""
    def alter(blk):
        blk.shift_size = 0
    return _altered(forward, alter)


def shift_mask_left_out(forward):
    """The odd blocks rolled, with no −100 between regions."""
    def alter(blk):
        if blk.attn_mask is not None:
            blk.attn_mask.zero_()
    return _altered(forward, alter)


def rel_bias_left_out(forward):
    """Every block's relative-position table at 0."""
    def alter(blk):
        blk.attn.relative_position_bias_table.zero_()
    return _altered(forward, alter)


def merge_order_altered(forward):
    """The patch merges gather (1, 0) and (0, 1) in each other's place:
    their LayerNorm and reduction read the gathered parts x1 and x2
    swapped, which is what swapping x1 and x2 in the gather computes."""
    import torch
    with torch.no_grad():
        for stage in forward.htsat.layers:
            m = stage.downsample
            if m is None:
                continue
            c = m.reduction.weight.shape[1] // 4
            perm = torch.cat([torch.arange(0, c), torch.arange(2 * c, 3 * c),
                              torch.arange(c, 2 * c),
                              torch.arange(3 * c, 4 * c)]).to(
                m.reduction.weight.device)
            m.reduction.weight.copy_(m.reduction.weight[:, perm])
            m.norm.weight.copy_(m.norm.weight[perm])
            m.norm.bias.copy_(m.norm.bias[perm])
    return forward


FAULTS = (answer_altered, half_left_out, shift_left_out, shift_mask_left_out,
          rel_bias_left_out, merge_order_altered)
