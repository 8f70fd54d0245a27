"""Runner ``train``: the mean-teacher + ISP train step
(``bsed_tpu_torch.train.steps.make_train_step``) fed by the port's
``data/pipeline.ThreeStreamLoader`` from datasets resident on the device.

Set-up makes the student's and the teacher's weights on the device from
the seed and a pool of clips for ``pool_steps`` steps: synthetic audio
(``synth.py``) turned into linear mel by the reference front end, random
strong labels for the syn stream and weak labels for the two real
streams. It builds one train state and drives it through its first
``checked_steps`` steps by the window's own call and feed (the loader's
first batches, rows that all differ); those steps warm every shape, and
their losses, the first gradient (Adam's first moment after one step over
0.1) and the state after the last (the student's and the teacher's
parameters and BatchNorm running statistics) are kept. The window then goes on
with the same state. Once it has closed, the reference replays those
steps from the same weights, batches and draws.

Mix keys: ``perf`` (the --perf form), ``batch``, ``pool_steps``,
``epoch``, ``checked_steps``, ``labels`` (event rates), ``audio``
(``synth.py``), ``traced``.
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

# the kept state trees and their keys in ``export_train_state``
STATE_TREES = (("params", "params"), ("teacher", "ema_params"),
               ("stats", "batch_stats"), ("teacher_stats", "ema_batch_stats"))
RECIPE_KEYS = ("max_learning_rate", "adjust_lr", "rampdown_epochs",
               "max_consistency_cost", "ema_alpha", "time_shift_max",
               "freq_shift_max", "batch_size", "mean_teacher", "isp",
               "isp_flavor", "mixup", "real_weak_bce", "supervise_on",
               "cost_ramp", "ema_scope", "optimizer", "normalize")


class _Dataset:
    """A stream's (features, targets) held on the device."""

    def __init__(self, feats, targets):
        self.feats, self.targets = feats, targets

    def __len__(self):
        return len(self.feats)

    def as_arrays(self):
        return self.feats, self.targets


# the mix cut to a CPU test's size (``tests/tiny_cells.py``)
TINY = {"batch": 4, "pool_steps": 3, "chunk": 4}


class Runner:
    unit_name = "step"
    kind = "train"

    def __init__(self, run):
        self.run = run
        self.device = run.device
        self.mix = run.mix
        self.model = run.config["model"]
        self.audio = run.config["audio"]
        self.recipe = dict(run.config["train"],
                           folded=bool(run.mix.get("perf")),
                           noise_snr=self.audio["noise_snr"])
        self.fused = bool(run.mix.get("perf"))
        self.kept: Dict = {"losses": []}

    def _check_recipe(self, cfg) -> None:
        """The port's preset runs the recipe the configuration states."""
        t = cfg.train
        for k in RECIPE_KEYS:
            if getattr(t, k) != self.recipe[k]:
                raise ValueError(f"the preset's {k} is {getattr(t, k)!r}, "
                                 f"the configuration states "
                                 f"{self.recipe[k]!r}")
        if t.fused_streams != self.fused:
            raise ValueError("fused_streams differs from the mix's form")

    def _data(self, seed: int):
        """(syn, weak, unlabelled) datasets on the device."""
        import torch
        from portbench.reference.frontend import linear_mel

        mix, a = self.mix, self.audio
        b, steps = mix["batch"], mix["pool_steps"]
        n_syn, n_real = b * steps, b // 2 * steps
        hop = a["hop_size"]

        def mel(seed_i, count):
            return torch.cat([linear_mel(synth.clips(
                seed_i + i, min(mix["chunk"], count - i), a, mix["audio"],
                self.device), a) for i in range(0, count, mix["chunk"])])

        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        frames = 1 + int(a["sr"] * a["max_len_seconds"]) // hop
        ratio = int(np.prod([p[0] for p in self.model["pooling"]]))
        t_out, c = frames // ratio, self.model["nclass"]
        lab = mix["labels"]
        present = torch.rand((n_syn, 1, c), generator=gen,
                             device=self.device) < lab["class_rate"]
        on = torch.randint(0, t_out, (n_syn, 1, c), generator=gen,
                           device=self.device)
        length = torch.randint(lab["event_frames"][0], lab["event_frames"][1],
                               (n_syn, 1, c), generator=gen,
                               device=self.device)
        t = torch.arange(t_out, device=self.device)[None, :, None]
        strong = (present & (t >= on) & (t < on + length)).float()
        weak = (torch.rand((n_real, c), generator=gen, device=self.device)
                < lab["class_rate"]).float()
        unlab = (torch.rand((n_real, c), generator=gen, device=self.device)
                 < lab["class_rate"]).float()
        return (_Dataset(mel(seed, n_syn), strong),
                _Dataset(mel(seed + 10 ** 6, n_real), weak),
                _Dataset(mel(seed + 2 * 10 ** 6, n_real), unlab))

    def setup(self) -> None:
        import torch
        from bsed_tpu_torch.data.pipeline import ThreeStreamLoader

        run, mix = self.run, self.mix
        s_seed, t_seed, d_seed, l_seed, x_seed = run.seeds(5)
        self.cfg = port_config(run.config, self.kind, mix)
        self._check_recipe(self.cfg)
        self.params = Wt.make_params(self.model, s_seed, self.device)
        self.teacher = Wt.make_params(self.model, t_seed, self.device)
        self.data = self._data(d_seed % (2 ** 62))
        self.loader_seed = int(l_seed % (2 ** 31))
        self.step_seed = int(x_seed % (2 ** 31))
        self.loader = ThreeStreamLoader(*self.data, batch_size=mix["batch"],
                                        seed=self.loader_seed,
                                        device=self.device)
        self.epoch_idx = 0
        self.batches = self.loader.epoch(self.epoch_idx)
        if run.control is not None:
            self.trainer = _ReferenceTrainer(self, run.control)
        else:
            self.trainer = _PortTrainer(self)
        if run.fault is not None:
            self.trainer.step = run.fault(self.trainer.step)
        for k in range(mix["checked_steps"]):
            self.kept["losses"].append(self.trainer.loss(self._step()))
            if k == 0:
                self.kept["first_grad"] = self.trainer.first_gradient()
        self.kept["state"] = self.trainer.state_trees()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _next_batch(self):
        try:
            return next(self.batches)
        except StopIteration:
            self.epoch_idx += 1
            self.batches = self.loader.epoch(self.epoch_idx)
            return next(self.batches)

    def _step(self):
        return self.trainer.step(self._next_batch())

    def unit(self, k: int) -> float:
        with span(self, "loader"):
            batch = self._next_batch()
        with span(self, "train_step"):
            self.trainer.step(batch)
        return float(2 * self.mix["batch"])

    def drain(self) -> float:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def end_to_end(self, window) -> Dict[str, float]:
        return {"train_clips_per_s": S.rate(window.units, window.start)}

    def flops_per_unit(self) -> float:
        from portbench.harness.work import train_step_flops
        b = self.mix["batch"]
        return train_step_flops(self.run.config, 3 * b, 6 * b)

    def release(self) -> None:
        self.trainer = None
        self.loader = self.batches = None

    # --- the check ------------------------------------------------------

    def reference_batches(self) -> List[Dict]:
        """The loader's first batches, worked out again from its seed: the
        syn stream's permutation, then the weak and the unlabelled
        streams' (``ThreeStreamLoader.epoch``'s draws)."""
        import torch
        b, half = self.mix["batch"], self.mix["batch"] // 2
        syn, weak, unlab = self.data
        rng = np.random.default_rng(self.loader_seed * 1_000_003 + 0)
        order = rng.permutation(len(syn))
        w_order = rng.permutation(len(weak))
        u_order = rng.permutation(len(unlab))
        out = []
        for k in range(self.mix["checked_steps"]):
            s = order[k * b:(k + 1) * b]
            w = w_order[k * half:(k + 1) * half]
            u = u_order[k * half:(k + 1) * half]
            idx = lambda a: torch.as_tensor(a, device=self.device)  # noqa
            out.append({
                "syn": syn.feats[idx(s)], "syn_strong": syn.targets[idx(s)],
                "real": torch.cat([weak.feats[idx(w)], unlab.feats[idx(u)]]),
                "real_weak": torch.cat([weak.targets[idx(w)],
                                        unlab.targets[idx(u)]]),
                "epoch": float(self.mix["epoch"])})
        return out

    def check(self, limits) -> Tuple[List[Tuple[str, float]], int]:
        """The worst step's relative loss gap; the median leaf's gaps of
        the first gradient's norm and, after the checked steps, of the
        norm of each state tree's change: the student's parameters, the
        teacher's (the EMA), the student's and the teacher's BatchNorm
        running statistics. A leaf's gap is taken against the larger of
        the reference leaf's norm and the median leaf's. The worst leaves'
        gaps are noted in ``detail``: the first conv's gradient reads the
        input's rounding (PERF.md), and is not compared."""
        from portbench.harness.device import tf32
        from portbench.reference import train_step as RT

        fresh = Wt.fresh_stats(self.model, self.device)
        state = RT.RefState(self.params, self.teacher, fresh, fresh)
        with tf32(False):
            ref_losses, grads = [], None
            for k, batch in enumerate(self.reference_batches()):
                terms, g = RT.train_step(state, batch, self.step_seed,
                                         self.model, self.recipe,
                                         self.fused)
                ref_losses.append(terms["loss"])
                if k == 0:
                    grads = g
        loss_gap = max(abs(p - r) / abs(r) for p, r in
                       zip(self.kept["losses"], ref_losses))
        g_ref = {k: float(v.norm()) for k, v in grads.items()}
        g_prog = {k: float(np.linalg.norm(v)) for k, v in
                  self.kept["first_grad"].items()}
        # leaves whose reference gradient is nought to rounding (a conv
        # bias under BatchNorm) move by round-off alone: left out
        med_g = float(np.median(list(g_ref.values())))
        moved = [k for k in g_ref if g_ref[k] >= 1e-3 * med_g]
        grad = {k: abs(g_prog[k] - g_ref[k]) / max(g_ref[k], med_g)
                for k in moved}
        kept = self.kept["state"]
        trees = {"change": ("params", self.params, state.params, moved),
                 "teacher_change": ("teacher", self.teacher, state.teacher,
                                    None),
                 "stats_change": ("stats", fresh, state.stats, None),
                 "teacher_stats_change": ("teacher_stats", fresh,
                                          state.teacher_stats, None)}
        gaps = {name: _change_gaps(kept[key], dict(RT._leaves(start)),
                                   dict(RT._leaves(end)), only)
                for name, (key, start, end, only) in trees.items()}

        def worst(d):
            return sorted(((v, ".".join(k)) for k, v in d.items()),
                          reverse=True)[:4]
        self.detail = {
            "left_out": [".".join(k) for k in g_ref if k not in moved],
            "grad_worst": worst(grad),
            **{f"{name}_worst": worst(g) for name, g in gaps.items()},
            "losses": [self.kept["losses"], ref_losses]}
        numbers = [("loss_gap", loss_gap),
                   ("grad_gap_median_leaf",
                    float(np.median(list(grad.values()))))]
        numbers += [(f"{name}_gap_median_leaf",
                     float(np.median(list(g.values()))))
                    for name, g in gaps.items()]
        failed = sum(v > limits[k] for k, v in numbers)
        return numbers, int(failed)


def _change_gaps(prog, start, ref, only=None):
    """{leaf: |‖prog − start‖ − ‖ref − start‖| / max(‖ref − start‖,
    the median leaf's)} over ``only`` (default every leaf)."""
    keys = list(ref) if only is None else list(only)
    d_ref = {k: float((ref[k] - start[k]).norm()) for k in keys}
    d_prog = {k: float(np.linalg.norm(prog[k] - start[k].cpu().numpy()))
              for k in keys}
    med = float(np.median(list(d_ref.values())))
    return {k: abs(d_prog[k] - d_ref[k]) / max(d_ref[k], med) for k in keys}


def _tree_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_leaves(v, prefix + (k,))
    else:
        yield prefix, tree


class _PortTrainer:
    """The port's train state and step."""

    def __init__(self, d: Runner):
        from bsed_tpu_torch.train import steps

        self.d = d
        modules = steps.build_modules(d.cfg, device=d.device)
        fresh = Wt.to_numpy(Wt.fresh_stats(d.model, d.device))
        self.state = steps.load_train_state(modules, {
            "step": 0, "params": Wt.to_numpy(d.params),
            "batch_stats": fresh, "ema_params": Wt.to_numpy(d.teacher),
            "ema_batch_stats": fresh})
        self._step = steps.make_train_step(modules)

    def step(self, batch):
        return self._step(self.state, batch, self.d.step_seed,
                          self.d.mix["epoch"])

    @staticmethod
    def loss(metrics) -> float:
        return float(metrics["loss"])

    def _export(self):
        from bsed_tpu_torch.utils.weights import export_train_state
        return export_train_state(self.state)

    def first_gradient(self):
        mu = self._export()["mu"]
        return {k: np.asarray(v) / 0.1 for k, v in _tree_leaves(mu)}

    def state_trees(self):
        out = self._export()
        return {key: {k: np.asarray(v) for k, v in _tree_leaves(out[src])}
                for key, src in STATE_TREES}


class _ReferenceTrainer:
    """The control: the reference step at a lower precision in the
    program's place, on the loader's batches."""

    def __init__(self, d: Runner, control):
        from portbench.reference import train_step as RT
        self.d, self.control = d, control
        fresh = Wt.fresh_stats(d.model, d.device)
        self.state = RT.RefState(d.params, d.teacher, fresh, fresh)
        self.grads = None

    def step(self, batch):
        from portbench.harness.device import tf32
        from portbench.reference import train_step as RT
        b = dict(batch, epoch=float(self.d.mix["epoch"]))
        with tf32(self.control.tf32):
            terms, g = RT.train_step(self.state, b, self.d.step_seed,
                                     self.d.model, self.d.recipe,
                                     self.d.fused, self.control.q)
        if self.grads is None:
            self.grads = g
        return terms

    @staticmethod
    def loss(metrics) -> float:
        return float(metrics["loss"])

    def first_gradient(self):
        return {k: v.cpu().numpy().copy() for k, v in self.grads.items()}

    def state_trees(self):
        from portbench.reference import train_step as RT
        trees = {"params": self.state.params, "teacher": self.state.teacher,
                 "stats": self.state.stats,
                 "teacher_stats": self.state.teacher_stats}
        return {key: {k: v.detach().cpu().numpy().copy()
                      for k, v in RT._leaves(trees[key])}
                for key, _ in STATE_TREES}


# --- faults planted under the timed path (the check's tests and readings)

def state_unchanged(step):
    """The step computes its loss but leaves the state (the model, the
    teacher and the optimizer) as it was."""
    import copy
    trainer = step.__self__

    def f(batch):
        saved = [(m, copy.deepcopy(m.state_dict())) for m in
                 (trainer.state.model, trainer.state.ema_model,
                  trainer.state.optimizer)]
        metrics = step(batch)
        for m, sd in saved:
            m.load_state_dict(sd)
        return metrics
    return f


def train_half_left_out(step):
    """Half of every stream's rows dropped; the losses are the means over
    the rest."""
    def f(batch):
        return step({k: v[:len(v) // 2] for k, v in batch.items()})
    return f


def loss_altered(step):
    """The reported loss 5% off."""
    def f(batch):
        metrics = dict(step(batch))
        metrics["loss"] = metrics["loss"] * 1.05
        return metrics
    return f


def ema_unchanged(step):
    """The teacher never moves: its parameters and running statistics are
    put back after every step."""
    import copy
    trainer = step.__self__

    def f(batch):
        saved = copy.deepcopy(trainer.state.ema_model.state_dict())
        metrics = step(batch)
        trainer.state.ema_model.load_state_dict(saved)
        return metrics
    return f


def stats_unchanged(step):
    """The student's BatchNorm running statistics are never updated: its
    buffers are put back after every step."""
    import torch
    trainer = step.__self__

    def f(batch):
        saved = [(b, b.detach().clone())
                 for b in trainer.state.model.buffers()]
        metrics = step(batch)
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)
        return metrics
    return f


FAULTS = (state_unchanged, train_half_left_out, loss_altered,
          ema_unchanged, stats_unchanged)
