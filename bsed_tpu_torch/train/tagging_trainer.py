"""Weak audio-tagging trainer and pseudo-label writer. Port of
``bsed_tpu/train/tagging_trainer.py`` (the reference's
audio_tagging_system_cnn.py trainer and the pseudo-label writers of
audio_tagging_inference.py:288-313 and audio_tagging.py:256-283).

``TaggingTrainer`` trains a ResNet-18 or VGG tagger (``models/resnet``) on
weak targets: BCE on the SYN batch and on the labeled half of the real
batch, Adam with optax's defaults. With ``mean_teacher`` an EMA twin of
the parameters *and* of the BatchNorm statistics (the reference EMAs the
state dict) sees the real batch under SNR noise, in training mode (batch
statistics, its running statistics updated, no gradient), and an MSE
consistency term ties the student's real predictions to it.

One step, in ``bsed_tpu``'s order (``_train_step``, :69-120): the
teacher's forward; the student's forward on SYN, then on real, the
running statistics updated by both; the loss; Adam; the EMA at step + 1.
``bsed_tpu`` splits the step's key into ``k_noise`` (the noise and the
teacher's dropout) and ``k_drop`` (both student forwards): here the
noise and the teacher's mask come from the step's generator, and the two
student forwards restart it from the same state, so VGG draws one keep
mask for both when their shapes are equal, as one key does in JAX.
``train_step`` takes ``draws`` to replace the noise and the masks (tests
feed JAX's draws through it).

``save`` / ``load`` write ``{"params", "batch_stats"}`` in the flax
layout as CPU tensors through ``torch.save`` (read back with
``weights_only=True``), as ``utils/checkpoint.py`` stores train states.
``write_pseudo_labels`` writes ``filename<TAB>event_labels`` with
``csv`` ("\\n" line ends, as pandas' ``to_csv`` writes them).
"""
from __future__ import annotations

import copy
import csv
import os
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from bsed_tpu_torch.data.codec import ManyHotEncoder
from bsed_tpu_torch.eval.tagging import TaggingF1Accumulator
from bsed_tpu_torch.models.resnet import build_tagger
from bsed_tpu_torch.ops.augment import gaussian_snr_noise
from bsed_tpu_torch.ops.mel import amplitude_to_db
from bsed_tpu_torch.train.ema import ema_update
from bsed_tpu_torch.train.losses import bce
from bsed_tpu_torch.train.state import make_optimizer
from bsed_tpu_torch.utils import weights
from bsed_tpu_torch.utils.checkpoint import _to_numpy, _to_tensors
from bsed_tpu_torch.utils.device import resolve_device
from bsed_tpu_torch.utils.logger import create_logger

__all__ = ["build_tagger", "TaggingTrainer", "write_pseudo_labels"]


class TaggingTrainer:
    """``bsed_tpu``'s TaggingTrainer with ``device``: the tagger, its
    teacher and the batches live there (the card unless asked)."""

    def __init__(self, cfg, arch: str = "resnet",
                 learning_rate: float = 1e-3, mean_teacher: bool = False,
                 device="cuda"):
        self.cfg = cfg
        self.mean_teacher = mean_teacher
        self.device = resolve_device(device)
        self.log = create_logger(f"bsed_tpu_torch/tagger-{arch}")
        self.model = build_tagger(cfg, arch)
        gen = torch.Generator().manual_seed(cfg.train.seed)
        weights.load_named(self.model,
                           *weights.init_tagger(cfg, arch, gen))
        self.model.to(self.device)
        self.ema_model = (copy.deepcopy(self.model).train()
                          .requires_grad_(False) if mean_teacher else None)
        self.optimizer = make_optimizer(cfg, self.model.parameters(),
                                        "adam", lr=learning_rate)
        self.step_count = 0

    # ------------------------------------------------------------------
    def _db(self, mel) -> torch.Tensor:
        return amplitude_to_db(torch.as_tensor(mel, device=self.device))

    def train_step(self, batch: Mapping[str, torch.Tensor],
                   gen: torch.Generator,
                   draws: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> torch.Tensor:
        """One step on ``batch`` (``syn``, ``syn_weak`` and, with the real
        stream, ``real``, ``real_weak``; tensors on the device); returns
        the loss (a device scalar). ``draws`` may hold ``noise`` (the
        standard normal of the teacher's noise), ``keep`` (the student's
        dropout mask) and ``teacher_keep``."""
        draws = draws or {}
        model = self.model.train()
        teacher_pred = None
        if self.ema_model is not None:
            noisy = gaussian_snr_noise(gen, batch["real"],
                                       self.cfg.audio.noise_snr,
                                       normal=draws.get("noise"))
            with torch.no_grad():
                teacher_pred = self.ema_model(amplitude_to_db(noisy), gen,
                                              draws.get("teacher_keep"))
        drop_state = gen.get_state()
        pred_syn = model(amplitude_to_db(batch["syn"]), gen,
                         draws.get("keep"))
        loss = bce(pred_syn, batch["syn_weak"])
        if "real" in batch:
            gen.set_state(drop_state)
            pred_real = model(amplitude_to_db(batch["real"]), gen,
                              draws.get("keep"))
            half = pred_real.shape[0] // 2
            # real weak BCE on the labeled half (cnn trainer :367)
            loss = loss + bce(pred_real[:half], batch["real_weak"][:half])
            if teacher_pred is not None:
                loss = loss + torch.mean(torch.square(pred_real
                                                      - teacher_pred))
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        if self.ema_model is not None:
            step, alpha = self.step_count + 1, self.cfg.train.ema_alpha
            ema_update(self.ema_model.parameters(), model.parameters(),
                       step, alpha)
            ema_update(self.ema_model.buffers(), model.buffers(), step,
                       alpha)
        self.step_count += 1
        return loss.detach()

    def _batch(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        as_t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        strong = as_t(batch["syn_strong"])
        b = {"syn": as_t(batch["syn"]),
             "syn_weak": strong.amax(dim=1) if strong.ndim == 3 else strong}
        if "real" in batch:
            b["real"] = as_t(batch["real"])
            b["real_weak"] = as_t(batch["real_weak"])
        return b

    def train_epoch(self, batches: Iterable[Mapping], epoch: int) -> float:
        """One pass over ``batches``, drawing from one generator per
        (seed, epoch); returns the mean loss."""
        gen = torch.Generator(device=self.device).manual_seed(
            self.cfg.train.seed * 7919 + epoch)
        losses = [self.train_step(self._batch(b), gen) for b in batches]
        loss = float(torch.stack(losses).double().mean())
        self.log.info("tagger epoch %d: loss %.4f", epoch, loss)
        return loss

    @torch.no_grad()
    def _infer(self, mel) -> torch.Tensor:
        return self.model.eval()(self._db(mel))

    def evaluate(self, loader) -> float:
        """Macro tagging F1 over ``loader``'s (mel, target, names,
        n_valid) batches; strong targets are reduced by a max over
        time."""
        acc = TaggingF1Accumulator(self.cfg.nclass)
        for mel, target, names, n_valid in loader:
            pred = self._infer(mel)[:n_valid]
            target = torch.as_tensor(target)[:n_valid]
            acc.update(pred, target.amax(dim=1) if target.ndim == 3
                       else target)
        return acc.macro_f1()

    def predict_weak(self, mel) -> np.ndarray:
        return self._infer(mel).cpu().numpy()

    # -- persistence (the pseudo-labeling cycle runs as separate CLI
    #    commands) ---------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        params, stats = weights.export_named(self.model)
        torch.save(_to_tensors({"params": params, "batch_stats": stats}),
                   path)

    def load(self, path: str) -> None:
        trees = _to_numpy(torch.load(path, map_location="cpu",
                                     weights_only=True))
        weights.load_named(self.model, trees["params"],
                           trees["batch_stats"])

    def load_pretrained_torch(self, path_or_state) -> List[str]:
        """Initialize the ResNet tagger from a torchvision-style resnet18
        state_dict (a path or a mapping; a ``"state_dict"`` entry is
        unwrapped) through ``utils/torch_compat.convert_resnet18_tagger``.
        Shape-mismatched entries (the 3-channel ImageNet stem conv, the
        1000-class fc: what the reference re-initializes) keep their fresh
        init. Returns the skipped entries."""
        from bsed_tpu_torch.utils import torch_compat as tc

        state = path_or_state
        if isinstance(state, (str, os.PathLike)):
            # a torchvision state_dict is a plain tensor mapping
            state = torch.load(state, map_location="cpu", weights_only=True)
        if isinstance(state, Mapping) and "state_dict" in state:
            state = state["state_dict"]
        params, stats, skipped = tc.convert_resnet18_tagger(
            state, *weights.export_named(self.model))
        weights.load_named(self.model, params, stats)
        if skipped:
            self.log.info("pretrained init: kept fresh init for %s",
                          ", ".join(skipped))
        return skipped


def write_pseudo_labels(predict_weak: Callable[[np.ndarray], np.ndarray],
                        dataset, out_tsv: str, encoder: ManyHotEncoder,
                        threshold: float = 0.5, batch_size: int = 24
                        ) -> List[Tuple[str, str]]:
    """Run a weak predictor over an unlabeled dataset and write the
    pseudo-label TSV (audio_tagging_inference.py:288-313 format); returns
    the (filename, comma-joined labels) rows."""
    rows = []
    n = len(dataset)
    for start in range(0, n, batch_size):
        ids = range(start, min(start + batch_size, n))
        items = [dataset[i] for i in ids]
        weak = predict_weak(np.stack([it[0] for it in items]))
        for j, i in enumerate(ids):
            labels = encoder.decode_weak((weak[j] > threshold).astype(int))
            name = dataset.filename(i) if hasattr(dataset, "filename") \
                else str(items[j][2])
            rows.append((name, ",".join(labels)))
    os.makedirs(os.path.dirname(os.path.abspath(out_tsv)), exist_ok=True)
    with open(out_tsv, "w", newline="") as fh:
        writer = csv.writer(fh, delimiter="\t", lineterminator="\n")
        writer.writerow(["filename", "event_labels"])
        writer.writerows(rows)
    return rows
