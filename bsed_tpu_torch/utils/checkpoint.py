"""Checkpointing of the full train state + run metadata.

Port of ``bsed_tpu/utils/checkpoint.py`` (orbax there, ``torch.save``
here), in the same directory layout:

    <store_dir>/model/epoch_<e>/state.pt   — full train state
    <store_dir>/model/best/state.pt        — best-on-validation copy
    <store_dir>/model/meta.json            — codec/config metadata

A state file holds the train state as ``utils/weights.export_train_state``
gives it (step; student and teacher params and BatchNorm statistics; Adam
``mu``, ``nu`` and ``count`` or SGD's ``trace``; in the adaptation stage
the discriminator's params and statistics and the two aux optimizers'
states), in the flax layout, as CPU tensors, so
``torch.load(weights_only=True)`` reads it and ``bsed_tpu``'s trees and
this package's line up leaf by leaf. The file is written under a
temporary name and moved into place, so a crash never leaves a truncated
checkpoint behind.

Every-epoch saving and resume are handled by the trainer.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from bsed_tpu_torch.utils import weights

STATE_FILE = "state.pt"


def _to_tensors(tree):
    if isinstance(tree, Mapping):
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    return tree


def _to_numpy(tree):
    if isinstance(tree, Mapping):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return tree


class CheckpointManager:
    def __init__(self, store_dir: str):
        self.store_dir = os.path.abspath(store_dir)
        self.model_dir = os.path.join(self.store_dir, "model")
        os.makedirs(self.model_dir, exist_ok=True)

    # -- metadata ----------------------------------------------------------
    def save_meta(self, meta: Dict[str, Any]) -> None:
        with open(os.path.join(self.model_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, default=_json_default)

    def load_meta(self) -> Dict[str, Any]:
        with open(os.path.join(self.model_dir, "meta.json")) as f:
            return json.load(f)

    # -- state -------------------------------------------------------------
    def _path(self, tag) -> str:
        return os.path.join(self.model_dir, str(tag))

    def state_file(self, tag) -> str:
        return os.path.join(self._path(tag), STATE_FILE)

    def save(self, tag, state) -> None:
        """Write ``state`` (a ``train.state.TrainState``) under ``tag``,
        replacing what the tag held."""
        trees = _to_tensors(weights.export_train_state(state))
        os.makedirs(self._path(tag), exist_ok=True)
        path = self.state_file(tag)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(trees, tmp)
        os.replace(tmp, path)

    def load(self, tag) -> Dict[str, Any]:
        """The trees of ``tag`` as numpy arrays (``export_train_state``'s
        layout), without building a model: evaluation takes the student's
        ``params`` and ``batch_stats`` from them."""
        path = self.state_file(tag)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint {tag!r} in "
                                    f"{self.model_dir}")
        return _to_numpy(torch.load(path, map_location="cpu",
                                    weights_only=True))

    def restore(self, tag, state):
        """Load ``tag`` into the live ``state`` in place (its modules' and
        optimizer's devices) and return it."""
        weights.load_train_state(state, self.load(tag))
        return state

    def has(self, tag) -> bool:
        return os.path.isfile(self.state_file(tag))

    def latest_epoch(self) -> Optional[int]:
        epochs = []
        for name in os.listdir(self.model_dir):
            if name.startswith("epoch_") and self.has(name):
                try:
                    epochs.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
        return max(epochs) if epochs else None


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, tuple):
        return list(o)
    raise TypeError(f"not JSON serializable: {type(o)}")
