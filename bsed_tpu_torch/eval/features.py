"""Encoder-embedding dumper.

Port of ``bsed_tpu/eval/features.py``. Reference: src/save_features.py:
235-283 (and save_features_test.py) — runs the eval forward with a
``saved_feature_dir`` and dumps the (B, 313, 256) encoder outputs per
batch as npy, consumed by the t-SNE / SVM domain probes (visualize.py).
"""
from __future__ import annotations

import os
from typing import Callable, List

import numpy as np
import torch


def dump_features(encode_fn: Callable, loader, out_dir: str) -> List[str]:
    """encode_fn: linear mel batch → (B, T', D) embeddings (a tensor on
    any device, or an array); one npy per batch, named by batch index like
    the reference (:175)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, (mel, _target, _names, n_valid) in enumerate(loader):
        emb = encode_fn(mel)[:n_valid]
        if isinstance(emb, torch.Tensor):
            emb = emb.float().cpu().numpy()
        path = os.path.join(out_dir, f"{i}.npy")
        np.save(path, np.asarray(emb))
        paths.append(path)
    return paths


def make_encode_fn(modules, params, batch_stats) -> Callable:
    """``encode(mel) -> (B, T', 256)``: the d_input features of the CRNN
    encoder for linear mel (B, T, F) (a tensor on any device or a numpy
    array), as a float32 tensor on ``modules.device``, eval mode, under
    ``torch.inference_mode()``. The encoder is ``serve.build_encoder``'s,
    the one ``train.steps.make_predict_fn`` serves (on the card: the
    folded stem with K2's eval form and the hoisted BiGRU on K4; their
    plain versions under ``modules.use_kernels=False``)."""
    from bsed_tpu_torch.ops.mel import amplitude_to_db
    from bsed_tpu_torch.serve import build_encoder

    dev = modules.device
    encoder = build_encoder(modules.cfg, params["encoder"],
                            batch_stats["encoder"], dev,
                            use_kernels=modules.use_kernels)

    @torch.inference_mode()
    def encode(mel):
        mel = torch.as_tensor(mel, device=dev).float()
        return encoder(amplitude_to_db(mel)[..., None])

    return encode


def load_feature_dir(feature_dir: str) -> np.ndarray:
    """Concatenate all per-batch dumps (visualize.py loads these)."""
    files = sorted((f for f in os.listdir(feature_dir)
                    if f.endswith(".npy")),
                   key=lambda s: int(os.path.splitext(s)[0]))
    return np.concatenate([np.load(os.path.join(feature_dir, f))
                           for f in files], axis=0)
