"""Entry points of the port for a quick check of a host: the analogue of
``bsed_tpu``'s ``__graft_entry__.py``.

``entry()``             — the serving forward of the flagship model
                          (``baseline``, bf16 conv stack, precision
                          'high': K1, K2 and K4 on the card) with example
                          audio;
``dryrun_multichip(n)`` — over ``n`` spawned ranks
                          (``parallel.launch.spawn``): one full
                          ``baseline_mt_isp`` step on a sharded global
                          batch, one joint-backward DA step
                          (``sct_ada_weak``, adaptation stage) and one
                          ``Trainer`` epoch with ``mesh='auto'``, each
                          checked finite and the same on every rank.

    python -c "from bsed_tpu_torch import entry; entry.dryrun_multichip(2)"
"""
from __future__ import annotations

import dataclasses
import math
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch


def entry(device="cuda"):
    """``(forward, (audio,))``: raw audio (2, n_samples) → (strong
    (2, 313, 20), weak (2, 20)) on ``device``, random weights from seed
    0."""
    from bsed_tpu_torch.config import get_config
    from bsed_tpu_torch.serve import make_fast_forward
    from bsed_tpu_torch.utils.weights import init_params

    cfg = get_config("baseline")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="bfloat16"))
    params, stats = init_params(cfg, 0)
    forward = make_fast_forward(cfg, params, stats, device=device,
                                precision="high")
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, cfg.audio.n_samples)).astype(np.float32))
    return forward, (audio,)


def _dryrun_cfg(preset: str, batch_size: int, stage: str = "pretrain"):
    from bsed_tpu_torch.config import AudioConfig, get_config

    cfg = get_config(preset).replace(
        audio=AudioConfig(sr=3200, hop_size=160, max_len_seconds=2.0))
    return cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size=batch_size, stage=stage))


def _global_batch(cfg, b: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    t_in, f, tf, c = (cfg.audio.max_frames, cfg.audio.n_mels, cfg.n_frames,
                      cfg.nclass)
    return {k: torch.from_numpy(v) for k, v in {
        "syn": np.abs(rng.standard_normal((b, t_in, f))).astype(np.float32),
        "syn_strong": (rng.random((b, tf, c)) > 0.9).astype(np.float32),
        "real": np.abs(rng.standard_normal((b, t_in, f))).astype(np.float32),
        "real_weak": (rng.random((b, c)) > 0.8).astype(np.float32)}.items()}


def _dryrun_worker(group, per_rank: int, store: str):
    """One rank of ``dryrun_multichip``: the losses of its three runs
    (the trainer's store is ``store``, shared by the ranks)."""
    from bsed_tpu_torch.data.datasets import SyntheticDataSource
    from bsed_tpu_torch.data.pipeline import ThreeStreamLoader
    from bsed_tpu_torch.parallel.mesh import shard_batch
    from bsed_tpu_torch.train import steps
    from bsed_tpu_torch.train.trainer import Trainer

    b = per_rank * group.size
    out = {}
    for name, preset, stage in (("mt_isp", "baseline_mt_isp", "pretrain"),
                                ("joint_da", "sct_ada_weak", "adaptation")):
        cfg = _dryrun_cfg(preset, b, stage)
        modules = steps.build_modules(cfg, device=group.device, group=group)
        state = steps.create_train_state(cfg, modules, 0)
        batch = shard_batch(group, {k: v.to(group.device) for k, v in
                                    _global_batch(cfg, b).items()})
        metrics = steps.make_train_step(modules, steps_per_epoch=2)(
            state, batch, 1, 0.0)
        assert state.step == 1
        if stage == "adaptation":
            assert "domain_loss" in metrics, sorted(metrics)
        out[name] = float(metrics["loss"])

    # the Trainer reads a loader strided over the ranks, as the CLI's
    cfg = _dryrun_cfg("baseline_mt_isp", per_rank)
    loader = ThreeStreamLoader(SyntheticDataSource(cfg, n_items=2 * b, seed=1),
                               SyntheticDataSource(cfg, n_items=b, seed=2),
                               SyntheticDataSource(cfg, n_items=b, seed=3),
                               batch_size=per_rank, process_index=group.rank,
                               process_count=group.size, device=group.device)
    trainer = Trainer(cfg, loader, store_dir=store, mesh="auto",
                      device=group.device)
    assert trainer.group is not None and \
        trainer.group.size == group.size, trainer.group
    out["trainer"] = float(trainer.fit(n_epochs=1)["loss"])
    assert trainer.ckpt.has("epoch_0"), "rank 0 wrote no checkpoint"
    return out


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None,
                     timeout: float = 600.0) -> dict:
    """Run the dryrun over ``n_devices`` spawned ranks on ``devices``
    (default: ``cuda:0`` … over NCCL when the host has that many cards,
    else the CPU over gloo; a listed card used twice runs over gloo).
    Raises unless every loss is finite and the ranks agree; returns rank
    0's losses."""
    from bsed_tpu_torch.parallel.launch import spawn

    if devices is None:
        devices = ([f"cuda:{i}" for i in range(n_devices)]
                   if torch.cuda.device_count() >= n_devices
                   else ["cpu"] * n_devices)
    devices = [str(d) for d in devices]
    backend = ("nccl" if devices[0].startswith("cuda")
               and len(set(devices)) == len(devices) else "gloo")
    with tempfile.TemporaryDirectory() as store:
        ranks = spawn(_dryrun_worker, n_devices, backend=backend,
                      device=devices, args=(2, store), timeout=timeout)
    losses = ranks[0]
    assert all(math.isfinite(v) for v in losses.values()), losses
    assert all(r == losses for r in ranks), ranks
    print(f"dryrun_multichip({n_devices}) on {devices} over {backend}: "
          + ", ".join(f"{k} loss {v:.4f}" for k, v in losses.items()),
          flush=True)
    return losses
