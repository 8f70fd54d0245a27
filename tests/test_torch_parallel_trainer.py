"""Data parallelism of the port on the CPU, beyond the one-step cases of
``tests/test_torch_parallel.py`` (whose helpers these use): a
``Trainer`` epoch on 2 gloo ranks against 1 rank, ``auto_data_mesh``'s
rule and the group's refusal, the strided loaders, ``make_sharded_forward``
on two CPU replicas, and ``parallel.launch.spawn``'s failure reports.
Imports no JAX."""
import os

import numpy as np
import pytest
import torch

from bsed_tpu_torch.config import AudioConfig, get_config
from bsed_tpu_torch.parallel import mesh
from bsed_tpu_torch.parallel.launch import spawn
from bsed_tpu_torch.utils import weights
from tests.test_torch_parallel import (BS, SPAWN_TIMEOUT, WORLD,  # noqa: F401
                                       one_torch_thread, small_cfg)

def build_trainer(store, group=None):
    """A ``baseline_mt_isp`` trainer (dropout 0.5) on 16 syn, 8 weak, 8
    unlabelled clips at a global batch of 8 (2 steps an epoch) and 8 val
    clips at batch 4 (2 val batches, sharded over 2 ranks). Under
    ``group`` (``mesh='auto'`` joins it) the rank reads its loader
    strided over the ranks, as the CLI builds it; without, one process
    reads the ranks' batches assembled in rank order."""
    import dataclasses

    from bsed_tpu_torch.data.datasets import SyntheticDataSource
    from bsed_tpu_torch.data.pipeline import (AssembledLoader, EvalLoader,
                                              ThreeStreamLoader)
    from bsed_tpu_torch.train.trainer import Trainer

    cfg = small_cfg("baseline_mt_isp", dropout=0.5)
    bs = BS // WORLD
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=bs))

    def strided(rank):
        return ThreeStreamLoader(
            SyntheticDataSource(cfg, n_items=16, seed=1),
            SyntheticDataSource(cfg, n_items=8, seed=2),
            SyntheticDataSource(cfg, n_items=8, seed=3), batch_size=bs,
            seed=7, process_index=rank, process_count=WORLD, device="cpu")
    loader = (strided(group.rank) if group is not None
              else AssembledLoader([strided(r) for r in range(WORLD)]))
    val = EvalLoader(SyntheticDataSource(cfg, n_items=8, seed=4),
                     batch_size=4, device="cpu")
    return Trainer(cfg, loader, val_loader=val, store_dir=str(store),
                   mesh="auto", device="cpu")


def _fit_worker(group, store):
    trainer = build_trainer(store, group)
    assert trainer.group is not None and trainer.group.size == group.size
    trainer.fit(n_epochs=1)
    saved = sorted(os.listdir(os.path.join(str(store), "model")))
    trainer.resume(1)
    return trainer.history, saved, trainer.state.step


def _unstrided_worker(group):
    """A rank given a loader that is not strided over the group."""
    from bsed_tpu_torch.data.datasets import SyntheticDataSource
    from bsed_tpu_torch.data.pipeline import ThreeStreamLoader
    from bsed_tpu_torch.train.trainer import Trainer

    cfg = small_cfg("baseline_mt_isp")
    loader = ThreeStreamLoader(SyntheticDataSource(cfg, n_items=16, seed=1),
                               batch_size=BS, device="cpu")
    try:
        Trainer(cfg, loader, mesh=group, device="cpu")
    except ValueError as e:
        return str(e)
    return None


def test_trainer_fit_on_two_ranks_equals_one_rank(tmp_path):
    """A Trainer.fit epoch with mesh='auto' in a 2-rank job (each rank
    reading its strided loader) against the 1-rank epoch on the assembled
    batches, row for row at rtol 1e-4 / atol 1e-6
    (tests/test_parallel.py:173-200); the checkpoints are written once,
    by rank 0, and resume on every rank; a rank given a loader that is
    not strided over the group is refused."""
    single = build_trainer(tmp_path / "single")
    assert single.group is None
    single.fit(n_epochs=1)
    ranks = spawn(_fit_worker, WORLD, args=(tmp_path / "mesh",),
                  timeout=SPAWN_TIMEOUT)
    for history, saved, step in ranks:
        assert len(history) == len(single.history) == 1
        for row, ref in zip(history, single.history):
            assert row.keys() == ref.keys()
            for k in ref:
                np.testing.assert_allclose(row[k], ref[k], rtol=1e-4,
                                           atol=1e-6, err_msg=k)
        assert saved == ["best", "epoch_0", "meta.json"]
        assert step == len(single.train_loader)
    assert ranks[0][0] == ranks[1][0]
    assert os.path.exists(tmp_path / "mesh" / "results.tsv")
    for msg in spawn(_unstrided_worker, WORLD, timeout=SPAWN_TIMEOUT):
        assert msg is not None and "strided" in msg, msg


def test_auto_data_mesh_divisibility():
    """bsed_tpu's rule (``tests/test_parallel.py::
    test_auto_data_mesh_divisibility``) over a list of 8 devices: the largest count dividing every stream
    times the process count, or None when only 1 fits."""
    devs = [f"cpu:{i}" for i in range(8)]
    assert len(mesh.auto_data_mesh(8, 8, devices=devs)) == 8
    assert len(mesh.auto_data_mesh(12, 12, devices=devs)) == 6
    assert len(mesh.auto_data_mesh(4, 4, devices=devs)) == 4
    assert mesh.auto_data_mesh(3, 2, devices=devs) is None
    assert mesh.auto_data_mesh(16, 16, devices=devs[:1]) is None
    # process-strided loaders: the global batch is 3 × 4 processes
    assert len(mesh.auto_data_mesh(3, 3, devices=devs,
                                   process_count=4)) == 6


def _refusal_worker(group):
    assert mesh.auto_data_group(8, 8) is not None
    try:
        mesh.auto_data_group(3, 2)
    except ValueError as e:
        return str(e)
    return None


def test_auto_data_group_refuses_to_leave_ranks_idle():
    """In a 2-rank job, streams of 3 and 2 clips divide over 1 rank only:
    the group refuses, naming the stream sizes."""
    for msg in spawn(_refusal_worker, WORLD, timeout=SPAWN_TIMEOUT):
        assert msg is not None and "[3, 2]" in msg and "idle" in msg, msg


def test_strided_loader_shards_cover_the_global_batch():
    """Each rank's strided loader gives batches of the same shapes; at
    every step the ranks' rows are disjoint and together hold the rows of
    the 1-process loader's epoch (tests/test_parallel.py's multi-host
    equivalence), and shard_batch takes a rank's rows of a global batch."""
    from bsed_tpu_torch.data.datasets import SyntheticDataSource
    from bsed_tpu_torch.data.pipeline import ThreeStreamLoader

    cfg = small_cfg("baseline")
    syn = SyntheticDataSource(cfg, n_items=16, seed=1)
    weak = SyntheticDataSource(cfg, n_items=8, seed=2)
    unlab = SyntheticDataSource(cfg, n_items=8, seed=3)

    def epoch(pi, pc, bs):
        return list(ThreeStreamLoader(
            syn, weak, unlab, batch_size=bs, seed=7, shuffle=False,
            process_index=pi, process_count=pc, device="cpu").epoch(0))

    ranks = [epoch(r, WORLD, BS // WORLD) for r in range(WORLD)]
    whole = epoch(0, 1, BS)
    assert len(ranks[0]) == len(ranks[1]) == len(whole) == 2

    def rows(a):
        return {np.asarray(r).tobytes() for r in a}
    for b0, b1, bg in zip(*ranks, whole):
        for k in ("syn", "real"):
            assert b0[k].shape == b1[k].shape == (BS // WORLD,) + \
                bg[k].shape[1:]
            assert not rows(b0[k]) & rows(b1[k])
            epoch_rows = rows(np.concatenate([b[k] for b in whole]))
            assert rows(b0[k]) | rows(b1[k]) <= epoch_rows
    got = [np.concatenate([b[k] for b in r]) for r in ranks
           for k in ("syn",)]
    assert rows(np.concatenate(got)) == rows(
        np.concatenate([b["syn"] for b in whole]))
    g = mesh.DataGroup(1, WORLD, torch.device("cpu"))
    part = mesh.shard_batch(g, whole[0])
    np.testing.assert_array_equal(part["syn"], whole[0]["syn"][BS // 2:])
    assert mesh.host_local_batch(24, g) == slice(12, 24)


def test_sharded_forward_matches_single_forward():
    """make_sharded_forward over ["cpu", "cpu"] (two replicas of one
    device) reproduces the single forward, atol 1e-6, and refuses a batch
    that does not divide over its replicas."""
    from bsed_tpu_torch.serve import make_fast_forward, make_sharded_forward

    cfg = get_config("baseline").replace(
        audio=AudioConfig(sr=3200, hop_size=160, max_len_seconds=2.0))
    params, stats = weights.init_params(cfg, 0)
    audio = np.random.default_rng(0).standard_normal(
        (8, cfg.audio.n_samples)).astype(np.float32) * 0.1
    ref = make_fast_forward(cfg, params, stats, device="cpu",
                            precision="highest")(audio)
    fwd = make_sharded_forward(cfg, params, stats, ["cpu", "cpu"],
                               precision="highest")
    for got, want in zip(fwd(audio), ref):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        fwd(audio[:3])


def _failing_worker(group):
    if group.rank == 1:
        raise RuntimeError("rank one fails")
    return group.rank


def _sleeping_worker(group):
    import time
    time.sleep(60)


def test_spawn_reports_a_failing_or_hung_rank():
    """A rank that raises makes spawn raise with its traceback; a rank
    that outlives the time limit makes it raise within seconds."""
    with pytest.raises(RuntimeError, match="rank one fails"):
        spawn(_failing_worker, WORLD, timeout=SPAWN_TIMEOUT)
    with pytest.raises(TimeoutError, match="outlived"):
        spawn(_sleeping_worker, WORLD, timeout=2.0)


def test_dryrun_multichip_and_entry():
    """``entry.dryrun_multichip(2)`` on the CPU (gloo): the sharded
    baseline_mt_isp step, the joint-DA step and a Trainer epoch, finite
    and equal on both ranks; ``entry()``'s forward gives (2, 313, 20) and
    (2, 20) finite posteriors."""
    from bsed_tpu_torch import entry

    losses = entry.dryrun_multichip(2, timeout=SPAWN_TIMEOUT)
    assert set(losses) == {"mt_isp", "joint_da", "trainer"}
    fn, args = entry.entry(device="cpu")
    strong, weak = fn(*args)
    assert strong.shape == (2, 313, 20) and weak.shape == (2, 20)
    assert torch.isfinite(strong).all() and torch.isfinite(weak).all()


def test_predict_over_two_replicas_equals_one_device(tmp_path):
    """``predict_recordings(devices=["cpu", "cpu"])`` (the CLI's
    data-parallel serving on a host with several cards) gives the events
    and posteriors of the single-device call: a 10 s recording at a 4 s
    window makes 3 windows, one batch short of 4, which the sharded path
    pads to 4 (two replicas of 2) and cuts back."""
    from bsed_tpu_torch.predict import predict_recordings

    cfg = get_config("baseline").replace(
        audio=AudioConfig(sr=3200, hop_size=160, max_len_seconds=4.0))
    params, stats = weights.init_params(cfg, 0)
    path = tmp_path / "rec.npy"
    np.save(path, np.random.default_rng(2).standard_normal(
        10 * 3200).astype(np.float32) * 0.1)
    kw = dict(device="cpu", precision="highest", batch_size=4,
              keep_posteriors=True, threshold=0.3)
    one = predict_recordings(cfg, params, stats, [str(path)], **kw)
    two = predict_recordings(cfg, params, stats, [str(path)],
                             devices=["cpu", "cpu"], **kw)
    assert one["batches"] == two["batches"] == [[3]]
    np.testing.assert_allclose(two["posteriors"][0], one["posteriors"][0],
                               atol=1e-6)
    assert two["rows"] == one["rows"]
