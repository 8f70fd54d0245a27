"""Spawn the ranks of a data-parallel group from one process.

``spawn(fn, world, backend, device)`` starts ``world`` processes with
``torch.multiprocessing``'s spawn method, joins them in one process group
through a ``file://`` rendezvous in a fresh temporary directory (so
parallel test workers never race for a port), calls ``fn(group, *args)``
in each, and returns the ranks' results in rank order. A worker that
raises, or that outlives ``timeout`` seconds, makes ``spawn`` raise with
the worker's traceback; the others are then stopped.

Each worker starts with the parent's TF32 settings, cuDNN's deterministic
switch and torch's thread count: a spawned process is fresh, and cuDNN's
TF32 is on by default there, so a rank would otherwise compute in another
precision than the process it is compared with.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence, Union

import torch


def _settings() -> dict:
    return {"matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "cudnn_deterministic": torch.backends.cudnn.deterministic,
            "threads": torch.get_num_threads()}


def _worker(rank: int, world: int, backend: str, device: str,
            init_method: str, timeout: float, settings: dict,
            fn: Callable, args: tuple, results) -> None:
    import torch.distributed as dist

    from bsed_tpu_torch.parallel.mesh import DataGroup

    try:
        torch.backends.cuda.matmul.allow_tf32 = settings["matmul_tf32"]
        torch.backends.cudnn.allow_tf32 = settings["cudnn_tf32"]
        torch.backends.cudnn.deterministic = settings["cudnn_deterministic"]
        torch.set_num_threads(settings["threads"])
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(DataGroup(rank, world, dev), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                    # reported to the parent
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world: int, backend: str = "gloo",
          device: Union[str, Sequence[str]] = "cpu", args: tuple = (),
          timeout: float = 300.0) -> List[Any]:
    """Run ``fn(group, *args)`` on ``world`` spawned ranks; ``fn`` must be
    importable (a module-level function) and its result picklable.
    ``device``: one device for every rank (gloo ranks sharing a card or
    the CPU) or one per rank. ``timeout``: seconds each rank may take, the
    process group's collectives included."""
    ctx = torch.multiprocessing.get_context("spawn")
    devices = ([device] * world if isinstance(device, str)
               else list(device))
    tmp = tempfile.mkdtemp(prefix="bsed_spawn_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(r, world, backend, devices[r], init, timeout,
                               _settings(), fn, args, results))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout + 5.0
        got, dead_polls = {}, 0
        while len(got) < world:
            left = deadline - time.monotonic()
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in got]
                # a result may still be in the pipe when its rank has
                # just exited: a rank counts as lost after two empty polls
                dead_polls = dead_polls + 1 if dead else 0
                if dead_polls >= 2 or left <= 0:
                    why = (f"rank(s) {dead} exited without a result"
                           if dead else f"ranks outlived {timeout} s")
                    raise TimeoutError(f"spawn({world}): {why}") from None
                continue
            if not ok:
                raise RuntimeError(f"spawn({world}): rank {rank} failed:\n"
                                   f"{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=30.0)
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
        shutil.rmtree(tmp, ignore_errors=True)
