"""The data group and the sharding rule of data-parallel training and
serving. Port of ``bsed_tpu/parallel/mesh.py`` onto ``torch.distributed``.

``bsed_tpu`` runs SPMD over one global batch: every stream is sharded on
axis 0, parameters are replicated, and every reduction of the step (loss
means, BatchNorm batch statistics, metrics) is global, so GSPMD inserts
the cross-chip sums. Here each rank is a process with its own rows, and
the step makes those sums itself (``train/steps.py``): a ``DataGroup``
names the rank, the group's size, the rank's device and the process group,
and the functions below are the collectives the step needs. NCCL serves
one rank a card; gloo the CPU and ranks that share one card (NCCL refuses
two ranks on one GPU).

Serving needs no group: ``serve.make_sharded_forward`` runs one replica a
device in one process, and ``auto_data_mesh`` picks those devices.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """One rank's view of a data-parallel group: ``rank`` of ``size``,
    the rank's ``device``, and the process group (None: the default
    group). The rank's rows of a global batch of ``size · b`` rows are
    ``[rank · b, (rank + 1) · b)`` of every stream."""
    rank: int
    size: int
    device: torch.device
    pg: Any = None

    @classmethod
    def single(cls, device) -> "DataGroup":
        """A group of this process alone: every collective below is then
        the identity, so a step written for a group runs unchanged."""
        return cls(0, 1, torch.device(device))

    @property
    def process_group(self):
        return self.pg if self.pg is not None else dist.group.WORLD


def make_mesh(device=None) -> DataGroup:
    """The ``DataGroup`` of the initialised default process group on
    ``device`` (default: the current card, as ``torch.cuda.set_device``
    left it, else the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(init_from_env, or parallel.launch.spawn)")
    if device is None:
        device = (f"cuda:{torch.cuda.current_device()}"
                  if torch.cuda.is_available() else "cpu")
    return DataGroup(dist.get_rank(), dist.get_world_size(),
                     torch.device(device))


def init_from_env(device=None) -> Optional[DataGroup]:
    """Join the job that torchrun describes in ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK`` (and ``MASTER_ADDR`` / ``MASTER_PORT``): the rank's
    device is ``cuda:LOCAL_RANK`` over NCCL, or, with ``device='cpu'``,
    the CPU over gloo. Returns None outside such a job (no
    ``WORLD_SIZE``); a job of one rank is a group of one."""
    if "WORLD_SIZE" not in os.environ:
        return None
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device(device if device is not None else f"cuda:{local}")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device(f"cuda:{local}")
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    return make_mesh(dev)


def auto_data_mesh(*batch_sizes: int, devices: Optional[Sequence] = None,
                   process_count: int = 1) -> Optional[List]:
    """``bsed_tpu``'s rule: the largest number of ``devices`` that divides
    every batch stream times ``process_count`` (the loaders are
    process-strided, so the global batch is the per-process batch times
    the process count); the first that many devices, or None when only
    one would qualify. ``devices`` default to the visible CUDA devices
    (one process serving several cards)."""
    if devices is None:
        devices = [torch.device(f"cuda:{i}")
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    sizes = [b * process_count for b in batch_sizes if b > 0]
    n = len(devices)
    while n > 1 and any(b % n for b in sizes):
        n -= 1
    return devices[:n] if n > 1 else None


def auto_data_group(*batch_sizes: int, process_count: int = 1,
                    device=None) -> Optional[DataGroup]:
    """The group of the running job, on ``device`` (``make_mesh``), when
    it trains these streams data-parallel; None outside a job of more
    than one rank. A job cannot leave ranks idle, so where
    ``auto_data_mesh`` would use fewer ranks than the job has this raises,
    naming the stream sizes."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    world = dist.get_world_size()
    picked = auto_data_mesh(*batch_sizes, devices=range(world),
                            process_count=process_count)
    n = len(picked) if picked else 1
    if n != world:
        sizes = [b * process_count for b in batch_sizes if b > 0]
        raise ValueError(
            f"the global batch streams {sizes} divide over {n} of the job's "
            f"{world} ranks; torch.distributed cannot leave ranks idle: set "
            f"the batch size to a multiple of {world} or run {n} ranks")
    return make_mesh(device)


def host_local_batch(global_batch_size: int, group: DataGroup) -> slice:
    """This rank's slice of a global batch of ``global_batch_size`` rows."""
    per_rank = global_batch_size // group.size
    return slice(group.rank * per_rank, (group.rank + 1) * per_rank)


def shard_batch(group: DataGroup, batch: Dict) -> Dict:
    """This rank's rows of every stream of a global batch (None entries
    stay None). Every stream must divide by the group's size."""
    out = {}
    for k, v in batch.items():
        if v is None:
            out[k] = None
            continue
        if v.shape[0] % group.size:
            raise ValueError(f"stream {k!r} has {v.shape[0]} rows, which "
                             f"do not divide over {group.size} ranks")
        out[k] = v[host_local_batch(v.shape[0], group)]
    return out


def chunk_sizes(rows: int, size: int) -> List[int]:
    """``rows`` spread over ``size`` ranks as ``torch.tensor_split``
    spreads them: the first ``rows % size`` ranks one more. Raises when a
    rank would get none: every rank runs each forward of the step."""
    if rows < size:
        raise ValueError(f"{rows} rows cannot spread over {size} ranks "
                         f"with at least one row each")
    base, extra = divmod(rows, size)
    return [base + (r < extra) for r in range(size)]


def chunk_bounds(rows: int, group: DataGroup) -> slice:
    """This rank's rows of ``rows`` spread over the group
    (``chunk_sizes``)."""
    sizes = chunk_sizes(rows, group.size)
    lo = sum(sizes[:group.rank])
    return slice(lo, lo + sizes[group.rank])


def group_sum(x: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """The sum of ``x`` over the group, with its gradient: the backward
    sums the incoming gradients over the group as well, which is the
    gradient of every rank's loss through the global sum."""
    if group.size == 1:
        return x
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x, group=group.process_group)


@torch.no_grad()
def sum_(tensors: Sequence[torch.Tensor], group: DataGroup) -> None:
    """Sum each tensor over the group in place, in one flat float32
    buffer (the gradients' bucket, the metrics)."""
    tensors = list(tensors)
    if not tensors or group.size == 1:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group.process_group)
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


@torch.no_grad()
def gather_rows(x: torch.Tensor, group: DataGroup,
                sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Every rank's rows of ``x`` in rank order, on every rank, without a
    gradient. ``sizes``: the ranks' row counts (default: all equal to
    this rank's). Made of one sum over a zero-padded buffer, which is
    exact and runs on every backend, gloo on a card included."""
    if group.size == 1:
        return x
    if sizes is None:
        sizes = [x.shape[0]] * group.size
    lo = sum(sizes[:group.rank])
    out = x.new_zeros((sum(sizes),) + tuple(x.shape[1:]))
    out[lo:lo + x.shape[0]] = x
    dist.all_reduce(out, group=group.process_group)
    return out


@torch.no_grad()
def replicate(group: DataGroup, tensors: Iterable[torch.Tensor]) -> None:
    """Broadcast ``tensors`` from rank 0 in place, so every rank holds rank
    0's values (a fresh or restored train state). One flat buffer per
    dtype, on the group's device (an optimizer keeps its step counts on
    the host, which NCCL cannot send)."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1).to(group.device) for t in ts])
        dist.broadcast(flat, src=0, group=group.process_group)
        i = 0
        for t in ts:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()


def barrier(group: DataGroup) -> None:
    """Wait for every rank, after this rank's queued work on its card."""
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)
    dist.barrier(group=group.process_group)
