"""Batch pipelines: the three-stream trainer feed and the eval loader.

The port's copy of ``bsed_tpu/data/pipeline.py``. It replaces the
reference's zip-of-three-DataLoaders with recycled iterators and silent
ragged-batch skips (reference src/main_baseline.py:194-226) with a
deterministic, static-shape batcher:

  * epoch length = number of full SYN batches (the stream whose length
    sets the reference's epoch),
  * the weak and unlabeled streams re-cycle modularly with per-epoch
    reshuffling — no partial batches, no skips,
  * per-host sharding for multi-process running: each process takes its
    ``process_index``-strided slice of every stream.

Batches are dicts of stacked arrays ready for the train step:
  syn (Bs,T,F) • syn_strong (Bs,Tf,C) • real (Br,T,F) — first half weak,
  second half unlabeled-PL • real_weak (Br,C).

Where the data lives is explicit: the loaders take ``device=`` and hold a
dataset's contiguous arrays as tensors on it ("resident") when
``device_resident`` says so, or, left None, when ``device`` is a CUDA
device and the features total less than 4 GiB (``bsed_tpu``'s rule, with
"CUDA" for "not the CPU backend"). Resident batches are gathered with
``index_select`` on the resident tensors and never pass through the host;
otherwise batches are numpy arrays gathered on the host.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from bsed_tpu_torch.utils.device import resolve_device

RESIDENT_LIMIT_BYTES = 4 * 1024 ** 3


def _cat(*parts):
    """Concatenate on whichever library owns the arrays: ``torch.cat``
    when any part is a tensor (numpy parts are copied to its device; a
    card tensor stays on the card), ``np.concatenate`` on numpy arrays."""
    tensors = [p for p in parts if isinstance(p, torch.Tensor)]
    if tensors:
        dev = tensors[0].device
        return torch.cat([torch.as_tensor(p, device=dev) for p in parts])
    return np.concatenate(parts)


def _device_ids(device: torch.device, *ids):
    """Index vectors as long tensors on ``device``, moved in one copy. On
    CUDA the copy is from pinned host memory and does not block: a copy
    from pageable memory waits for the card's queue to drain, and the host
    would lose its lead over the card once a batch."""
    flat = torch.from_numpy(np.concatenate(
        [np.asarray(i, np.int64).reshape(-1) for i in ids]))
    if device.type == "cuda":
        flat = flat.pin_memory().to(device, non_blocking=True)
    else:
        flat = flat.to(device)
    return torch.split(flat, [int(np.size(i)) for i in ids])


def device_index_matrices(device, idx: Dict[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """``epoch_arrays``' (n_steps, per_batch) index matrices as long
    tensors on ``device``, all moved in one copy (``_device_ids``)."""
    keys = list(idx)
    moved = _device_ids(torch.device(device), *[idx[k] for k in keys])
    return {k: m.reshape(np.shape(idx[k])) for k, m in zip(keys, moved)}


def _placed_ids(pairs):
    """The ids of each (arrays, ids) pair, as device tensors (one copy for
    all) where the pair's arrays are resident tensors and the ids are not
    there yet."""
    out = [ids for _, ids in pairs]
    resident = [k for k, (arr, ids) in enumerate(pairs)
                if isinstance(arr[0], torch.Tensor)
                and not isinstance(ids, torch.Tensor)]
    if resident:
        moved = _device_ids(pairs[resident[0]][0][0].device,
                            *[out[k] for k in resident])
        for k, ids in zip(resident, moved):
            out[k] = ids
    return out


def _take(a, ids):
    """Rows ``ids`` of ``a``: ``index_select`` on a tensor (ids already on
    its device, or moved there), fancy indexing on a numpy array."""
    if isinstance(a, torch.Tensor):
        if not isinstance(ids, torch.Tensor):
            ids = _device_ids(a.device, ids)[0]
        return a.index_select(0, ids)
    return a[ids]


def _max_frames(t):
    """Strong (N, T, C) targets reduced to weak (N, C) over frames."""
    return t.amax(dim=1) if isinstance(t, torch.Tensor) else t.max(axis=1)


def _real_stream_batch(wf, wt, uf, ut, wi, ui, wt_rank: int, ut_rank: int):
    """Gather + weak-reduce + concat for the two real streams (weak-labeled
    + unlabeled/pseudo-labeled): the shared body of ``_assemble_batch`` and
    ``_assemble_real``. The weak stream may carry strong (T, C) targets —
    they are max-reduced to weak here and passed through as
    ``real_strong`` when BOTH streams have them."""
    out = {"real": _cat(_take(wf, wi), _take(uf, ui))}
    w_weak = _take(wt, wi)
    u_weak = _take(ut, ui)
    w_red = _max_frames(w_weak) if wt_rank == 3 else w_weak
    u_red = _max_frames(u_weak) if ut_rank == 3 else u_weak
    out["real_weak"] = _cat(w_red, u_red)
    if wt_rank == 3 and ut_rank == 3:
        out["real_strong"] = _cat(w_weak, u_weak)
    return out


def gather_batch(arrays: Dict[str, Any], ids: Dict[str, Any]
                 ) -> Dict[str, Any]:
    """Assemble one training batch from resident dataset arrays by index
    (the pure-function core of ``_assemble_batch``). ``arrays`` holds the
    contiguous (features, targets) pairs per stream; ``ids`` the per-batch
    index vectors."""
    streams = ["syn"] + (["weak", "unlab"] if "weak_f" in arrays else [])
    placed = dict(zip(streams, _placed_ids(
        [((arrays[f"{k}_f"],), ids[k]) for k in streams])))
    out = {"syn": _take(arrays["syn_f"], placed["syn"]),
           "syn_strong": _take(arrays["syn_t"], placed["syn"])}
    if "weak_f" in arrays:
        out.update(_real_stream_batch(
            arrays["weak_f"], arrays["weak_t"],
            arrays["unlab_f"], arrays["unlab_t"],
            placed["weak"], placed["unlab"],
            arrays["weak_t"].ndim, arrays["unlab_t"].ndim))
    return out


def _resident(arrays, device: torch.device, flag: Optional[bool]) -> bool:
    """Whether a dataset's arrays are held on ``device`` as tensors."""
    if flag is not None:
        return flag
    return (device.type == "cuda"
            and sum(a.nbytes for a in arrays) < RESIDENT_LIMIT_BYTES)


def _is_host(arrays) -> bool:
    return isinstance(arrays[0], np.ndarray)


class ThreeStreamLoader:
    def __init__(self, syn_dataset, weak_dataset=None, unlabeled_dataset=None,
                 batch_size: int = 12, seed: int = 2023, shuffle: bool = True,
                 process_index: int = 0, process_count: int = 1,
                 device_resident: Optional[bool] = None,
                 layout: str = "default", device="cuda"):
        # layout="origin": the main.py lineage's COMBINED real batch —
        # ¼ weak + ½ unlabeled-PL + ¼ strong rows (the strong rows drawn
        # from the SYN dataset: in the reference's DESED-style combined
        # loader the strong-masked rows ARE the synthetic clips,
        # main.py:729-741) with a separate full-size syn stream whose
        # forward runs but whose predictions are unused (main.py:344-346).
        # The batch then carries real (B), real_weak (B, C) and
        # real_strong (B, Tf, C); weak-only target rows are broadcast over
        # frames (their strong targets are never read by the step's masked
        # losses). batch_size must be divisible by 4.
        if layout not in ("default", "origin"):
            raise ValueError(layout)
        if layout == "origin" and batch_size % 4:
            raise ValueError("layout='origin' needs batch_size % 4 == 0 "
                             "(¼ weak + ½ unlabeled + ¼ strong rows)")
        self.layout = layout
        self.syn = syn_dataset
        self.weak = weak_dataset
        self.unlab = unlabeled_dataset
        self.batch_size = batch_size
        self.half = batch_size // 2
        self.seed = seed
        self.shuffle = shuffle
        self.process_index = process_index
        self.process_count = process_count
        # resident datasets: the contiguous dataset arrays are copied to
        # the device once and batches are gathered there (see the module
        # docstring); None = auto
        self.device = resolve_device(device)
        self.device_resident = device_resident
        self._dev_arrays: Dict[int, tuple] = {}

    def __len__(self):
        return len(self._host_indices(len(self.syn))) // self.batch_size

    def _host_indices(self, n: int) -> np.ndarray:
        return np.arange(self.process_index, n, self.process_count)

    def _stream(self, dataset, per_batch: int, rng) -> Iterator[List[int]]:
        """Infinite re-cycling index stream in chunks of per_batch."""
        base = self._host_indices(len(dataset))
        while True:
            order = base[
                rng.permutation(len(base))] if self.shuffle else base
            for i in range(0, len(order) - per_batch + 1, per_batch):
                yield order[i:i + per_batch]

    def _arrays_of(self, dataset):
        """Contiguous (features, targets) arrays when the dataset supports
        the batch-gather fast path (one gather per batch instead of a
        per-item Python loop + np.stack), as tensors on the device when
        resident (see ``device_resident``)."""
        fn = getattr(dataset, "as_arrays", None)
        if fn is None:
            return None
        arrays = fn()
        if not _resident(arrays, self.device, self.device_resident):
            return arrays
        key = id(dataset)
        if key not in self._dev_arrays:
            self._dev_arrays[key] = tuple(
                torch.as_tensor(a).to(self.device) for a in arrays)
        return self._dev_arrays[key]

    def _assemble_real(self, weak_arr, unlab_arr, w_ids, u_ids):
        """Real-stream-only gather/reduce/concat — the path when the SYN
        dataset lacks ``as_arrays`` but the real streams have it."""
        w_ids, u_ids = _placed_ids([(weak_arr, w_ids), (unlab_arr, u_ids)])
        return _real_stream_batch(*weak_arr, *unlab_arr, w_ids, u_ids,
                                  weak_arr[1].ndim, unlab_arr[1].ndim)

    def _assemble_batch(self, syn_arr, weak_arr, unlab_arr, s_ids, w_ids,
                        u_ids):
        """The ENTIRE batch — syn gather + real-stream gather/reduce/concat
        — from the streams' contiguous arrays (on the device when
        resident, else on the host)."""
        has_real = weak_arr is not None and unlab_arr is not None
        if has_real:
            s_ids, w_ids, u_ids = _placed_ids(
                [(syn_arr, s_ids), (weak_arr, w_ids), (unlab_arr, u_ids)])
        else:
            s_ids, = _placed_ids([(syn_arr, s_ids)])
        out = {"syn": _take(syn_arr[0], s_ids),
               "syn_strong": _take(syn_arr[1], s_ids)}
        if has_real:
            out.update(self._assemble_real(weak_arr, unlab_arr, w_ids,
                                           u_ids))
        return out

    def _items(self, dataset, ids):
        """(features, targets) of ``ids``: gathered from the dataset's
        arrays (on the device when resident) or stacked item by item."""
        arr = self._arrays_of(dataset)
        if arr is not None:
            ids, = _placed_ids([(arr, ids)])
            return _take(arr[0], ids), _take(arr[1], ids)
        items = [dataset[i] for i in ids]
        return (np.stack([it[0] for it in items]),
                np.stack([it[1] for it in items]))

    def _epoch_origin(self, epoch_idx: int):
        """layout='origin' batches (see __init__); gathered where the
        streams' arrays live."""
        rng = np.random.default_rng(self.seed * 1_000_003 + epoch_idx)
        syn_idx = self._host_indices(len(self.syn))
        order = rng.permutation(len(syn_idx)) if self.shuffle \
            else np.arange(len(syn_idx))
        b4, b2 = self.batch_size // 4, self.batch_size // 2
        weak_stream = self._stream(self.weak, b4, rng)
        unlab_stream = self._stream(self.unlab, b2, rng)
        strong_stream = self._stream(self.syn, b4, rng)

        def as_strong(t, n_frames):
            # weak-only rows: broadcast over frames (unused by the masked
            # losses; keeps the batch a single static-shape tensor)
            if t.ndim != 2:
                return t
            shape = (t.shape[0], n_frames, t.shape[-1])
            if isinstance(t, torch.Tensor):
                return t[:, None, :].expand(shape)
            return np.broadcast_to(t[:, None, :], shape)

        def as_weak(t):
            return _max_frames(t) if t.ndim == 3 else t

        for b in range(len(self)):
            ids = syn_idx[order[b * self.batch_size:
                                (b + 1) * self.batch_size]]
            syn_f, syn_t = self._items(self.syn, ids)
            wf, wt = self._items(self.weak, next(weak_stream))
            uf, ut = self._items(self.unlab, next(unlab_stream))
            sf, st = self._items(self.syn, next(strong_stream))
            n_frames = st.shape[1]
            yield {
                "syn": syn_f, "syn_strong": syn_t,
                "real": _cat(wf, uf, sf),
                "real_weak": _cat(as_weak(wt), as_weak(ut), as_weak(st)),
                "real_strong": _cat(as_strong(wt, n_frames),
                                    as_strong(ut, n_frames), st),
            }

    def epoch_arrays(self, epoch_idx: int
                     ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
        """(arrays, idx) for a runner that gathers every step's batch
        itself (``gather_batch``), or None when any stream is not
        resident.

        ``arrays``: the streams' resident tensors; ``idx``: stacked
        per-batch index matrices (n_steps, per_batch) drawn with EXACTLY
        the rng consumption order of ``epoch()`` (syn permutation first,
        then interleaved weak/unlab stream pulls), so the two paths see
        identical sample schedules."""
        if self.layout == "origin":
            return None          # origin feeds through _epoch_origin
        syn_arr = self._arrays_of(self.syn)
        if syn_arr is None or _is_host(syn_arr):
            return None
        has_real = self.weak is not None and self.unlab is not None
        if (self.weak is not None) != (self.unlab is not None):
            return None
        weak_arr = unlab_arr = None
        if has_real:
            weak_arr = self._arrays_of(self.weak)
            unlab_arr = self._arrays_of(self.unlab)
            if (weak_arr is None or unlab_arr is None
                    or _is_host(weak_arr) or _is_host(unlab_arr)):
                return None

        rng = np.random.default_rng(self.seed * 1_000_003 + epoch_idx)
        syn_idx = self._host_indices(len(self.syn))
        order = rng.permutation(len(syn_idx)) if self.shuffle \
            else np.arange(len(syn_idx))
        n = len(self)
        ids_syn = np.stack([
            syn_idx[order[b * self.batch_size:(b + 1) * self.batch_size]]
            for b in range(n)])
        arrays = {"syn_f": syn_arr[0], "syn_t": syn_arr[1]}
        idx = {"syn": ids_syn}
        if has_real:
            weak_stream = self._stream(self.weak, self.half, rng)
            unlab_stream = self._stream(self.unlab, self.half, rng)
            ids_w, ids_u = [], []
            for _ in range(n):
                ids_w.append(next(weak_stream))
                ids_u.append(next(unlab_stream))
            arrays.update(weak_f=weak_arr[0], weak_t=weak_arr[1],
                          unlab_f=unlab_arr[0], unlab_t=unlab_arr[1])
            idx.update(weak=np.stack(ids_w), unlab=np.stack(ids_u))
        return arrays, idx

    def epoch(self, epoch_idx: int) -> Iterator[Dict[str, Any]]:
        if self.layout == "origin":
            yield from self._epoch_origin(epoch_idx)
            return
        rng = np.random.default_rng(self.seed * 1_000_003 + epoch_idx)
        syn_idx = self._host_indices(len(self.syn))
        order = rng.permutation(len(syn_idx)) if self.shuffle \
            else np.arange(len(syn_idx))
        weak_stream = (self._stream(self.weak, self.half, rng)
                       if self.weak is not None else None)
        unlab_stream = (self._stream(self.unlab, self.half, rng)
                        if self.unlab is not None else None)
        syn_arr = self._arrays_of(self.syn)
        weak_arr = self._arrays_of(self.weak) if self.weak is not None \
            else None
        unlab_arr = self._arrays_of(self.unlab) if self.unlab is not None \
            else None

        for b in range(len(self)):
            ids = syn_idx[order[b * self.batch_size:(b + 1) * self.batch_size]]
            # fully-arrayed fast path: the whole batch in one gather
            if syn_arr is not None and (
                    weak_stream is None or
                    (weak_arr is not None and unlab_arr is not None)):
                w_ids = u_ids = None
                if weak_stream is not None:
                    w_ids = np.asarray(next(weak_stream))
                    u_ids = np.asarray(next(unlab_stream))
                yield self._assemble_batch(syn_arr, weak_arr, unlab_arr,
                                           np.asarray(ids), w_ids, u_ids)
                continue
            if syn_arr is not None:
                batch = {"syn": _take(syn_arr[0], ids),
                         "syn_strong": _take(syn_arr[1], ids)}
            else:
                syn_items = [self.syn[i] for i in ids]
                batch = {
                    "syn": np.stack([it[0] for it in syn_items]),
                    "syn_strong": np.stack([it[1] for it in syn_items]),
                }
            if weak_stream is not None and unlab_stream is not None:
                w_ids = next(weak_stream)
                u_ids = next(unlab_stream)
                if weak_arr is not None and unlab_arr is not None:
                    # syn lacks as_arrays but the real streams have them
                    batch.update(self._assemble_real(
                        weak_arr, unlab_arr, np.asarray(w_ids),
                        np.asarray(u_ids)))
                    yield batch
                    continue
                weak_items = [self.weak[i] for i in w_ids]
                unlab_items = [self.unlab[i] for i in u_ids]
                batch["real"] = np.stack(
                    [it[0] for it in weak_items]
                    + [it[0] for it in unlab_items])
                # weak stream carries strong targets → reduce to weak
                weak_targets = [
                    it[1].max(axis=0) if it[1].ndim == 2 else it[1]
                    for it in weak_items]
                pl_targets = [
                    it[1].max(axis=0) if it[1].ndim == 2 else it[1]
                    for it in unlab_items]
                batch["real_weak"] = np.stack(weak_targets + pl_targets)
                # ENA-supervised variant needs real strong targets too
                if all(it[1].ndim == 2
                       for it in weak_items + unlab_items):
                    batch["real_strong"] = np.stack(
                        [it[1] for it in weak_items]
                        + [it[1] for it in unlab_items])
            yield batch


class EvalLoader:
    """Sequential batches of (mel, strong target, filenames, n_valid) with
    a padded final batch, so every batch has one shape.

    When the dataset exposes ``as_arrays`` the whole eval set is stacked
    once and, when resident (see the module docstring), its features are
    copied to the device once, so each batch is a slice of a device
    tensor instead of a per-item load + np.stack + per-batch copy. Targets
    stay numpy arrays on the host."""

    def __init__(self, dataset, batch_size: int = 12,
                 device_resident: Optional[bool] = None, device="cuda"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.device_resident = device_resident
        self._prepared = None

    def prepare(self):
        """Stack (and place) the dataset's arrays once: (features,
        targets, names), or None when the dataset has no ``as_arrays``.
        Iteration calls it; calling it first moves that cost out of the
        first batch."""
        if self._prepared is not None:
            return self._prepared
        fn = getattr(self.dataset, "as_arrays", None)
        if fn is None:
            return None
        feats, targets = fn()
        names = [self.dataset.filename(i)
                 if hasattr(self.dataset, "filename") else str(i)
                 for i in range(len(self.dataset))]
        pad = (-len(names)) % self.batch_size
        if pad:  # static shapes: repeat the last item into the tail batch
            feats = np.concatenate([feats, np.repeat(feats[-1:], pad, 0)])
            targets = np.concatenate(
                [targets, np.repeat(targets[-1:], pad, 0)])
        if _resident((feats,), self.device, self.device_resident):
            feats = torch.as_tensor(feats).to(self.device)
        self._prepared = (feats, targets, names)
        return self._prepared

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def groundtruth_events(self) -> Optional[Dict[str, list]]:
        """{filename: [(label, onset_s, offset_s)]} at the original second
        resolution when the dataset can provide it (the reference assembles
        eval GT from annotation text, evaluation_measures.py:226-248);
        None when only frame targets exist (caller falls back to decoding
        them, losing sub-frame precision). Cached: the data is
        immutable."""
        if not hasattr(self.dataset, "events"):
            return None
        if not hasattr(self, "_gt_events"):
            name = (self.dataset.filename
                    if hasattr(self.dataset, "filename") else str)
            self._gt_events = {name(i): list(self.dataset.events(i))
                               for i in range(len(self.dataset))}
        return self._gt_events

    def __iter__(self):
        n = len(self.dataset)
        prepared = self.prepare()
        if prepared is not None:
            feats, targets, names = prepared
            for start in range(0, n, self.batch_size):
                stop = start + self.batch_size
                n_valid = min(stop, n) - start
                batch_names = names[start:start + n_valid]
                yield (feats[start:stop], targets[start:stop], batch_names,
                       n_valid)
            return
        for start in range(0, n, self.batch_size):
            ids = list(range(start, min(start + self.batch_size, n)))
            items = [self.dataset[i] for i in ids]
            mel = np.stack([it[0] for it in items])
            target = np.stack([it[1] for it in items])
            names = [self.dataset.filename(i) if hasattr(
                self.dataset, "filename") else str(it[2])
                for i, it in zip(ids, items)]
            n_valid = len(ids)
            if n_valid < self.batch_size:          # pad to static shape
                pad = self.batch_size - n_valid
                mel = np.concatenate([mel, np.repeat(mel[-1:], pad, 0)])
                target = np.concatenate([target,
                                         np.repeat(target[-1:], pad, 0)])
            yield mel, target, names, n_valid
