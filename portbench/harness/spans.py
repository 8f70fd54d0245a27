"""Harness spans around the port's kernel entries, for the traced run.

``KernelSpans.wrap`` replaces a module attribute of the port (an op entry
the port looks up when it calls it) by a wrapper that runs the entry
inside a ``record_function`` span of the harness's own name and, while
``recording``, notes the work of the call as its shapes give it
(``work.py``). The trace reader takes the span's device time from the
operations launched inside it, so a roofline reads the same work
whatever kernel implements the entry. ``restore`` puts the entries back.

An entry's launch counter lives on the function object under its module
name (``fused_block_mel.launches``); the wrapper carries it, so the
entry's own ``+= 1`` keeps counting.
"""
from __future__ import annotations

import importlib
from collections import defaultdict
from typing import Callable, Dict, List

from portbench.harness import work as W


class KernelSpans:
    def __init__(self):
        self.calls: Dict[str, List[W.Work]] = defaultdict(list)
        self.recording = False
        self._saved = []

    def wrap(self, module: str, attr: str, span: str,
             work_of: Callable) -> None:
        """Wrap ``module.attr`` in the span ``span``; an entry already
        wrapped (two metrics reading one span) is left as it is."""
        import torch
        mod = importlib.import_module(module)
        for m, a, _, name in self._saved:
            if (m, a) == (mod, attr):
                if name != span:
                    raise ValueError(f"{module}.{attr} is wrapped in "
                                     f"{name}, not {span}")
                return
        entry = getattr(mod, attr)
        calls = self.calls

        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(span):
                out = entry(*args, **kwargs)
            if self.recording:
                calls[span].append(work_of(args, kwargs, out))
            return out

        if hasattr(entry, "launches"):
            wrapper.launches = entry.launches
        setattr(mod, attr, wrapper)
        self._saved.append((mod, attr, entry, span))

    def restore(self) -> None:
        for mod, attr, entry, _ in reversed(self._saved):
            if hasattr(getattr(mod, attr), "launches"):
                entry.launches = getattr(mod, attr).launches
            setattr(mod, attr, entry)
        self._saved.clear()


def _dt(t) -> str:
    return str(t.dtype).split(".")[-1]


def mel_work(live: int, nnz: int) -> Callable:
    """K1, ``fused_block_mel(audio, bases, n_window, hop, n_mels)``."""
    def work_of(args, kwargs, out):
        return W.k1_mel(tuple(args[0].shape), tuple(out.shape), args[2],
                        live, nnz)
    return work_of


def stem_fwd_work(args, kwargs, out):
    """K2, ``stem_epilogue_fwd(h, inv, c, w, b, act, pt, pool_w, pool_c,
    bits=None, ...)``: the train form when bits are given."""
    h, w = args[0], args[3]
    bits = args[9] if len(args) > 9 else kwargs.get("bits")
    return W.k2_stem(tuple(h.shape), tuple(out.shape), tuple(w.shape),
                     _dt(h), bits is not None)


def stem_bwd_work(args, kwargs, out):
    """K3, ``stem_epilogue_bwd(gz, h, inv, c, w, b, ...)``."""
    gz, h, w = args[0], args[1], args[4]
    return W.k3_stem_bwd(tuple(gz.shape), tuple(h.shape), tuple(w.shape),
                         _dt(h))


def gru_work(args, kwargs, out):
    """K4, ``recurrence(xp2, (W_hhᵀ, b_hh))``."""
    xp2, (w_t2, b2) = args[0], args[1]
    return W.k4_gru(tuple(xp2.shape), tuple(out.shape), tuple(w_t2.shape),
                    tuple(b2.shape), _dt(xp2))
