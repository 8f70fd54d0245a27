"""The import guard: the benchmark measures the PyTorch port alone.

``install()`` puts a finder at the head of ``sys.meta_path`` that refuses
every module whose top-level name (the part before the first dot) is one
of ``BLOCKED``, compared whole: ``bsed_tpu_torch`` passes, ``bsed_tpu``
and ``bsed_tpu.ops`` do not. ``loaded()`` names the blocked top-level
packages present in ``sys.modules``; the harness calls it once the window
has closed and prints no result if any is there.
"""
from __future__ import annotations

import importlib.abc
import importlib.machinery
import sys
from typing import Iterable, List, Optional

# JAX and the JAX package are the reference of the port's CPU tests and
# never run in a benchmark process; the card's machine has no pandas
BLOCKED = ("jax", "jaxlib", "flax", "bsed_tpu", "pandas")
# what must not be loaded when a result is printed (pandas is kept out by
# the finder only because the card's machine lacks it)
FORBIDDEN_LOADED = ("jax", "jaxlib", "flax", "bsed_tpu")


def top_level(name: str) -> str:
    return name.partition(".")[0]


class BlockedImport(ImportError):
    pass


class _Refuse(importlib.abc.Loader):
    def create_module(self, spec):
        raise BlockedImport(f"the benchmark does not load {spec.name!r}")

    def exec_module(self, module):
        raise BlockedImport(f"the benchmark does not load "
                            f"{module.__name__!r}")


class _Blocker(importlib.abc.MetaPathFinder):
    """Finds every blocked module with a loader that refuses it. The spec
    has no origin, so code that only asks where a package lies (torch's
    dynamo lists third-party directories so) finds none, and an import
    raises ``BlockedImport``."""

    def __init__(self, blocked: Iterable[str]):
        self.blocked = frozenset(blocked)

    def find_spec(self, fullname, path=None, target=None):
        if top_level(fullname) in self.blocked:
            return importlib.machinery.ModuleSpec(fullname, _Refuse(),
                                                  origin=None)
        return None


def install(blocked: Iterable[str] = BLOCKED) -> None:
    """Refuse imports of ``blocked`` top-level names from now on."""
    if not any(isinstance(f, _Blocker) for f in sys.meta_path):
        sys.meta_path.insert(0, _Blocker(blocked))


def loaded(names: Optional[Iterable[str]] = None,
           forbidden: Iterable[str] = FORBIDDEN_LOADED) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the keys of
    ``sys.modules``), sorted."""
    names = sys.modules if names is None else names
    return sorted({top_level(n) for n in names} & set(forbidden))
