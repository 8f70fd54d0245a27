"""Background-thread batch prefetching.

The port's copy of ``bsed_tpu/data/prefetch.py``. The reference configures
``cfg.num_workers = 12`` but never passes it to a DataLoader (its
src/data/config.py:69 vs main_baseline.py:737), so its host input pipeline
is synchronous. Here the trainer's host work (npy reads, stacking,
augmentation indexing) overlaps device compute: a daemon thread fills a
bounded queue ``depth`` batches ahead while the step consumes.

Exceptions raised by the producer (including KeyboardInterrupt-derived)
re-raise at the consumer's next ``__next__`` call; the thread is daemonic
and the queue bounded, so an abandoned iterator never leaks a busy thread
past the next two items.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(iterable: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Yield items of ``iterable``, produced ``depth`` ahead on a thread."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    failure = []

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # re-raised on the consumer side
            failure.append(e)
        finally:
            q.put(_SENTINEL)

    thread = threading.Thread(target=worker, daemon=True,
                              name="bsed-prefetch")
    thread.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if failure:
                raise failure[0]
            return
        yield item
