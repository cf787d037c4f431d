"""Host-side overlap for evaluation: decode-ahead and asynchronous PNG writes
(the port's copy of ``swem_tpu/utils/host_io.py``).

* :func:`prefetch` decodes up to ``depth`` videos ahead on a background
  thread, so video N+1 decodes while video N runs on the device.
* :class:`AsyncWriter` runs the palette-PNG saves on writer threads, so
  video N's masks encode while video N+1 runs (PNG I/O stays outside the
  frames/s span either way).

Exceptions propagate: at the blocking ``__next__`` for prefetch, at
:meth:`AsyncWriter.flush` for writes. Bounded queues cap host RAM.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

K = TypeVar("K")
V = TypeVar("V")


def prefetch(fetch: Callable[[K], V], keys: Iterable[K], depth: int = 2) -> Iterator[V]:
    """Yield ``fetch(k)`` for each key in order, fetching up to ``depth``
    ahead on one background thread (host RAM: ``depth + 1`` items)."""
    keys = list(keys)
    if not keys:
        return
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix="swem-prefetch") as ex:
        pending: deque = deque()
        it = iter(keys)
        for _ in range(min(depth, len(keys))):
            pending.append(ex.submit(fetch, next(it)))
        for k in it:
            out = pending.popleft().result()
            pending.append(ex.submit(fetch, k))
            yield out
        while pending:
            yield pending.popleft().result()


class AsyncWriter:
    """Background writer pool: ``submit(fn, *args)`` blocks only when
    ``max_pending`` writes are in flight; ``flush()`` waits for all and
    re-raises the first failure. A context manager that flushes on exit."""

    def __init__(self, workers: int = 2, max_pending: int = 256):
        self._ex = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="swem-write")
        self._pending: deque = deque()
        self._max_pending = max_pending

    def submit(self, fn: Callable, *args) -> None:
        while len(self._pending) >= self._max_pending:
            self._pending.popleft().result()
        self._pending.append(self._ex.submit(fn, *args))

    def flush(self) -> None:
        while self._pending:
            self._pending.popleft().result()

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._ex.shutdown()

    def __enter__(self) -> "AsyncWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
