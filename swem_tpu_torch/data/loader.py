"""Training batch loader: multiprocess prefetching, iteration-based sampling
(the port's copy of ``swem_tpu/data/loader.py``, whose batches it gives
bit for bit).

Replaces the reference implementation's DataLoader + DistributedSampler +
IterationBasedBatchSampler (datasets/dataloader.py:12-36, samplers/*): an
infinite, deterministically-seeded stream of host numpy batches.
Epoch-shuffled indices, per-sample RNG derived from (seed, iteration,
position), and a process pool that keeps ``PREFETCH`` batches in flight
while the device runs the step. Under data parallelism each process reads
its shard of every global batch (``shard_id``/``num_shards``, the
DistributedSampler's role): rows ``shard_id::num_shards`` of the global
schedule, so the shards interleave to the one-process batch.

Each worker computes one sample at a time, so it runs OpenMP, BLAS and
OpenCV on one thread: started with the host's thread counts, every worker
would start a pool of threads as large as the host, and the workers
together oversubscribe its cores many times over.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import threading
import time
import warnings
from typing import Dict, Iterator, Optional

import numpy as np

_WORKER_DATASET = None
PREFETCH = 2  # batches built ahead of the step
CLOSE_WAIT_S = 60.0  # how long close() waits for the batches in flight
# the environment the workers start with: native thread pools read it when
# their libraries load, before any of our code runs in the worker
WORKER_THREAD_ENV = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
_ENV_LOCK = threading.Lock()  # the parent's environment is set and restored under it


def _worker_init(dataset_factory):
    import cv2

    global _WORKER_DATASET
    cv2.setNumThreads(1)
    _WORKER_DATASET = dataset_factory()


def sample_with_rng(dataset, idx: int, seed: int, it: int):
    """The loader's determinism contract: one RNG per (seed, iter, index)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, it, idx]))
    return dataset.sample(rng, idx, it)


def _worker_sample(args):
    idx, seed, it = args
    return sample_with_rng(_WORKER_DATASET, idx, seed, it)


class EpochShuffler:
    """Epoch-seeded shuffled index stream (samplers/distributed.py:11-67)."""

    def __init__(self, n: int, seed: int, start_pos: int = 0):
        self.n = n
        self.seed = seed
        self.pos = start_pos

    def take(self, count: int):
        out = []
        while count > 0:
            epoch, off = divmod(self.pos, self.n)
            perm = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch])
            ).permutation(self.n)
            grab = min(count, self.n - off)
            out.extend(int(i) for i in perm[off : off + grab])
            self.pos += grab
            count -= grab
        return out


class TrainLoader:
    """Infinite batch iterator.

    dataset_factory: zero-arg callable building the dataset inside each
    worker (datasets hold PIL/cv2 state that should not cross fork
    boundaries mid-use). batch: this shard's batch size; the global batch
    is ``batch * num_shards``, of which the shard takes the rows
    ``shard_id::num_shards``. start_iter resumes the data schedule exactly
    (dataloader.py:27).
    """

    def __init__(self, dataset_factory, batch: int, *, seed: int = 123,
                 num_workers: int = 8, start_iter: int = 0, shard_id: int = 0,
                 num_shards: int = 1):
        self.factory = dataset_factory
        self.batch = batch
        self.seed = seed
        self.num_workers = num_workers
        self.it = start_iter
        self.shard_id = shard_id
        self.num_shards = num_shards
        probe = dataset_factory()
        self.shuffler = EpochShuffler(len(probe), seed,
                                      start_pos=start_iter * batch * num_shards)
        self._pool = None
        self._local_dataset = probe if num_workers == 0 else None
        self._stop = None
        self._thread = None
        self._inflight = []  # the pool's unfinished batches, which close() waits for

    def _ensure_pool(self):
        if self.num_workers > 0 and self._pool is None:
            # spawn: forking a process that has initialized CUDA breaks
            # CUDA in the child; a fresh interpreter only re-imports.
            # Requires the dataset factory to be picklable.
            # The workers start with WORKER_THREAD_ENV; the parent's own
            # environment is put back once they have started.
            ctx = mp.get_context("spawn")
            with _ENV_LOCK:
                saved = {k: os.environ.get(k) for k in WORKER_THREAD_ENV}
                os.environ.update(WORKER_THREAD_ENV)
                try:
                    self._pool = ctx.Pool(
                        self.num_workers, initializer=_worker_init, initargs=(self.factory,)
                    )
                finally:
                    for k, v in saved.items():
                        if v is None:
                            del os.environ[k]
                        else:
                            os.environ[k] = v

    def _make_batch(self, indices, it, pool=None, stop=None) -> Optional[Dict[str, np.ndarray]]:
        """The batch of ``indices`` at iteration ``it``; None if ``stop`` is
        set while the worker pool builds it (a terminated pool never
        answers a waiting ``map``, so the wait polls)."""
        args = [(idx, self.seed, it) for idx in indices]
        if self.num_workers == 0:
            samples = [_collect(self._local_dataset, a) for a in args]
        else:
            pending = pool.map_async(_worker_sample, args)
            self._inflight = [r for r in self._inflight if not r.ready()] + [pending]
            while True:
                try:
                    samples = pending.get(timeout=0.5)
                    break
                except mp.TimeoutError:
                    if stop is not None and stop.is_set():
                        return None
        return {
            k: np.stack([s[k] for s in samples]) for k in samples[0]
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # one producer at a time: a second iterator first stops the first's
        # (the batches it built ahead are dropped), so close() stops them all
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._ensure_pool()
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        self._stop = stop

        pool = self._pool

        def producer():
            while not stop.is_set():
                it = self.it
                indices = self.shuffler.take(self.batch * self.num_shards)[
                    self.shard_id::self.num_shards]
                self.it += 1
                try:
                    b = self._make_batch(indices, it, pool, stop)
                except BaseException as e:  # propagate instead of hanging the consumer
                    b = e
                if b is None:  # stopped while the pool built it
                    return
                while not stop.is_set():
                    try:
                        q.put(b, timeout=1)
                        break
                    except queue.Full:
                        continue
                if isinstance(b, BaseException):
                    return

        t = threading.Thread(target=producer, daemon=True)
        self._thread = t
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    def close(self):
        """Stop the producer thread AND the worker pool.

        The generator's own ``finally`` only fires when the iterator is
        garbage-collected; a caller that merely stops pulling batches would
        otherwise leave a daemon thread building one more batch in the
        background (stealing host cores from whatever runs next — found as
        cross-stage pollution in scripts/loader_bench.py).

        The pool shuts down gracefully: the batches in flight finish and the
        workers exit on their own. ``Pool.terminate`` kills a worker even
        while it sends a sample, which leaves the result pipe's lock taken or
        a message cut short, and the pool's own shutdown then waits on it for
        ever. Only a pool that has not finished its batches within
        ``CLOSE_WAIT_S`` (a worker that died) is terminated."""
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            if self._thread.is_alive():  # kept, so that a later close() can join it
                warnings.warn("TrainLoader.close: the producer thread is still running "
                              "after 5 s")
            else:
                self._thread = None
        if self._pool is not None:
            deadline = time.monotonic() + CLOSE_WAIT_S
            for r in self._inflight:
                r.wait(max(0.0, deadline - time.monotonic()))
            if all(r.ready() for r in self._inflight):
                self._pool.close()
                self._pool.join()
            else:
                warnings.warn(f"TrainLoader.close: the workers did not finish their batches "
                              f"in {CLOSE_WAIT_S:.0f} s; terminating them")
                self._pool.terminate()
            self._pool, self._inflight = None, []


def _collect(dataset, args):
    idx, seed, it = args
    return sample_with_rng(dataset, idx, seed, it)
