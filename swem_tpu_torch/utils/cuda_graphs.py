"""CUDA graphs cut at the hand-written kernels.

A ``CutGraph`` captures a function as a chain of CUDA graphs, cut wherever
the function launches one of the port's hand-written kernels through
``kernel``. At every replay each kernel runs eagerly between two graphs, as
it runs outside one: its custom op (``swem_tpu_torch::em_loop``,
``::read_normalized``) is a host op on the profiler's clock, with the
kernel's device time under it, and its wrapper counts the launch. Every
other op of the function launches from the replays, with no Python between
its kernels.

What a captured function reads and the state it updates are tensors that
outlive the graph, written in place and never rebound: a replay reads and
writes the addresses the capture saw. A kernel's arguments are the
tensors the capture handed it (the graph before it rewrites them on every
replay); its outputs are copied into the tensors the capture got, which
the graph after it reads. The graphs of one ``capturing`` block share one
memory pool, so they must replay in the order they were captured, one
after another; a graph may be left out of a round (the step of a video's
last frame memorizes nothing).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import torch

_capture = threading.local()  # .graph: the CutGraph capturing on this thread


def kernel(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, the launch of a hand-written kernel whose
    outputs are a tuple of fresh tensors. While a ``CutGraph`` captures on
    this thread, the cut between two of its graphs: the kernel runs there
    eagerly, and again at each replay."""
    graph = getattr(_capture, "graph", None)
    if graph is None:
        return fn(*args, **kwargs)
    return graph._cut(fn, args, kwargs)


@contextlib.contextmanager
def capturing(stream: torch.cuda.Stream) -> Iterator[object]:
    """Run the block on ``stream`` (a capture may not run on the default
    stream), after the current stream's work and before its later work;
    yields the memory pool that the block's ``CutGraph``s share."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    try:
        with torch.cuda.stream(stream):
            yield torch.cuda.graph_pool_handle()
    finally:
        current.wait_stream(stream)


class CutGraph:
    """``fn()`` captured as CUDA graphs cut at its ``kernel`` calls, in
    ``pool``, on the current stream (``capturing``'s).

    The capture runs ``fn`` once: each graph is replayed as soon as its
    capture ends, so that the kernel after it computes on real data, and
    ``outputs`` is what ``fn`` returned, the tensors every replay rewrites.
    """

    def __init__(self, fn, pool):
        self._pool = pool
        self._parts = []  # CUDAGraphs and (kernel, args, kwargs, the capture's outputs)
        self._open = self._begin()
        _capture.graph = self
        try:
            self.outputs = fn()
        except BaseException:
            if self._open is not None:  # leave capture mode; the graph is dropped
                self._open.capture_end()
            raise
        finally:
            _capture.graph = None
        self._end()

    def _begin(self) -> torch.cuda.CUDAGraph:
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self._pool)
        return graph

    def _end(self) -> None:
        graph, self._open = self._open, None
        graph.capture_end()
        graph.replay()
        self._parts.append(graph)

    def _cut(self, fn, args, kwargs):
        self._end()
        out = fn(*args, **kwargs)
        self._parts.append((fn, args, kwargs, out))
        self._open = self._begin()
        return out

    def replay(self) -> None:
        """The graphs in turn, each kernel launched between them."""
        for part in self._parts:
            if isinstance(part, tuple):
                fn, args, kwargs, out = part
                for dst, src in zip(out, fn(*args, **kwargs)):
                    dst.copy_(src)
            else:
                part.replay()
