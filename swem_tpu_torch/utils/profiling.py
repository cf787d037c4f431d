"""Profiling and device-memory observability (the port's counterparts of
``swem_tpu/utils/profiling.py``): a ``torch.profiler`` run exported as a
Chrome trace, the device's busy time read from the run or from its trace,
the CUDA caching allocator's statistics under the JAX package's key names,
and the program's own stage spans and counters.

Spans and counters record exactly while a ``torch.profiler`` run is active
in the process (``tracing``); otherwise each costs one flag read. A stage
span (``span``) is a host op in the profiler's run, on its clock, beside
the kernels it launched, and an entry of an in-memory record; a request
(``request``) is kept in the record only and parents the stage spans run
inside it; ``count`` adds to a counter of the open request. ``recorded``
sums the record by name and ``reset`` clears it. Every time is host time
(``time.perf_counter_ns``): no span waits for the device or records a CUDA
event.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import itertools
import json
import os
import threading
import time
from collections import Counter
from typing import Iterable, NamedTuple, Optional, Tuple

import torch

TRACE_PATTERNS = ("*.pt.trace.json", "*.pt.trace.json.gz")

# A ``cpu_op`` in the profiler's events. ``torch.profiler.record_function``
# costs ~15 us even with no profiler running, and its ``user_annotation``
# gets a CUDA-typed twin spanning every kernel under it, which a reader
# counting CUDA events as kernels takes for device work.
_RecordFunctionFast = torch._C._profiler._RecordFunctionFast
_autograd_profiler = torch.autograd.profiler

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def tracing() -> bool:
        """Whether a ``torch.profiler`` run is active in the process: the one
        switch of the spans and counters."""
        return _autograd_profiler._is_profiler_enabled
else:
    tracing = torch._C._autograd._profiler_enabled


class _Entry(NamedTuple):
    """One closed span; a request is the entry whose id is its own request."""
    name: str
    id: int
    request: Optional[int]
    parent: Optional[int]
    thread: int
    t0: int  # ns, time.perf_counter_ns
    t1: int


class _Record:
    """The entries and the counts {(request id, name): total} recorded while
    tracing was on. The profiler is one per process, and so is this record."""

    def __init__(self):
        self.spans = []
        self.counts = Counter()
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.open = threading.local()  # this thread's stack of (id, request)

    def stack(self) -> list:
        st = getattr(self.open, "stack", None)
        if st is None:
            st = self.open.stack = []
        return st


_record = _Record()


class _Span:
    __slots__ = ("name", "is_request", "rf", "id", "request", "parent", "t0")

    def __init__(self, name: str, is_request: bool):
        self.name, self.is_request, self.rf = name, is_request, None

    def __enter__(self):
        st = _record.stack()
        self.parent, outer = st[-1] if st else (None, None)
        self.id = next(_record.ids)
        self.request = self.id if self.is_request else outer
        st.append((self.id, self.request))
        if not self.is_request:
            self.rf = _RecordFunctionFast(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _record.stack().pop()
        _record.spans.append(_Entry(self.name, self.id, self.request, self.parent,
                                    threading.get_ident(), self.t0, t1))
        return False


class _Off:
    """The span of an untraced call: enters and exits, records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A stage span around a block: with tracing off the shared no-op,
    else a host op ``name`` in the profiler's run and an entry of the
    record whose request is the innermost open one on this thread."""
    return _Span(name, False) if tracing() else _OFF


def request(name: str):
    """A request around one call of an entry point (``engine.video``,
    ``serve.push``, ...): kept in the record only, so the profiler's runs
    name host time by the stage spans inside it."""
    return _Span(name, True) if tracing() else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the open request, while tracing."""
    if tracing():
        st = _record.stack()
        key = (st[-1][1] if st else None, name)
        with _record.lock:
            _record.counts[key] += n


def recorded(request: Optional[str] = None) -> dict:
    """The record over the requests named ``request`` (every span and count
    when None): ``requests`` (how many) and ``request_s`` (their seconds),
    ``spans`` {name: {"calls", "self_s"}} (self: the span's duration less
    the part its child spans cover) and ``counts`` {name: total}."""
    spans = list(_record.spans)
    with _record.lock:
        counts = list(_record.counts.items())
    reqs = {e.id: e for e in spans if e.id == e.request and request in (None, e.name)}
    if request is not None:
        spans = [e for e in spans if e.request in reqs]
        counts = [(k, v) for k, v in counts if k[0] in reqs]
    covered = Counter()
    for e in spans:
        if e.parent is not None:
            covered[e.parent] += e.t1 - e.t0
    out = {}
    for e in spans:
        if e.id != e.request:
            d = out.setdefault(e.name, {"calls": 0, "self_s": 0.0})
            d["calls"] += 1
            d["self_s"] += (e.t1 - e.t0 - covered[e.id]) / 1e9
    total = Counter()
    for (_, name), v in counts:
        total[name] += v
    return {"requests": len(reqs), "request_s": sum(e.t1 - e.t0 for e in reqs.values()) / 1e9,
            "spans": out, "counts": dict(total)}


def reset() -> None:
    """Clear the record."""
    with _record.lock:
        _record.spans.clear()
        _record.counts.clear()


def _union_seconds(spans: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals given in us."""
    busy_us, end = 0.0, -float("inf")
    for s, e in sorted(spans):
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy_us / 1e6


def device_busy_seconds(prof) -> float:
    """Seconds in which at least one CUDA kernel ran, in a finished
    ``torch.profiler.profile`` run: the union of the kernels' intervals.

    Copies and sets between host and device, host work and the gaps between
    launches are not counted, so this is the time the card spent computing,
    whatever the host's speed. Raises RuntimeError when the run recorded no
    kernel (a CPU run, or a profiler that could not trace the card) instead
    of returning 0: callers divide by it.
    """
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    if not spans:
        raise RuntimeError("the profiler recorded no CUDA kernel: no device time to report")
    return _union_seconds(spans)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """A ``torch.profiler`` run of the block (host ops, and CUDA kernels when
    a card is present) whose Chrome trace is written into ``log_dir`` as
    ``<host>_<pid>.<ns>.pt.trace.json`` when the block ends (TensorBoard's
    profiler plugin and chrome://tracing read it). Yields the profiler, so
    ``device_busy_seconds`` can read the same run. The program's stage
    spans (``engine.read``, ``serve.fetch``, ...) appear in the trace as
    host ops above the kernels they launched; the record of spans and
    counters is cleared on entry, and after the block ``recorded()`` gives
    each stage's calls and self seconds. Example::

        with profile_trace("logs/trace"):
            preds = engine.run_video(...)
            torch.cuda.synchronize()
        stages = recorded()["spans"]
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def load_latest_trace(trace_dir: str) -> dict:
    """The newest Chrome trace (``*.pt.trace.json``, or gzipped) under
    ``trace_dir``, as ``profile_trace`` or ``tensorboard_trace_handler``
    write them."""
    paths = [p for pat in TRACE_PATTERNS
             for p in glob.glob(os.path.join(trace_dir, "**", pat), recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    path = max(paths, key=os.path.getmtime)
    with (gzip.open(path, "rt") if path.endswith(".gz") else open(path)) as f:
        return json.load(f)


def device_seconds_from_trace(trace_dir: str) -> float:
    """Seconds in which at least one CUDA kernel ran in the newest trace under
    ``trace_dir``: the union of its ``"cat": "kernel"`` events' intervals,
    copies (``gpu_memcpy``) and sets (``gpu_memset``) left out, the same
    definition as ``device_busy_seconds``. Raises RuntimeError when the
    trace holds no kernel event instead of returning 0: callers divide by
    it."""
    data = load_latest_trace(trace_dir)
    spans = [(ev["ts"], ev["ts"] + ev["dur"]) for ev in data.get("traceEvents", [])
             if ev.get("ph") == "X" and str(ev.get("cat", "")).lower() == "kernel"
             and "dur" in ev]
    if not spans:
        raise RuntimeError(f"the newest trace under {trace_dir} has no CUDA kernel event (a "
                           "CPU-only run, or a truncated trace): no device time to report")
    return _union_seconds(spans)


def device_memory_stats(device=None) -> Optional[dict]:
    """The CUDA caching allocator's statistics of ``device`` (default: the
    current CUDA device) under the JAX package's names: ``bytes_in_use``
    and ``peak_bytes_in_use`` (allocated tensors, now and at the peak since
    the last ``torch.cuda.reset_peak_memory_stats``) and ``bytes_limit``
    (the card's memory). None for a device that is not CUDA, as JAX returns
    on a backend without statistics."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total}


def log_memory(logger, device=None, prefix: str = "") -> None:
    """One log line of ``device_memory_stats`` in MiB, in the JAX package's
    format."""
    stats = device_memory_stats(device)
    if not stats:
        logger.info(f"{prefix}memory stats unavailable on this backend")
        return
    used = stats.get("bytes_in_use", 0) / 2**20
    peak = stats.get("peak_bytes_in_use", 0) / 2**20
    limit = stats.get("bytes_limit", 0) / 2**20
    logger.info(f"{prefix}HBM: {used:.0f}MiB in use, peak {peak:.0f}MiB, "
                f"limit {limit:.0f}MiB")
