"""Profiling and device-memory observability (the port's counterparts of
``swem_tpu/utils/profiling.py``): a ``torch.profiler`` run exported as a
Chrome trace, the device's busy time read from the run or from its trace,
and the CUDA caching allocator's statistics under the JAX package's key
names."""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
from typing import Iterable, Optional, Tuple

import torch

TRACE_PATTERNS = ("*.pt.trace.json", "*.pt.trace.json.gz")


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
    ``device_busy_seconds`` can read the same run. Example::

        with profile_trace("logs/trace"):
            preds = engine.run_video(...)
            torch.cuda.synchronize()
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
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
