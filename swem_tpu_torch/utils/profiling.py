"""Device time from a ``torch.profiler`` run (counterpart of
``swem_tpu/utils/profiling.py::device_seconds_from_trace``)."""

from __future__ import annotations

import torch


def device_busy_seconds(prof) -> float:
    """Seconds in which at least one CUDA kernel ran, in a finished
    ``torch.profiler.profile`` run: the union of the kernels' intervals.

    Copies and sets between host and device, host work and the gaps between
    launches are not counted, so this is the time the card spent computing,
    whatever the host's speed. Raises RuntimeError when the run recorded no
    kernel (a CPU run, or a profiler that could not trace the card) instead
    of returning 0: callers divide by it.
    """
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not e.name.startswith(("Memcpy", "Memset")))
    if not spans:
        raise RuntimeError("the profiler recorded no CUDA kernel: no device time to report")
    busy_us, end = 0.0, -float("inf")
    for s, e in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy_us / 1e6
