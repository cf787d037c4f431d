"""The stage spans and counters that the program records inside itself while
the traced part runs (``swem_tpu_torch.utils.profiling.recorded``), per
unit of the traced part (a frame of a video, a push of a stream).

The record is summed over the requests of the cell's kind, the first of
``REQUESTS`` that the traced part holds: whole videos, else pushes, so
that a stream's ``start`` traced beside its pushes adds nothing per push.
A program that records no spans gives no number."""

REQUESTS = ("engine.video", "serve.push")


def _record():
    from swem_tpu_torch.utils import profiling

    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    for kind in REQUESTS:
        rec = recorded(kind)
        if rec["requests"]:
            return rec
    return None


def host_ms(s, *spans):
    """Self milliseconds of the stage spans ``spans`` per unit."""
    rec = _record()
    if rec is None or not s.get("units"):
        return None
    return 1e3 * sum(rec["spans"].get(n, {}).get("self_s", 0.0) for n in spans) / s["units"]


def per_unit(s, counter):
    """Counter ``counter``'s total per unit."""
    rec = _record()
    if rec is None or not s.get("units"):
        return None
    return rec["counts"].get(counter, 0) / s["units"]
