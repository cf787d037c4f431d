"""Share of the object slots stepped that hold an object, in %: the
program's counters ``engine.active_slots`` over ``engine.slots`` (B x N
per frame). The slot buckets pad a video to a power of two: the rest is
the padding's share. A program that records no such counters gives no
number."""

from vosbench.metrics._spans import _record


def read(s):
    rec = _record()
    if rec is None or not rec["counts"].get("engine.slots"):
        return None
    return 100.0 * rec["counts"].get("engine.active_slots", 0) / rec["counts"]["engine.slots"]
