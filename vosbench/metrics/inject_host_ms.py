"""Host milliseconds per frame that injecting objects takes: the injecting
frames' host blocks and their upload, each new object's overwrite of the
prediction and that frame's labels (``engine.inject``). A program that
counts no slots (``engine.slots``) records no such span: no number."""

from vosbench.metrics._spans import _record, host_ms


def read(s):
    rec = _record()
    if rec is None or "engine.slots" not in rec["counts"]:
        return None
    return host_ms(s, "engine.inject")
