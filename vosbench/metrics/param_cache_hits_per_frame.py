"""Prepared parameter tensors reused per frame (the program counter
``models.param_cache_hits``): each kernel or bias cast to the compute dtype,
each batch-norm fold, kept from an earlier call and used again instead of
prepared on this one. A program that records no such counter gives no
number."""

from vosbench.metrics._spans import _record

COUNTER = "models.param_cache_hits"


def read(s):
    rec = _record()
    if rec is None or not s.get("units") or COUNTER not in rec["counts"]:
        return None
    return rec["counts"][COUNTER] / s["units"]
