"""Host milliseconds per frame in the memory read (``engine.read``): the
memory gather, K2 (``read_normalized``), top-l and the fusion."""

from vosbench.metrics._spans import host_ms


def read(s):
    return host_ms(s, "engine.read")
