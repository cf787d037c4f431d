"""Host milliseconds per frame in the decode (``engine.decode``): the
decoder, the soft aggregation, an injection and the argmax."""

from vosbench.metrics._spans import host_ms


def read(s):
    return host_ms(s, "engine.decode")
