"""Host milliseconds per frame in the memorize (``engine.memorize``): the
bilinear resize, the value encoder, the EM masks and K1 (``em_loop``)."""

from vosbench.metrics._spans import host_ms


def read(s):
    return host_ms(s, "engine.memorize")
