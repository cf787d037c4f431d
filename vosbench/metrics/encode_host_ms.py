"""Host milliseconds per frame in the key encode (``engine.encode_keys``):
the key trunk, the key projection and compression, the decoder skips and
the value stem, once per chunk in a video and once per push."""

from vosbench.metrics._spans import host_ms


def read(s):
    return host_ms(s, "engine.encode_keys")
