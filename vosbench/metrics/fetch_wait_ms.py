"""Host milliseconds per frame in the fetch of the index maps
(``engine.fetch`` once per video, ``serve.fetch`` once per push): the
host waiting for the card to drain its queue, then the copy."""

from vosbench.metrics._spans import host_ms


def read(s):
    return host_ms(s, "engine.fetch", "serve.fetch")
