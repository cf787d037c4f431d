"""Host milliseconds per frame that uploading takes: the frames, masks and
slot states moved to the card, /255 and the bicubic resize
(``engine.upload`` in a video, ``serve.upload`` in a push)."""

from vosbench.metrics._spans import host_ms


def read(s):
    return host_ms(s, "engine.upload", "serve.upload")
