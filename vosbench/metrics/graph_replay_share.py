"""Share of the traced part's pushes that replayed the session's captured
CUDA graph: the program counters ``serve.graph_replays`` over
``serve.pushes``, in %. A program that counts no pushes gives no number."""

from vosbench.metrics._spans import _record

PUSHES, REPLAYS = "serve.pushes", "serve.graph_replays"


def read(s):
    rec = _record()
    if rec is None or not rec["counts"].get(PUSHES):
        return None
    return 100.0 * rec["counts"].get(REPLAYS, 0) / rec["counts"][PUSHES]
