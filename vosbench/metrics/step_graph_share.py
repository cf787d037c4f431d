"""Share of the traced part's video frames whose step replayed the runner's
CUDA graphs (read, decode and, where memorized, memorize): the program
counters ``engine.graph_steps`` over ``engine.steps``, in %. A program
that counts no steps gives no number."""

from vosbench.metrics._spans import _record

STEPS, GRAPH_STEPS = "engine.steps", "engine.graph_steps"


def read(s):
    rec = _record()
    if rec is None or not rec["counts"].get(STEPS):
        return None
    return 100.0 * rec["counts"].get(GRAPH_STEPS, 0) / rec["counts"][STEPS]
