"""A live stream: one ``serve.StreamingSession`` driven in a closed loop,
the next ``push`` sent as soon as the previous map is on the host, which
is the fastest one caller can drive a session.

Traffic parameters: ``raw_hw`` (the camera's uint8 frames), ``in_hw``,
``out_hw``, ``objects``, ``stream_frames`` (each stream is ``start`` on its
frame 0 with fresh bases, then a push of every later frame; streams follow
one another over one seeded clip of moving boxes), ``check_streams`` (how
many streams the reference judges, the longest first) and
``trace_pushes`` (how many pushes, from the 11th on, ``--trace 1``
profiles).

End-to-end: ``push_p95_ms``, the 95th percentile over every push in the
window of the time from the call until its map is a host array.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from vosbench import flops, harness, verdict
from vosbench.reference.engine import one_hot
from vosbench.reference.model import random_weights
from vosbench.synth import moving_boxes

OPS = ("swem_tpu_torch::em_loop", "swem_tpu_torch::read_normalized")
TRACE_FROM = 10  # pushes before the traced part


def setup(run):
    from swem_tpu_torch.serve import StreamingSession

    cell, dev, tr = run.cell, run.device, run.cell.traffic
    N = tr["objects"]
    session = StreamingSession(harness.model_config(cell),
                               random_weights(cell.mcfg, run.seed, dev),
                               raw_hw=tuple(tr["raw_hw"]), in_size=tuple(tr["in_hw"]),
                               out_size=tuple(tr["out_hw"]), n_slots=N, device=dev)
    session.warmup()
    frames, labels = moving_boxes(run.seed, tr["stream_frames"], tuple(tr["raw_hw"]), N)
    return {"session": session, "frames": frames, "labels": labels,
            "bases": harness.draw_bases(run.seed, 8, 1, cell.mcfg, dev)}


def window(run, state, tracer) -> dict:
    tr, session, frames = run.cell.traffic, state["session"], state["frames"]
    n_bases = len(state["bases"])
    pbases = [harness.program_bases(b) for b in state["bases"]]
    lat, traced, streams = [], [], []
    n = 0
    t0 = time.perf_counter()
    closed = False
    while not closed:
        s = len(streams)
        session.start(frames[0], state["labels"][0], bases=pbases[s % n_bases])
        streams.append([])
        for t in range(1, len(frames)):
            if n == TRACE_FROM:
                tracer.start()
            elif n == TRACE_FROM + tr["trace_pushes"]:
                tracer.stop()
            ts = time.perf_counter()
            y = session.push(frames[t])
            te = time.perf_counter()
            lat.append(te - ts)
            traced.append(tracer.active)
            streams[-1].append(y)
            n += 1
            if te - t0 >= run.seconds:
                closed = True
                break
    tracer.stop()
    ms = np.asarray(lat) * 1e3
    halves = [float(np.percentile(x, 95)) for x in np.array_split(ms, 2)]
    print(f"push_p95_ms by halves of the window: {halves[0]!r} {halves[1]!r}", file=sys.stderr)
    cfg = run.cell.mcfg
    parts = flops.step_flops(cfg, 1, tr["objects"], tr["in_hw"], tr["out_hw"])
    push = parts["key"] + parts["read"] + parts["value"] + parts["em"]
    free = [x for x, t in zip(lat, traced) if not t]
    P = (-(-tr["in_hw"][0] // 16)) * (-(-tr["in_hw"][1] // 16))
    N, Ck, Cv, L = tr["objects"], cfg["keydim"], cfg["valdim"], cfg["num_bases"]
    summary = {
        "units": sum(traced),
        "op_work": {OPS[0]: flops.em_loop_work(1, N, P, Ck, L, cfg["num_em_iters"]),
                    OPS[1]: flops.read_work(1, N, P, Ck, 2 * L, Cv)},
        "mfu_flops": push * len(free), "mfu_seconds": sum(free), "dtype": cfg["dtype"],
    }
    return {"e2e": {"push_p95_ms": float(np.percentile(ms, 95))},
            "attempted": n, "failed": 0, "streams": streams, "summary": summary}


def replay_inputs(run, state, n_frames: int):
    tr, dev = run.cell.traffic, run.device
    N = tr["objects"]
    f = torch.from_numpy(state["frames"][:n_frames]).to(dev)
    mask = one_hot(torch.from_numpy(state["labels"][0]).to(dev), N + 1)[None]
    return f, mask, torch.ones((1, N), dtype=torch.bool, device=dev)


def sample(seed: int, streams, k: int):
    """The longest stream and k - 1 others drawn from the seed."""
    longest = max(range(len(streams)), key=lambda j: (len(streams[j]), -j))
    rest = [j for j in range(len(streams)) if j != longest and streams[j]]
    rng = np.random.default_rng([seed, 2])
    pick = rng.choice(rest, size=min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + sorted(int(j) for j in pick)


def check(run, state, win, control: str = None) -> dict:
    """Free the program, then judge the served maps: every push of the
    sampled streams (``confident``) and the first push of every stream
    (``first_confident``); with ``control``, the reference at that
    precision serves them instead."""
    state.pop("session", None)
    harness.free_device(run.device)
    tr, cfg = run.cell.traffic, run.cell.mcfg
    out_hw, in_hw = tuple(tr["out_hw"]), tuple(tr["in_hw"])
    weights = random_weights(cfg, run.seed, run.device)
    net, scope = verdict.network(cfg, weights)
    low, low_scope = verdict.network(cfg, weights, control) if control else (None, None)
    every, first = verdict.Tally(), verdict.Tally()
    picks = set(sample(run.seed, win["streams"], tr["check_streams"]))
    for j, served in enumerate(win["streams"]):
        stop = None if j in picks else 2
        f, mask, active = replay_inputs(run, state, len(served) + 1 if stop is None else 2)
        bases = state["bases"][j % len(state["bases"])]
        if control:
            with low_scope():
                served = verdict.replay(low, out_hw, f, in_hw, mask, active, bases,
                                        memorize_last=True, stop=stop)
        with scope():
            verdict.replay(net, out_hw, f, in_hw, mask, active, bases, served=served,
                           memorize_last=True, tally=every if j in picks else None,
                           first=first, stop=stop)
        del f
    return {"confident": every.share(), "first_confident": first.share()}
