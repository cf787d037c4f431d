"""Offline video in the evaluator's throughput mode (``--video_batch``):
``ChunkedVideoRunner.__call__`` over batches of whole videos, one batch
after another, as ``Evaluator._evaluate_batched`` runs them.

The batches are the evaluator's: the videos sorted by length and taken
``video_batch`` at a time, each batch's shorter videos padded with their
last frame (``evaluator._stack_padded``). A pass runs every batch once, in
a seeded order; each video is a slice of a seeded pool of moving-box
frames whose start is drawn once per seed.

Traffic parameters: those of ``drivers/video.py`` (``raw_hw``, ``in_hw``,
``out_hw``, ``chunk``, ``objects``, ``lengths``, ``pool_frames``,
``start_step``), ``video_batch``, and ``trace_batches`` (how many
batches, from the second on, ``--trace 1`` profiles).

End-to-end: ``video_fps``, the frames of all whole videos (padded frames not
counted) over the time from the window's start to the end of the last
batch.
"""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from vosbench import flops, harness, verdict
from vosbench.drivers.video import OPS, chunk_sizes
from vosbench.reference import inject as ref_inject
from vosbench.reference.model import random_weights
from vosbench.synth import moving_boxes


def batches(tr: dict):
    """The evaluator's batches of one pass: the lengths' indices sorted by
    length, ``video_batch`` at a time."""
    order = sorted(range(len(tr["lengths"])), key=lambda i: tr["lengths"][i])
    vb = tr["video_batch"]
    return [order[i:i + vb] for i in range(0, len(order), vb)]


def plan(seed: int, tr: dict, passes: int = 8):
    """The batch indices, pass after pass in seeded orders, and each video's
    pool start."""
    rng = np.random.default_rng([seed, 1])
    n = len(batches(tr))
    order = [int(k) for _ in range(passes) for k in rng.permutation(n)]
    starts = [int(rng.integers(0, (tr["pool_frames"] - T) // tr["start_step"] + 1))
              * tr["start_step"] for T in tr["lengths"]]
    return order, starts


def setup(run):
    from swem_tpu_torch.engine import ChunkedVideoRunner
    from swem_tpu_torch.eval.evaluator import _preprocess, _stack_padded
    from swem_tpu_torch.models.swem import SWEM

    cell, dev, tr = run.cell, run.device, run.cell.traffic
    N, vb = tr["objects"], tr["video_batch"]
    model = SWEM(harness.model_config(cell), device=dev)
    model.load_state_dict(random_weights(cell.mcfg, run.seed, dev))
    runner = ChunkedVideoRunner(model, tuple(tr["out_hw"]), chunk=tr["chunk"],
                                preprocess=_preprocess(tuple(tr["in_hw"])))
    runner.warmup(tuple(tr["raw_hw"]), vb, N, np.uint8)
    frames, labels = moving_boxes(run.seed, tr["pool_frames"], tuple(tr["raw_hw"]), N)
    order, starts = plan(run.seed, tr)
    groups = batches(tr)
    stacks, masks = [], []
    for group in groups:
        videos = [SimpleNamespace(frames=frames[starts[i]:starts[i] + tr["lengths"][i]])
                  for i in group]
        stacks.append(_stack_padded(videos))
        masks.append(np.stack([(labels[starts[i]][..., None] == np.arange(N + 1))
                               .astype(np.float32) for i in group]))
    bases = harness.draw_bases(run.seed, len(groups), 1, cell.mcfg, dev)
    return {"model": model, "runner": runner, "order": order, "groups": groups, "stacks": stacks,
            "masks": masks, "bases": bases, "active": np.ones((vb, N), bool)}


def run_window(run, tracer, items, n_traced: int, call, flops_of, B: int, N: int) -> dict:
    """An offline driver's window: ``call(item)`` -> (served maps, record of
    the frames counted, "T", and what ``check`` needs) on each of ``items``
    in turn, until ``run.seconds`` have passed since the window's start;
    items 1..``n_traced`` under the tracer. K1's and K2's work per call is
    reckoned at (B, N) and the model FLOPs of each untraced item by
    ``flops_of(record)``."""
    tr, cfg = run.cell.traffic, run.cell.mcfg
    done, served = [], []
    t0 = time.perf_counter()
    for pos, item in enumerate(items):
        traced = 1 <= pos <= n_traced
        if traced:
            tracer.start()
        elif pos == n_traced + 1:
            tracer.stop()
        ts = time.perf_counter()
        out, d = call(item)
        te = time.perf_counter()
        done.append(dict(d, t0=ts, t1=te, traced=traced))
        served.append(out)
        if te - t0 >= run.seconds:
            break
    else:
        raise RuntimeError("the plan ran out before the window closed")
    tracer.stop()
    h = len(done) // 2
    if h:
        halves = (sum(d["T"] for d in done[:h]) / (done[h - 1]["t1"] - t0),
                  sum(d["T"] for d in done[h:]) / (done[-1]["t1"] - done[h - 1]["t1"]))
        print(f"video_fps by halves of the window: {halves[0]!r} {halves[1]!r}", file=sys.stderr)
    free = [d for d in done if not d["traced"]]
    P = (-(-tr["in_hw"][0] // 16)) * (-(-tr["in_hw"][1] // 16))
    Ck, Cv, L = cfg["keydim"], cfg["valdim"], cfg["num_bases"]
    summary = {
        "units": sum(d["T"] for d in done if d["traced"]),
        "op_work": {OPS[0]: flops.em_loop_work(B, N, P, Ck, L, cfg["num_em_iters"]),
                    OPS[1]: flops.read_work(B, N, P, Ck, 2 * L, Cv)},
        "mfu_flops": sum(flops_of(d) for d in free),
        "mfu_seconds": sum(d["t1"] - d["t0"] for d in free),
        "dtype": cfg["dtype"],
    }
    return {"e2e": {"video_fps": sum(d["T"] for d in done) / (done[-1]["t1"] - t0)},
            "attempted": len(done), "failed": 0, "done": done, "served": served,
            "summary": summary}


def window(run, state, tracer) -> dict:
    tr, runner = run.cell.traffic, state["runner"]
    pbases = [harness.program_bases(b) for b in state["bases"]]
    parts = flops.step_flops(run.cell.mcfg, 1, tr["objects"], tr["in_hw"], tr["out_hw"])

    def call(k):
        group = state["groups"][k]
        out = runner(None, state["stacks"][k], state["masks"][k],
                     state["active"][:len(group)], bases=pbases[k])
        lengths = [tr["lengths"][i] for i in group]
        return out, {"k": k, "lengths": lengths, "T": sum(lengths)}

    # the videos' own frames: the padding's work is not the model's
    return run_window(run, tracer, state["order"], tr["trace_batches"], call,
                      lambda d: sum(flops.video_flops(parts, T) for T in d["lengths"]),
                      tr["video_batch"], tr["objects"])


def check(run, state, win, control: str = None) -> dict:
    """Free the program, then judge the first predicted frame of every video
    of every finished batch (``first_confident``) against the reference run
    over the batch as the program ran it: at a batch of two, bf16
    convolutions take other algorithms than at one, and those roundings
    alone move labels. With ``control``, the reference at that precision
    serves the same frames in the program's place."""
    state.pop("runner", None)
    state.pop("model", None)
    harness.free_device(run.device)
    tr, cfg, dev = run.cell.traffic, run.cell.mcfg, run.device
    out_hw, in_hw = tuple(tr["out_hw"]), tuple(tr["in_hw"])
    weights = random_weights(cfg, run.seed, dev)
    net, scope = verdict.network(cfg, weights)
    low, low_scope = verdict.network(cfg, weights, control) if control else (None, None)
    first = verdict.Tally()
    for j, d in enumerate(win["done"]):
        k = d["k"]
        chunks = chunk_sizes(max(d["lengths"]) - 1, tr["chunk"])
        f = torch.from_numpy(state["stacks"][k][:1 + chunks[0]]).to(dev)
        mask = torch.from_numpy(state["masks"][k]).to(dev)
        active = torch.from_numpy(state["active"][:len(d["lengths"])]).to(dev)
        served = win["served"][j]
        if control:
            with low_scope():
                served = ref_inject.replay(low, out_hw, f, in_hw, mask, active,
                                           state["bases"][k], {}, chunks=chunks, stop=2)
        with scope():
            ref_inject.replay(net, out_hw, f, in_hw, mask, active, state["bases"][k], {},
                              served=served, chunks=chunks, first=first, stop=2)
        del f
    return {"first_confident": first.share()}
