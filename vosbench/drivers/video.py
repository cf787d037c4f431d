"""Offline video: ``engine.ChunkedVideoRunner.__call__`` over whole videos,
one after another, as an evaluation or an annotation-propagation job runs
them.

Traffic parameters: ``raw_hw`` (the uint8 host frames), ``in_hw`` (the
model's input, after /255 and a bicubic resize on the card), ``out_hw``
(the index maps), ``chunk``, ``objects``, ``lengths`` (the video lengths
of one pass; each seed runs them in its own order, pass after pass),
``pool_frames`` (each video is a slice of a seeded pool of moving-box
frames, starting at a multiple of ``start_step``), ``check_videos`` (how
many finished videos the reference judges, the longest among them) and
``trace_videos`` (how many videos, from the second on, ``--trace 1``
profiles).

End-to-end: ``video_fps``, all frames of all whole videos over the time
from the window's start to the end of the last video. Uploads and the
final fetch of the uint8 maps are inside.
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


def plan(seed: int, tr: dict, passes: int = 8):
    """[(length, start)], pass after pass over the lengths in seeded orders."""
    rng = np.random.default_rng([seed, 1])
    lengths = np.asarray(tr["lengths"])
    out = []
    for _ in range(passes):
        for T in rng.permutation(lengths):
            top = (tr["pool_frames"] - T) // tr["start_step"]
            out.append((int(T), int(rng.integers(0, top + 1)) * tr["start_step"]))
    return out


def setup(run):
    from swem_tpu_torch.engine import ChunkedVideoRunner
    from swem_tpu_torch.eval.evaluator import _preprocess
    from swem_tpu_torch.models.swem import SWEM

    cell, dev, tr = run.cell, run.device, run.cell.traffic
    N = tr["objects"]
    model = SWEM(harness.model_config(cell), device=dev)
    model.load_state_dict(random_weights(cell.mcfg, run.seed, dev))
    runner = ChunkedVideoRunner(model, tuple(tr["out_hw"]), chunk=tr["chunk"],
                                preprocess=_preprocess(tuple(tr["in_hw"])))
    runner.warmup(tuple(tr["raw_hw"]), 1, N, np.uint8)
    frames, labels = moving_boxes(run.seed, tr["pool_frames"], tuple(tr["raw_hw"]), N)
    videos = plan(run.seed, tr)
    starts = sorted({s for _, s in videos})
    masks = {s: (labels[s][None, ..., None] == np.arange(N + 1)).astype(np.float32) for s in starts}
    bases = harness.draw_bases(run.seed, len(tr["lengths"]), 1, cell.mcfg, dev)
    return {"model": model, "runner": runner, "frames": frames, "labels": labels,
            "videos": videos, "masks": masks, "bases": bases,
            "active": np.ones((1, N), bool)}


def window(run, state, tracer) -> dict:
    tr, runner = run.cell.traffic, state["runner"]
    frames, n_bases = state["frames"], len(state["bases"])
    pbases = [harness.program_bases(b) for b in state["bases"]]
    done, served = [], []
    t0 = time.perf_counter()
    for i, (T, s) in enumerate(state["videos"]):
        traced = 1 <= i <= tr["trace_videos"]
        if traced:
            tracer.start()
        elif i == tr["trace_videos"] + 1:
            tracer.stop()
        ts = time.perf_counter()
        out = runner(None, frames[s:s + T][:, None], state["masks"][s], state["active"],
                     bases=pbases[i % n_bases])
        te = time.perf_counter()
        done.append({"i": i, "T": T, "start": s, "t0": ts, "t1": te, "traced": traced})
        served.append(out[:, 0])
        if te - t0 >= run.seconds:
            break
    else:
        raise RuntimeError("the video plan ran out before the window closed")
    tracer.stop()
    n_frames = sum(d["T"] for d in done)
    h = len(done) // 2
    if h:
        halves = (sum(d["T"] for d in done[:h]) / (done[h - 1]["t1"] - t0),
                  sum(d["T"] for d in done[h:]) / (done[-1]["t1"] - done[h - 1]["t1"]))
        print(f"video_fps by halves of the window: {halves[0]!r} {halves[1]!r}", file=sys.stderr)
    cfg = run.cell.mcfg
    parts = flops.step_flops(cfg, 1, tr["objects"], tr["in_hw"], tr["out_hw"])
    free = [d for d in done if not d["traced"]]
    traced = [d for d in done if d["traced"]]
    P = (-(-tr["in_hw"][0] // 16)) * (-(-tr["in_hw"][1] // 16))
    N, Ck, Cv, L = tr["objects"], cfg["keydim"], cfg["valdim"], cfg["num_bases"]
    summary = {
        "units": sum(d["T"] for d in traced),
        "op_work": {OPS[0]: flops.em_loop_work(1, N, P, Ck, L, cfg["num_em_iters"]),
                    OPS[1]: flops.read_work(1, N, P, Ck, 2 * L, Cv)},
        "mfu_flops": sum(flops.video_flops(parts, d["T"]) for d in free),
        "mfu_seconds": sum(d["t1"] - d["t0"] for d in free),
        "dtype": cfg["dtype"],
    }
    return {"e2e": {"video_fps": n_frames / (done[-1]["t1"] - t0)}, "attempted": len(done),
            "failed": 0, "done": done, "served": served, "summary": summary}


def chunk_sizes(n_frames: int, chunk: int):
    """The runner's chunks over ``n_frames`` frames: full chunks, then the
    descending powers of two below ``chunk`` that the rest holds."""
    sizes, rest = [chunk] * (n_frames // chunk), n_frames % chunk
    s = 1
    while s * 2 < chunk:
        s *= 2
    while s >= 1:
        if s <= rest:
            sizes.append(s)
            rest -= s
        s //= 2
    return sizes


def sample(seed: int, done, k: int):
    """The longest finished video and k - 1 others drawn from the seed."""
    longest = max(range(len(done)), key=lambda j: (done[j]["T"], -j))
    rest = [j for j in range(len(done)) if j != longest]
    rng = np.random.default_rng([seed, 2])
    pick = rng.choice(rest, size=min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + sorted(int(j) for j in pick)


def replay_inputs(run, state, d):
    """The reference's inputs of finished video ``d``: its uint8 frames on
    the device, the frame-0 mask, active slots and bases."""
    tr, dev = run.cell.traffic, run.device
    N = tr["objects"]
    f = torch.from_numpy(state["frames"][d["start"]:d["start"] + d["T"]]).to(dev)
    mask = one_hot(torch.from_numpy(state["labels"][d["start"]]).to(dev), N + 1)[None]
    active = torch.ones((1, N), dtype=torch.bool, device=dev)
    return f, mask, active, state["bases"][d["i"] % len(state["bases"])]


def check(run, state, win, control: str = None) -> dict:
    """Free the program, then judge the served maps: every frame of the
    sampled videos (``confident``) and the first frame of every finished
    video (``first_confident``). With ``control`` ("fp8" or "tf32"), the
    reference at that precision serves the same frames in the program's
    place, and its maps are judged."""
    state.pop("runner", None)
    state.pop("model", None)
    harness.free_device(run.device)
    tr, cfg = run.cell.traffic, run.cell.mcfg
    out_hw, in_hw = tuple(tr["out_hw"]), tuple(tr["in_hw"])
    weights = random_weights(cfg, run.seed, run.device)
    net, scope = verdict.network(cfg, weights)
    low, low_scope = verdict.network(cfg, weights, control) if control else (None, None)
    first = verdict.Tally()
    picks = {j: verdict.Tally() for j in sample(run.seed, win["done"], tr["check_videos"])}
    for j, d in enumerate(win["done"]):
        f, mask, active, bases = replay_inputs(run, state, d)
        chunks = chunk_sizes(f.shape[0] - 1, tr["chunk"])
        stop = None if j in picks else 2
        served = win["served"][j]
        if control:
            with low_scope():
                served = verdict.replay(low, out_hw, f, in_hw, mask, active, bases,
                                        chunks=chunks, stop=stop)
        with scope():
            verdict.replay(net, out_hw, f, in_hw, mask, active, bases, served=served,
                           tally=picks.get(j), chunks=chunks, first=first,
                           stop=stop)
        del f
    every = list(picks.values())
    return {"confident": sum(t.confident for t in every) / sum(t.pixels for t in every),
            "first_confident": first.share(), "frames": [t.frames for t in every]}
