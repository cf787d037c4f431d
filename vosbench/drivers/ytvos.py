"""Offline YouTube-VOS: the evaluator's injectable runners, one per slot
bucket, over whole videos whose objects may first appear mid-video, as
``Evaluator.evaluate`` runs a YouTube-VOS set.

Set-up builds and warms one ``ChunkedVideoRunner(injectable=True)`` per
slot bucket that the plan uses, as ``Evaluator._runner`` does on first
use. Each video's runner inputs come from the evaluator's own rules: its
bucket from ``Evaluator._slot_bucket``, its ``init_mask``, ``active`` and
``injections`` from ``Evaluator._inputs`` over the ``YTVOSVideo`` that
``YTVOSTestSet`` would load (slots in order of first appearance). Both are
called on a stand-in holding the two attributes they read, since an
``Evaluator`` reads its set from disk and writes PNGs.

Traffic parameters: ``raw_hw`` (the uint8 host frames), ``in_hw`` (the
model's input, /255 and bicubic on the card), ``out_hw`` (the maps),
``chunk``, ``videos`` ([length, objects] of one pass), ``pool_frames``,
``pool_objects`` and ``start_step`` (each video is a slice of a seeded
pool of moving-box frames, its objects the pool's first boxes), ``inject_step`` (a late
object's first frame is a multiple of it), ``present_p`` (the chance that
an object after the first is annotated at frame 0), ``trace_objects`` and
``trace_videos`` (``--trace 1`` profiles the first ``trace_videos`` videos
with ``trace_objects`` objects after the window's first video).

The slot budget is the configuration's ``slot_budget`` (the evaluator's
``max(max_objs, 12)``).

End-to-end: ``video_fps``, all frames of all whole videos over the time from
the window's start to the end of the last video.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from vosbench import flops, harness, verdict
from vosbench.drivers.video import OPS, chunk_sizes  # noqa: F401 (run.py reads OPS)
from vosbench.drivers.video_batch import run_window
from vosbench.reference import inject as ref_inject
from vosbench.reference.model import random_weights
from vosbench.synth import moving_boxes


def position(T: int, t: int, chunk: int) -> str:
    """Where frame ``t`` of a T-frame video falls in the runner's chunks:
    "first", "last" or "inside" (a one-frame chunk is "first")."""
    start = 1
    for size in chunk_sizes(T - 1, chunk):
        if t < start + size:
            return "first" if t == start else "last" if t == start + size - 1 else "inside"
        start += size
    raise ValueError(f"frame {t} is not predicted in a {T}-frame video")


def _late_frames(T: int, tr: dict):
    """The frames a late object may first appear at: the multiples of
    ``inject_step`` in [inject_step, T/2]."""
    step = tr["inject_step"]
    return list(range(step, T // 2 + 1, step))


def _cover(videos, tr: dict) -> None:
    """Make a pass hold an injection at a chunk's first frame and one inside a
    chunk: where none was drawn, the first video that can takes one, on an
    object after the first that no other rule placed."""
    placed = set()
    for kind in ("first", "inside"):
        if any(position(v["T"], t, tr["chunk"]) == kind for v in videos for t in v["firsts"]
               if t):
            continue
        for j, v in enumerate(videos):
            frames = [t for t in _late_frames(v["T"], tr)
                      if position(v["T"], t, tr["chunk"]) == kind]
            objs = [k for k in range(1, v["objects"]) if (j, k) not in placed]
            if frames and objs:
                v["firsts"][objs[-1]] = frames[0]
                placed.add((j, objs[-1]))
                break


def plan(seed: int, tr: dict, passes: int = 2):
    """[{"T", "objects", "start", "firsts"}], pass after pass: each pass runs
    every video of ``videos`` once, in blocks of as many videos as there are
    object counts, each block holding one video of each count, in seeded
    orders. Object 0 is annotated at frame 0; each later one at frame 0 with
    chance ``present_p``, else at a seeded one of ``_late_frames``."""
    rng = np.random.default_rng([seed, 1])
    counts = sorted({n for _, n in tr["videos"]})
    by_count = {n: [i for i, (_, m) in enumerate(tr["videos"]) if m == n] for n in counts}
    blocks = len(tr["videos"]) // len(counts)
    if any(len(ix) != blocks for ix in by_count.values()):
        raise ValueError("ytvos traffic: every object count needs as many videos")
    out = []
    for _ in range(passes):
        groups = {n: rng.permutation(ix) for n, ix in by_count.items()}
        videos = []
        for b in range(blocks):
            for n in rng.permutation(counts):
                T = int(tr["videos"][groups[n][b]][0])
                top = (tr["pool_frames"] - T) // tr["start_step"]
                start = int(rng.integers(0, top + 1)) * tr["start_step"]
                late = _late_frames(T, tr)
                firsts = [0] + [0 if rng.random() < tr["present_p"] else int(rng.choice(late))
                                for _ in range(int(n) - 1)]
                videos.append({"T": T, "objects": int(n), "start": start, "firsts": firsts})
        _cover(videos, tr)
        out += videos
    return out


def ytvos_video(v: dict, frames, labels, tr: dict, n_slots: int):
    """The ``YTVOSVideo`` that ``YTVOSTestSet`` would load for planned video
    ``v``: object k is the pool's box k + 1, annotated from its first frame
    on; slots in order of first appearance."""
    from swem_tpu_torch.data.ytvos_test import YTVOSVideo

    out_hw, s = tuple(tr["out_hw"]), v["start"]
    order = sorted(range(v["objects"]), key=lambda k: (v["firsts"][k], k))
    slot = {k: i for i, k in enumerate(order)}

    def annotation(t):
        """(one-hot (Ho,Wo,n_slots+1) of the objects first annotated at t,
        their slots, the label map of every object annotated by t)."""
        lab = labels[s + t]
        shown = [k for k in order if v["firsts"][k] <= t]
        ann = np.where(np.isin(lab, [k + 1 for k in shown]), lab, 0)
        mask = np.zeros(out_hw + (n_slots + 1,), np.float32)
        mask[..., 0] = ann == 0
        new = [k for k in order if v["firsts"][k] == t]
        for k in new:
            mask[..., slot[k] + 1] = ann == k + 1
        return mask, [slot[k] for k in new], ann

    init_mask, init_slots, first_label = annotation(0)
    injections = {}
    for t in sorted(set(v["firsts"]) - {0}):
        mask, new, _ = annotation(t)
        injections[t] = {"mask": mask, "new_slots": new}
    return YTVOSVideo(name=f"video{s}", frames=frames[s:s + v["T"]],
                      in_size=tuple(tr["in_hw"]), init_mask=init_mask, init_slots=init_slots,
                      first_label=first_label, injections=injections,
                      slot_to_orig=[k + 1 for k in order], original_size=out_hw,
                      n_objs=v["objects"])


def runner_inputs(v: dict, frames, labels, tr: dict, n_slots: int):
    """(bucket, init_mask, active, injections) of planned video ``v``, by the
    evaluator's rules: ``_slot_bucket`` and ``_inputs`` called on a stand-in
    for an evaluator of a YouTube-VOS set with ``n_slots`` slots (the two
    attributes they read)."""
    from swem_tpu_torch.eval.evaluator import Evaluator

    ev = SimpleNamespace(n_slots=n_slots, ytvos=True)
    bucket = Evaluator._slot_bucket(ev, v["objects"])
    return (bucket,) + Evaluator._inputs(ev, [ytvos_video(v, frames, labels, tr, n_slots)],
                                         bucket)


def traced_order(n: int, videos, tr: dict):
    """The order a ``--trace 1`` run takes: the first video, then the first
    ``trace_videos`` videos with ``trace_objects`` objects after it (the
    traced part), then the rest in plan order."""
    picks = [i for i in range(1, n) if videos[i]["objects"] == tr["trace_objects"]]
    picks = picks[:tr["trace_videos"]]
    return [0] + picks + [i for i in range(1, n) if i not in picks]


def setup(run):
    from swem_tpu_torch.engine import ChunkedVideoRunner
    from swem_tpu_torch.eval.evaluator import _preprocess
    from swem_tpu_torch.models.swem import SWEM

    cell, dev, tr = run.cell, run.device, run.cell.traffic
    model = SWEM(harness.model_config(cell), device=dev)
    model.load_state_dict(random_weights(cell.mcfg, run.seed, dev))
    frames, labels = moving_boxes(run.seed, tr["pool_frames"], tuple(tr["raw_hw"]),
                                  tr["pool_objects"])
    videos = plan(run.seed, tr)
    for v in videos:
        v["bucket"], *v["inputs"] = runner_inputs(v, frames, labels, tr,
                                                  cell.mcfg["slot_budget"])
    runners = {}
    for b in sorted({v["bucket"] for v in videos}):
        runners[b] = ChunkedVideoRunner(model, tuple(tr["out_hw"]), chunk=tr["chunk"],
                                        preprocess=_preprocess(tuple(tr["in_hw"])),
                                        injectable=True)
        runners[b].warmup(tuple(tr["raw_hw"]), 1, b, np.uint8)
    bases = {b: harness.draw_bases(run.seed * 16 + b, len(tr["videos"]), 1,
                                   dict(cell.mcfg, max_objs=b), dev) for b in runners}
    order = traced_order(len(videos), videos, tr) if run.trace else list(range(len(videos)))
    return {"model": model, "runners": runners, "frames": frames, "labels": labels,
            "videos": videos, "order": order, "bases": bases}


def window(run, state, tracer) -> dict:
    tr, frames, videos = run.cell.traffic, state["frames"], state["videos"]
    pbases = {b: [harness.program_bases(x) for x in bs] for b, bs in state["bases"].items()}
    parts = {b: flops.step_flops(run.cell.mcfg, 1, b, tr["in_hw"], tr["out_hw"])
             for b in state["runners"]}

    def call(i):
        v = videos[i]
        init_mask, active, injections = v["inputs"]
        b = v["bucket"]
        out = state["runners"][b](None, frames[v["start"]:v["start"] + v["T"]][:, None],
                                  init_mask, active, injections,
                                  bases=pbases[b][i % len(pbases[b])])
        return out[:, 0], {"i": i, "T": v["T"], "bucket": b}

    # the traced videos' bucket
    N = next(v["bucket"] for v in videos if v["objects"] == tr["trace_objects"])
    return run_window(run, tracer, state["order"], tr["trace_videos"], call,
                      lambda d: flops.video_flops(parts[d["bucket"]], d["T"]), 1, N)


def check(run, state, win, control: str = None) -> dict:
    """Free the program, then judge the served maps of every finished video:
    the first answer of every object (``first_confident``: the first
    predicted frame, and each injection frame on the injected objects'
    ground-truth pixels), the first answer from a memory that holds them
    (``inject_next_confident``: the frame after each injection, on the
    pixels that the served map or the reference gives those objects), and
    the ``judged_frames`` of its injections (``inject_confident``: the
    injection frame and the next, whole). With ``control`` ("fp8" or
    "tf32"), the reference at that precision serves the same frames in the
    program's place, and its maps are judged."""
    state.pop("runners", None)
    state.pop("model", None)
    harness.free_device(run.device)
    tr, cfg, dev = run.cell.traffic, run.cell.mcfg, run.device
    out_hw, in_hw = tuple(tr["out_hw"]), tuple(tr["in_hw"])
    weights = random_weights(cfg, run.seed, dev)
    net, scope = verdict.network(cfg, weights)
    low, low_scope = verdict.network(cfg, weights, control) if control else (None, None)
    first, injected, after = verdict.Tally(), verdict.Tally(), verdict.Tally()
    for j, d in enumerate(win["done"]):
        v = state["videos"][d["i"]]
        init_mask, active, injections = v["inputs"]
        stop = max(ref_inject.judged_frames(injections), default=1) + 1
        chunks = chunk_sizes(v["T"] - 1, tr["chunk"])
        # frame 0 and the chunks up to the one holding frame stop - 1
        ends = np.cumsum(chunks)
        n_up = 1 + int(ends[np.searchsorted(ends, stop - 1)])
        f = torch.from_numpy(state["frames"][v["start"]:v["start"] + n_up]).to(dev)[:, None]
        mask = torch.from_numpy(init_mask).to(dev)
        act = torch.from_numpy(active).to(dev)
        bases = state["bases"][d["bucket"]][d["i"] % len(state["bases"][d["bucket"]])]
        served = win["served"][j]
        if control:
            with low_scope():
                served = ref_inject.replay(low, out_hw, f, in_hw, mask, act, bases, injections,
                                           chunks=chunks, stop=stop)
        with scope():
            ref_inject.replay(net, out_hw, f, in_hw, mask, act, bases, injections,
                              served=served, chunks=chunks, first=first, arrivals=first,
                              injected=injected, after=after, stop=stop)
        del f
    share = lambda t: t.share() if t.pixels else 0.0  # noqa: E731
    return {"first_confident": first.share(), "inject_next_confident": share(after),
            "inject_confident": share(injected)}
