"""The YouTube-VOS cell (``drivers/ytvos.py``) and the batched DAVIS cell
(``drivers/video_batch.py``): their plans, their inputs by the evaluator's
rules, the readers of the slot counters and the inject span, and whole
runs at a tiny size on the CPU, sound and with a planted fault."""

import time

import numpy as np
import pytest
import torch

from vosbench import harness
from vosbench.drivers import video_batch, ytvos
from vosbench.run import run_cell
from vosbench.tests import _tiny

CELL, VB2 = "ytvos-offline.bf16", "davis-offline-vb2.bf16"
SEEDS = [0, 7, 2 ** 31 + 7, 3_000_000_019, 2 ** 33 + 1]
TINY_YTVOS = {"driver": "ytvos", "raw_hw": [64, 96], "in_hw": [48, 64], "out_hw": [64, 96],
              "chunk": 4, "videos": [[20, 2], [22, 3], [21, 2], [24, 3]], "pool_frames": 24,
              "pool_objects": 3, "start_step": 1, "inject_step": 5, "present_p": 0.0,
              "trace_objects": 3, "trace_videos": 1}
TINY_VB2 = dict(_tiny.TRAFFIC["video"], driver="video_batch", lengths=[5, 7, 9, 6],
                video_batch=2, trace_batches=1)


def tiny_cell(name, traffic, **mcfg):
    real = harness.load_cell(name)
    cfg = dict(_tiny.TINY, slot_budget=real.mcfg.get("slot_budget", 12), **mcfg)
    return harness.Cell(real.name, 1, cfg, traffic, real.limits, real.end_to_end, real.per_layer)


def tiny_run(name, traffic, seconds=0.5, trace=False, **mcfg):
    torch.set_num_threads(2)
    return run_cell(tiny_cell(name, traffic, **mcfg), 2 ** 31 + 7, seconds, trace,
                    torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("seed", SEEDS)
def test_the_plan_keeps_the_mix_and_the_annotation_stride(seed):
    tr = harness.load_cell(CELL).traffic
    videos = ytvos.plan(seed, tr)
    counts = sorted({n for _, n in tr["videos"]})
    assert len(videos) == 2 * len(tr["videos"])
    for b in range(0, len(videos), len(counts)):
        assert sorted(v["objects"] for v in videos[b:b + len(counts)]) == counts
    n = len(tr["videos"])
    for p in (videos[:n], videos[n:]):
        assert sorted((v["T"], v["objects"]) for v in p) == sorted(map(tuple, tr["videos"]))
        assert {"first", "inside"} <= {ytvos.position(v["T"], t, tr["chunk"])
                                       for v in p for t in v["firsts"] if t}
    for v in videos:
        assert v["firsts"][0] == 0 and len(v["firsts"]) == v["objects"]
        assert 0 <= v["start"] <= tr["pool_frames"] - v["T"]
        for t in v["firsts"][1:]:
            assert t == 0 or (t % tr["inject_step"] == 0 and tr["inject_step"] <= t <= v["T"] / 2)
    assert ytvos.plan(seed, tr) == videos


def test_inputs_follow_the_evaluators_rules():
    tr = dict(TINY_YTVOS, present_p=0.5)
    v = {"T": 20, "objects": 3, "start": 2, "firsts": [0, 10, 0]}
    from vosbench.synth import moving_boxes

    frames, labels = moving_boxes(3, 24, tuple(tr["raw_hw"]), 3)
    bucket, init_mask, active, injections = ytvos.runner_inputs(v, frames, labels, tr, 12)
    assert bucket == 4 and init_mask.shape == (1, 64, 96, 5)
    # slots in order of first appearance: boxes 1 and 3 at frame 0, box 2 later
    assert active.tolist() == [[True, True, False, False]]
    np.testing.assert_array_equal(init_mask[0, ..., 2], labels[2] == 3)
    assert list(injections) == [10]
    idx, new = injections[10]
    assert new.tolist() == [[False, False, True, False]]
    np.testing.assert_array_equal(idx[0], np.where(labels[12] == 2, 3, 0))
    order = ytvos.traced_order(6, [{"objects": n} for n in (5, 1, 5, 2, 5, 5)],
                               dict(tr, trace_objects=5, trace_videos=2))
    assert order == [0, 2, 4, 1, 3, 5]


def test_batches_are_the_evaluators():
    tr = harness.load_cell(VB2).traffic
    groups = video_batch.batches(tr)
    assert sorted(i for g in groups for i in g) == list(range(len(tr["lengths"])))
    lengths = [tr["lengths"][i] for g in groups for i in g]
    assert lengths == sorted(lengths) and all(len(g) == tr["video_batch"] for g in groups)


def test_readers_of_the_slot_counters(monkeypatch):
    from swem_tpu_torch.utils import profiling

    rec = {"requests": 1, "request_s": 1.0, "counts": {},
           "spans": {"engine.inject": {"calls": 3, "self_s": 0.006}}}
    monkeypatch.setattr(profiling, "recorded",
                        lambda kind=None: rec if kind == "engine.video" else {"requests": 0})
    fill, inject = harness.reader("slot_fill.ytvos"), harness.reader("inject_host_ms.ytvos")
    # a program without the counters: no number
    assert fill.read({"units": 10}) is None and inject.read({"units": 10}) is None
    rec["counts"] = {"engine.slots": 80, "engine.active_slots": 50, "engine.injected": 2}
    assert fill.read({"units": 10}) == pytest.approx(62.5)
    assert inject.read({"units": 10}) == pytest.approx(0.6)
    rec["spans"] = {}
    assert inject.read({"units": 10}) == 0.0


@pytest.mark.parametrize("name,traffic", [(CELL, TINY_YTVOS), (VB2, TINY_VB2)],
                         ids=["ytvos", "vb2"])
def test_a_tiny_run_is_correct(name, traffic):
    res = tiny_run(name, traffic)
    assert res["correct"], res["compared"]
    assert set(res["metrics"]) == {"video_fps", "setup_s"}


def test_a_traced_tiny_run_reads_the_new_metrics():
    res = tiny_run(CELL, TINY_YTVOS, seconds=2.0, trace=True)
    assert res["correct"], res["compared"]
    assert 0 < res["metrics"]["slot_fill.ytvos"]["value"] < 100
    assert res["metrics"]["inject_host_ms.ytvos"]["value"] > 0
    assert res["metrics"]["mfu.ytvos"]["value"] > 0


@pytest.mark.parametrize("fault", ["empty", "late", "unmemorized"])
def test_a_lost_injection_is_not_correct(monkeypatch, fault):
    """The injected slot left empty at its injection frame (the slot joins
    ``active`` but its ground truth never reaches the map), or the
    injection one frame late: the new object's first answer is wrong. Or
    the new slot left out of the memorize at its injection frame (its map
    is right there, and the slot joins ``active`` from the next frame on):
    the first answers pass, the next frame's answer on the new object is
    wrong."""
    from swem_tpu_torch import engine
    from swem_tpu_torch.engine import ChunkedVideoRunner

    inject = engine._inject
    if fault == "empty":
        monkeypatch.setattr(engine, "_inject", lambda pred, active, mask, new: (pred, active | new))
    elif fault == "unmemorized":
        monkeypatch.setattr(engine, "_inject", lambda pred, active, mask, new:
                            (inject(pred, active, mask, new)[0], active))
    else:
        call = ChunkedVideoRunner.__call__

        def late(self, gen, frames, init_mask, active, injections=None, **kw):
            return call(self, gen, frames, init_mask, active,
                        {t + 1: v for t, v in (injections or {}).items()}, **kw)

        monkeypatch.setattr(ChunkedVideoRunner, "__call__", late)
    res = tiny_run(CELL, TINY_YTVOS)
    assert not res["correct"], res["compared"]
    first, after = res["compared"]["first_confident"], res["compared"]["inject_next_confident"]
    if fault == "unmemorized":
        assert first["value"] <= first["limit"] < after["limit"] < after["value"]
    else:
        assert first["value"] > 0.01


def test_an_altered_batched_answer_is_not_correct(monkeypatch):
    from swem_tpu_torch.engine import ChunkedVideoRunner

    call = ChunkedVideoRunner.__call__

    def altered(self, *a, **k):
        out = call(self, *a, **k)
        out[0] = (out[0] + 1) % 3
        return out

    monkeypatch.setattr(ChunkedVideoRunner, "__call__", altered)
    res = tiny_run(VB2, TINY_VB2)
    assert not res["correct"], res["compared"]
