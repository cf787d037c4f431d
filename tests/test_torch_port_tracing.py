"""The port's stage spans and parameter-preparation counter
(``swem_tpu_torch.utils.profiling``) on the CPU, with the tiny model.

Without a profiler nothing is recorded. Under ``torch.profiler`` a runner
call and a push record each stage the number of times it runs (an
injecting runner ``engine.inject`` too, and every runner call the slot
counters: slots stepped, slots live, objects injected), as host ops
of the profiler's run that are not user annotations and never nest or
overlap; the predictions are the same bits either way; and the count read
off the module tree (in bf16 every kernel and bias cast and every
batch-norm fold, in float32 the folds alone) splits, on the first push
after the weights change, into ``models.param_preps`` (each module's first
call) and ``models.param_cache_hits`` (its repeats), and is all
``models.param_cache_hits`` on the next push, which prepares nothing.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from swem_tpu_torch import engine
from swem_tpu_torch.models import layers, resnet
from swem_tpu_torch.models.swem import SWEM
from swem_tpu_torch.parallel import make_mesh2
from swem_tpu_torch.serve import StreamingSession
from swem_tpu_torch.utils import profiling
from _torch_port_util import port_cfg, tiny_pair
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse fixture)
from test_model import tiny_cfg

HW = (64, 64)
T, CHUNK = 7, 4  # chunks of 4 and 2 frames
STAGES = ("engine.upload", "engine.init_memory", "engine.encode_keys", "engine.read",
          "engine.decode", "engine.inject", "engine.memorize", "engine.fetch", "serve.upload",
          "serve.replay", "serve.fetch")
SLOTS = ("engine.slots", "engine.active_slots", "engine.injected")


@pytest.fixture(scope="module")
def port():
    return tiny_pair(seed=4)[2]


def video(seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.random((T, 1) + HW + (3,)).astype(np.float32)
    mask = np.zeros((1,) + HW + (3,), np.float32)
    mask[..., 0] = 1.0
    for n, (y, x) in enumerate([(8, 8), (30, 34)]):
        mask[0, y:y + 14, x:x + 14] = np.eye(3, dtype=np.float32)[n + 1]
    return frames, mask, np.ones((1, 2), bool)


def stream(seed=1, n=3):
    rng = np.random.default_rng(seed)
    labels = np.zeros(HW, np.uint8)
    labels[8:22, 8:22] = 1
    labels[30:44, 34:48] = 2
    return (rng.random((n,) + HW + (3,)) * 255).astype(np.uint8), labels


def session(model):
    return StreamingSession(model.cfg, model.state_dict(), raw_hw=HW, in_size=HW, out_size=HW,
                            n_slots=2, seed=3, device="cpu")


def run_video(model, **kw):
    frames, mask, active = video()
    runner = engine.ChunkedVideoRunner(model, HW, chunk=CHUNK, **kw)
    return runner(torch.Generator().manual_seed(0), frames, mask, active)


def injected_video():
    """``video`` in a bucket of 4 slots: slots 1 and 2 at frame 0, slot 3
    injected at frame 3 (inside the first chunk) and slot 4 at frame 5 (the
    first frame of the second)."""
    frames, mask, _ = video()
    mask = np.concatenate([mask, np.zeros(mask.shape[:-1] + (2,), np.float32)], axis=-1)
    active = np.array([[True, True, False, False]])
    injections = {}
    for t, slot, (y, x) in ((3, 3, (40, 6)), (5, 4, (4, 44))):
        idx = np.zeros((1,) + HW, np.uint8)
        idx[0, y:y + 12, x:x + 12] = slot
        new = np.zeros((1, 4), bool)
        new[0, slot - 1] = True
        injections[t] = (idx, new)
    return frames, mask, active, injections


def run_injected(model, **kw):
    frames, mask, active, injections = injected_video()
    runner = engine.ChunkedVideoRunner(model, HW, chunk=CHUNK, injectable=True, **kw)
    return runner(torch.Generator().manual_seed(0), frames, mask, active, injections)


def traced(fn):
    """(fn's result, the profiler's run) with the record cleared first."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def stage_events(prof):
    return sorted((e for e in prof.events() if e.name in STAGES),
                  key=lambda e: e.time_range.start)


def calls(rec):
    return {k: v["calls"] for k, v in rec["spans"].items()}


def assert_flat(prof):
    """No stage span inside or across another, on the profiler's clock."""
    evs = stage_events(prof)
    assert evs
    for a, b in zip(evs, evs[1:]):
        assert a.time_range.end <= b.time_range.start, (a.name, b.name)


def test_tracing_follows_the_profiler():
    assert not profiling.tracing()
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.tracing()
    assert not profiling.tracing()


def test_untraced_calls_record_nothing(port, monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name} built with tracing off")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    profiling.reset()
    run_video(port)
    frames, labels = stream()
    sess = session(port)
    sess.start(frames[0], labels)
    sess.push(frames[1])
    assert profiling.recorded() == {"requests": 0, "request_s": 0.0, "spans": {}, "counts": {}}


def test_runner_call_records_each_stage(port):
    _, prof = traced(lambda: run_video(port))
    rec = profiling.recorded("engine.video")
    assert rec["requests"] == 1
    assert calls(rec) == {"engine.upload": 3, "engine.init_memory": 1,
                          "engine.encode_keys": 2, "engine.read": T - 1,
                          "engine.decode": T - 1, "engine.memorize": T - 2, "engine.fetch": 1}
    # the stage spans cover the call but for Python's call overhead
    covered = sum(v["self_s"] for v in rec["spans"].values())
    assert 0.9 * rec["request_s"] <= covered <= rec["request_s"]
    profiled = Counter(e.name for e in stage_events(prof))
    assert profiled == Counter(calls(rec))
    assert not any(e.is_user_annotation for e in stage_events(prof))
    # requests stay out of the profiler's run
    assert not any(e.name == "engine.video" for e in prof.events())
    assert_flat(prof)


def test_push_records_each_stage_once(port):
    frames, labels = stream()
    sess = session(port)

    def start_and_push():
        sess.start(frames[0], labels)
        return sess.push(frames[1])

    _, prof = traced(start_and_push)
    push = profiling.recorded("serve.push")
    assert push["requests"] == 1
    assert calls(push) == {"serve.upload": 1, "engine.encode_keys": 1, "engine.read": 1,
                           "engine.decode": 1, "engine.memorize": 1, "serve.fetch": 1}
    start = profiling.recorded("serve.start")
    assert calls(start) == {"serve.upload": 1, "engine.init_memory": 1}
    assert not any(e.is_user_annotation for e in stage_events(prof))
    assert_flat(prof)


def test_warmed_cpu_session_pushes_eagerly(port):
    """A warmed session on the CPU captures no graph: its pushes are today's
    eager pushes, map for map, and count as pushes, none as a replay; with
    tracing off nothing is recorded."""
    frames, labels = stream(n=4)
    plain = session(port)
    plain.start(frames[0], labels)
    want = [plain.push(f) for f in frames[1:]]
    sess = session(port)
    sess.warmup()
    assert sess._graph is None
    sess.start(frames[0], labels)
    profiling.reset()
    got = [sess.push(frames[1])]
    assert profiling.recorded() == {"requests": 0, "request_s": 0.0, "spans": {}, "counts": {}}
    more, _ = traced(lambda: [sess.push(f) for f in frames[2:]])
    np.testing.assert_array_equal(np.stack(got + more), np.stack(want))
    push = profiling.recorded("serve.push")
    assert push["counts"].get("serve.pushes") == 2
    assert "serve.graph_replays" not in push["counts"]
    assert "serve.replay" not in push["spans"]


def test_object_sharded_runner_keeps_the_stages_flat(port):
    mesh = make_mesh2(1, 2, devices=["cpu", "cpu"])
    _, prof = traced(lambda: run_video(port, mesh=mesh))
    got = calls(profiling.recorded("engine.video"))
    # per frame: each of the 2 shards reads its objects, and the grid's one
    # row decodes them and aggregates the gathered ones in one decode span
    assert got["engine.read"] == 2 * (T - 1)
    assert got["engine.decode"] == T - 1
    assert got["engine.memorize"] == 2 * (T - 2)
    assert got["engine.encode_keys"] == 2 and got["engine.init_memory"] == 1
    assert_flat(prof)


def test_predictions_are_the_same_bits_traced(port):
    off = run_video(port)
    on, _ = traced(lambda: run_video(port))
    np.testing.assert_array_equal(on, off)
    frames, labels = stream(n=4)
    maps = []
    for trace in (False, True):
        sess = session(port)
        sess.start(frames[0], labels)
        push = lambda: [sess.push(f) for f in frames[1:]]  # noqa: E731
        maps.append(traced(push)[0] if trace else push())
    np.testing.assert_array_equal(np.stack(maps[0]), np.stack(maps[1]))


def module_tree_preps(model, fn):
    """Parameter tensors that ``fn`` prepares or reuses, read off the module
    tree: at a compute dtype other than the parameters' float32, every
    kernel and bias of each conv and linear call (the stem conv's bias where
    its call adds it), and one fold per batch-norm call. Returns (that
    count, the part of it from each module's (and stem part's) first call)."""
    n, first, seen = [0], [0], set()
    cast = model.cfg.dtype != "float32"
    hooks, stems = [], []

    def add(k, key):
        n[0] += k
        if key not in seen:
            seen.add(key)
            first[0] += k

    for m in model.modules():
        if isinstance(m, layers.FrozenBatchNorm):
            hooks.append(m.register_forward_pre_hook(lambda m, _: add(1, m)))
        elif isinstance(m, (layers.Conv2d, layers.Linear)) and cast:
            k = 1 + (m.bias is not None)
            hooks.append(m.register_forward_pre_hook(lambda m, _, k=k: add(k, m)))
        elif isinstance(m, resnet.StemConv) and cast:
            def conv(x, part, with_bias, m=m, orig=m._conv):
                add(1 + (with_bias and m.bias is not None), (m, part))
                return orig(x, part, with_bias)

            m._conv = conv
            stems.append(m)
    try:
        fn()
    finally:
        for h in hooks:
            h.remove()
        for m in stems:
            del m._conv
    return n[0], first[0]


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_preps_equal_the_module_tree(dtype, warm):
    """Cold: the first push after ``load_state_dict`` prepares each module's
    parameter tensors on its first call and reuses them on the next ones
    (the channel gate's MLP runs twice). Warm: the next push prepares none
    and reuses them all."""
    model = SWEM(port_cfg(tiny_cfg(dtype=dtype)), device="cpu").init_weights(5)
    frames, labels = stream()
    sess = session(model)
    sess.start(frames[0], labels)
    sess.model.load_state_dict(model.state_dict())  # new versions: every kept tensor misses
    if warm:
        sess.push(frames[1])
    want, first = module_tree_preps(sess.model,
                                    lambda: traced(lambda: sess.push(frames[1 + warm])))
    counts = profiling.recorded("serve.push")["counts"]
    got = counts.get("models.param_preps", 0), counts.get("models.param_cache_hits", 0)
    assert got == ((0, want) if warm else (first, want - first))
    assert want >= first > 0


def test_reset_empties_the_record(port):
    traced(lambda: run_video(port))
    assert profiling.recorded()["spans"]
    profiling.reset()
    assert profiling.recorded() == {"requests": 0, "request_s": 0.0, "spans": {}, "counts": {}}


def test_untraced_injection_records_nothing(port, monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name} built with tracing off")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    profiling.reset()
    run_injected(port)
    assert profiling.recorded() == {"requests": 0, "request_s": 0.0, "spans": {}, "counts": {}}


@pytest.mark.parametrize("sharded", [False, True], ids=["one_device", "obj_grid"])
def test_slot_counters_follow_the_injections(port, sharded):
    kw = dict(mesh=make_mesh2(1, 2, devices=["cpu", "cpu"])) if sharded else {}
    off = run_injected(port, **kw)
    on, prof = traced(lambda: run_injected(port, **kw))
    np.testing.assert_array_equal(on, off)
    rec = profiling.recorded("engine.video")
    # 4 slots stepped on each of the T - 1 frames; 2 live on frames 1-2, 3 from
    # the injection at frame 3, 4 from the one at frame 5
    assert {k: rec["counts"][k] for k in SLOTS} == {
        "engine.slots": 4 * (T - 1), "engine.injected": 2,
        "engine.active_slots": 2 * 2 + 3 * 2 + 4 * (T - 5)}
    # each injecting chunk's host block, and each injecting frame's upload and
    # overwrite (on every shard of the grid)
    assert calls(rec)["engine.inject"] == 2 + 2 + 2 * (2 if sharded else 1)
    assert calls(rec)["engine.decode"] == T - 1
    assert_flat(prof)


def test_davis_shaped_runs_inject_nothing(port):
    traced(lambda: run_video(port))
    rec = profiling.recorded("engine.video")
    assert "engine.inject" not in rec["spans"]
    assert {k: v for k, v in rec["counts"].items() if k in SLOTS} == {
        "engine.slots": 2 * (T - 1), "engine.active_slots": 2 * (T - 1)}
