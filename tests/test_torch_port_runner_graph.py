"""The video runner's CUDA graphs of the frame step (``engine._StepGraphs``),
cut at K2 and K1 (``utils/cuda_graphs.CutGraph``).

On the CPU: the rule that decides which runners capture (the device faked
and the capture stubbed), the rule that decides which calls replay, the
replayed step against the eager runner bit for bit with each ``CutGraph``
stood in by an eager one that writes into the capture's outputs (two
videos back to back, every chunk of the ladder, injections at a chunk's
first frame and inside a chunk, the final frame, a weight reload), the cut
itself over a stand-in CUDA graph, and the ``engine.steps`` and
``engine.graph_steps`` counters. On the card (marked ``card``, skipped
without one): graphed runners against eager ones with the same weights and
bases at bf16 and float32, K1 and K2 counted on the host and in the
profiler's records of the card's kernels.

This file imports no JAX, so that the card's tests run where JAX is not
installed: ``python -m pytest --noconftest -m card
tests/test_torch_port_runner_graph.py``.
"""

import contextlib
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from swem_tpu_torch import engine
from swem_tpu_torch.config import ModelConfig
from swem_tpu_torch.models import em
from swem_tpu_torch.models.swem import SWEM
from swem_tpu_torch.ops import em_kernel, read_kernel
from swem_tpu_torch.ops.resize import resize
from swem_tpu_torch.parallel.mesh import make_mesh2
from swem_tpu_torch.utils import cuda_graphs, profiling

TINY = ModelConfig(backbone="resnet18", keydim=16, valdim=32, num_bases=8, topl=4, mdim=16)
HW, CHUNK = (32, 48), 4
T = 8  # frames 1-7 run as chunks of 4, 2 and 1


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One PyTorch thread: the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return SWEM(TINY, device="cpu").init_weights(0)


def scaled(frames):
    return frames.float() / 255.0


def runner(model, **kw) -> engine.ChunkedVideoRunner:
    return engine.ChunkedVideoRunner(model, HW, chunk=CHUNK, preprocess=scaled, **kw)


def video(seed: int, B: int = 1, N: int = 2, hw=HW):
    """uint8 frames (T,B,*hw,3) of noise; a one-hot frame-0 mask of boxes 1
    and 2 (B,*hw,N+1); every slot but the first two inactive; the frame-3
    and frame-5 injections of slots 3 and 4 where N holds them."""
    rng = np.random.default_rng(seed)
    frames = (rng.random((T, B) + hw + (3,)) * 255).astype(np.uint8)
    labels = np.zeros((B,) + hw, np.uint8)
    labels[:, 2:14, 4:20], labels[:, 16:28, 24:40] = 1, 2
    mask = (labels[..., None] == np.arange(N + 1)).astype(np.float32)
    active = np.zeros((B, N), bool)
    active[:, :2] = True
    injections = {}
    for t, slot, (y, x) in ((3, 3, (4, 26)), (5, 4, (18, 6))):
        if slot <= N:
            idx = np.zeros((B,) + hw, np.uint8)
            idx[:, y:y + 10, x:x + 12] = slot
            new = np.zeros((B, N), bool)
            new[:, slot - 1] = True
            injections[t] = (idx, new)
    return frames, mask, active, injections


def bases(seed: int, B: int, N: int) -> em.Bases:
    return em.init_bases(torch.Generator().manual_seed(seed), B, N, TINY.keydim, TINY.valdim,
                         TINY.num_bases)


class EagerCut:
    """``cuda_graphs.CutGraph`` on the CPU: a replay runs the function again
    and writes what it returns into the capture's outputs, the tensors a
    replay of the graphs rewrites."""

    def __init__(self, fn, pool):
        self.fn, self.outputs = fn, fn()

    def replay(self):
        out = self.fn()
        if isinstance(out, torch.Tensor):
            self.outputs.copy_(out)
        elif out is not None:
            for dst, src in zip(self.outputs, out):
                dst.copy_(src)


@contextlib.contextmanager
def no_stream(stream):
    yield None


def graphed(monkeypatch, r: engine.ChunkedVideoRunner, B: int, N: int):
    """Give CPU runner ``r`` the step graphs of (B, N) at ``HW``, each
    ``CutGraph`` an ``EagerCut``; record each replayed step's
    (do_memorize, injecting) in the returned list."""
    monkeypatch.setattr(cuda_graphs, "CutGraph", EagerCut)
    monkeypatch.setattr(cuda_graphs, "capturing", no_stream)
    frame = scaled(torch.zeros((B,) + HW + (3,), dtype=torch.uint8))
    active = torch.zeros((B, N), dtype=torch.bool)
    mem = engine.init_memory(r.model, torch.Generator().manual_seed(0), frame,
                             torch.zeros((B,) + HW + (N + 1,)), active)
    with torch.no_grad():
        graphs = engine._StepGraphs(r.model, r.out_size, r.scores, frame, active, mem, None)
    steps = []

    def step(*args, inject_mask=None, inject_new=None):
        steps.append((args[7], inject_mask is not None))
        return engine._StepGraphs.step(graphs, *args, inject_mask=inject_mask,
                                       inject_new=inject_new)

    graphs.step = step
    r._graphs[engine._graph_key(frame, active)] = graphs
    return steps


@pytest.mark.parametrize("where, captures", [("cuda", True), ("cpu", False), ("mesh", False)])
def test_only_a_cuda_runner_without_a_mesh_captures(monkeypatch, model, where, captures):
    """``_capture`` keeps step graphs on a CUDA device without a mesh and
    nothing elsewhere (the device is faked and the graphs stubbed, so the
    rule runs without a card)."""
    mesh = make_mesh2(1, 2, devices=["cpu", "cpu"]) if where == "mesh" else None
    r = runner(model, mesh=mesh)
    made = []
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: "stream")
    monkeypatch.setattr(engine, "_StepGraphs", lambda *a: made.append(a) or "graphs")
    frame, active = torch.zeros((1,) + HW + (3,)), torch.zeros((1, 2), dtype=torch.bool)
    if where != "cpu":
        monkeypatch.setattr(model, "device", torch.device("cuda", 0))
    r._capture(frame, active, "mem")
    if not captures:
        assert r._graphs == {} and not made
        return
    assert r._graphs == {((1,) + HW + (3,), torch.float32, 2): "graphs"}
    assert made == [(model, HW, False, frame, active, "mem", "stream")]


def test_warmup_captures_its_shape(monkeypatch, model):
    """``warmup`` hands ``_capture`` one preprocessed frame of the warmed
    batch and size, and its slot count, after its eager chunks."""
    r = runner(model, scores=True)
    seen = []
    monkeypatch.setattr(r, "_capture", lambda frame, active, mem: seen.append(
        (frame.shape, frame.dtype, active.shape, mem.update.kappa.shape)))
    r.warmup((16, 32), 2, 3, np.uint8)
    assert seen == [((2, 16, 32, 3), torch.float32, (2, 3), (2, 3, 2, TINY.keydim,
                                                              TINY.num_bases))]


@pytest.mark.parametrize("case", ["warmed", "unwarmed", "other size", "other batch",
                                  "other slot count"])
def test_only_a_call_at_the_warmed_shape_replays(monkeypatch, model, case):
    """A call replays every frame only at the shape the graphs were captured
    at (batch 1, 2 slots, ``HW``); an unwarmed runner and any other input
    size, batch or slot count run eagerly. Either way the maps equal the
    eager runner's bit for bit."""
    r = runner(model)
    steps = [] if case == "unwarmed" else graphed(monkeypatch, r, 1, 2)
    B = 2 if case == "other batch" else 1
    N = 3 if case == "other slot count" else 2
    hw = (48, 32) if case == "other size" else HW
    frames, mask, active, _ = video(1, B, N, hw)
    want = runner(model)(None, frames, mask, active, bases=bases(2, 1, N))
    got = r(None, frames, mask, active, bases=bases(2, 1, N))
    np.testing.assert_array_equal(got, want)
    if case == "warmed":
        assert steps == [(True, False)] * (T - 2) + [(False, False)]
    else:
        assert steps == []


@pytest.mark.parametrize("scores", [False, True])
def test_replayed_steps_equal_the_eager_steps(monkeypatch, model, scores):
    """Two injectable videos back to back at the warmed shape (4 slots):
    every frame replays; the frames of the injections (frame 3 inside the
    first chunk, frame 5 first of the second) inject between the decode's
    replay and the memorize's; the last frame memorizes nothing. Each
    video's memory is copied into the graphs' state at its first step, and
    the predictions equal the eager runner's bit for bit, scores too; then a
    weight reload makes the next call recapture, and read the new weights."""
    r, eager = runner(model, scores=scores, injectable=True), runner(model, scores=scores,
                                                                     injectable=True)
    steps = graphed(monkeypatch, r, 1, 4)
    first = r._graphs[next(iter(r._graphs))]
    for seed in (3, 4):
        frames, mask, active, injections = video(seed, 1, 4)
        args = (None, frames, mask, active, injections)
        got, want = r(*args, bases=bases(seed, 1, 4)), eager(*args, bases=bases(seed, 1, 4))
        torch.testing.assert_close(torch.as_tensor(got), torch.as_tensor(want), rtol=0, atol=0)
        assert steps == [(True, t in injections) for t in range(1, T - 1)] + [(False, False)]
        steps.clear()

    state = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        with torch.no_grad():
            model.decoder.pred.weight.mul_(1.5)
        assert first.stale()
        got, want = r(*args, bases=bases(5, 1, 4)), eager(*args, bases=bases(5, 1, 4))
        torch.testing.assert_close(torch.as_tensor(got), torch.as_tensor(want), rtol=0, atol=0)
        again = r._graphs[next(iter(r._graphs))]
        assert again is not first and not again.stale() and len(r._graphs) == 1
    finally:
        model.load_state_dict(state)


def test_step_counters(monkeypatch, model):
    """Traced, a runner call counts ``engine.steps``, its T - 1 frames, and
    ``engine.graph_steps``, the frames it replayed: all of a call at the
    warmed shape, none of another; untraced, it records nothing."""
    r = runner(model)
    graphed(monkeypatch, r, 1, 2)
    warmed, other = video(6), video(6, 2)

    def call(v):
        frames, mask, active, _ = v
        return r(None, frames, mask, active, bases=bases(6, 1, 2))

    profiling.reset()
    call(warmed)
    assert profiling.recorded() == {"requests": 0, "request_s": 0.0, "spans": {}, "counts": {}}
    for v, replayed in ((warmed, T - 1), (other, 0)):
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            call(v)
        counts = profiling.recorded("engine.video")["counts"]
        assert counts["engine.steps"] == T - 1
        assert counts.get("engine.graph_steps", 0) == replayed


class FakeGraph:
    """A stand-in for ``torch.cuda.CUDAGraph`` that logs its calls."""
    log = []

    def capture_begin(self, pool=None):
        self.log.append(("begin", id(self), pool))

    def capture_end(self):
        self.log.append(("end", id(self)))

    def replay(self):
        self.log.append(("replay", id(self)))


def test_a_cut_graph_launches_its_kernels_between_replays(monkeypatch):
    """``kernel`` cuts the capture: the graph before it ends and runs, the
    kernel runs eagerly on the capture's tensors, the next graph begins in
    the same pool. A replay runs the graphs in turn and launches each kernel
    between them on the same argument tensors, its outputs copied into the
    ones the capture got. Outside a capture ``kernel`` is the call itself."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    FakeGraph.log = []
    calls = []

    def k(x, *, scale):
        calls.append(x)
        return x * scale, x + scale

    x = torch.arange(3.0)
    assert torch.equal(cuda_graphs.kernel(k, x, scale=2.0)[0], x * 2.0) and calls == [x]

    def fn():
        y, z = cuda_graphs.kernel(k, x, scale=2.0)
        return y, z

    calls.clear()
    g = cuda_graphs.CutGraph(fn, "pool")
    a, b = (e[1] for e in FakeGraph.log if e[0] == "begin")
    assert [e[0] for e in FakeGraph.log] == ["begin", "end", "replay", "begin", "end", "replay"]
    assert FakeGraph.log[0][2] == FakeGraph.log[3][2] == "pool" and a != b
    assert len(calls) == 1 and calls[0] is x
    y, z = g.outputs
    FakeGraph.log.clear()
    x.add_(10.0)  # what the graph before the kernel would rewrite
    g.replay()
    assert FakeGraph.log == [("replay", a), ("replay", b)]
    assert len(calls) == 2 and calls[1] is x
    assert torch.equal(y, x * 2.0) and torch.equal(z, x + 2.0)
    assert cuda_graphs._capture.graph is None


# ------------------------------------------------------------------------ #
# on the card

RAW, IN = (240, 427), (240, 432)


def weights(cfg: ModelConfig, seed: int) -> dict:
    """Seeded random weights, the key projection and the decoder's logit
    scaled down as the benchmark's are."""
    donor = SWEM(cfg, device="cpu").init_weights(seed)
    with torch.no_grad():
        donor.key_proj.key_proj.weight.mul_(0.003)
        donor.decoder.pred.weight.mul_(0.01)
    return donor.state_dict()


def clip(seed: int, n: int, n_objs: int):
    """uint8 frames (n, 1, *RAW, 3) of boxes moving over noise; a one-hot
    frame-0 mask of boxes 1 and 2 (1, *RAW, n_objs+1)."""
    rng = np.random.default_rng(seed)
    frames = (rng.random((n, 1) + RAW + (3,)) * 64).astype(np.uint8)
    colours = rng.integers(96, 256, (4, 3))
    corners = [(20, 30), (120, 200), (60, 320), (150, 40)]
    for t in range(n):
        for (y, x), c in zip(corners, colours):
            frames[t, 0, y + t:y + t + 60, x + 2 * t:x + 2 * t + 80] = c
    labels = np.zeros((1,) + RAW, np.uint8)
    for k, (y, x) in enumerate(corners[:2]):
        labels[0, y:y + 60, x:x + 80] = k + 1
    return frames, (labels[..., None] == np.arange(n_objs + 1)).astype(np.float32)


def box(slot: int, y: int, x: int):
    idx = np.zeros((1,) + RAW, np.uint8)
    idx[0, y:y + 60, x:x + 80] = slot
    return idx


def card_runner(model, **kw):
    return engine.ChunkedVideoRunner(model, RAW, chunk=16, preprocess=lambda f: resize(
        f.float() / 255.0, IN, "bicubic"), **kw)


def kernel_records(prof) -> list:
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return [sum(bool(re.search(rf"\b{k}\b", n)) for n in names)
            for k in ("em_loop_kernel", "read_kernel")]


def counted(r, *args, **kw):
    """A runner call under the profiler -> (maps, host launches of K1 and
    K2, their records on the card)."""
    host = em_kernel.launches, read_kernel.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = r(*args, **kw)
        torch.cuda.synchronize()
    launched = [em_kernel.launches - host[0], read_kernel.launches - host[1]]
    return np.asarray(torch.as_tensor(out).cpu()), launched, kernel_records(prof)


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_graphed_runner_equals_the_eager_runner(dtype):
    """Warmed CUDA runners replay every frame and equal eager (unwarmed)
    runners with the same weights and bases bit for bit: two 32-frame
    videos back to back (chunk 16 and the ladder 8, 4, 2, 1, the last frame
    not memorized); a 4-slot injectable runner with objects injected at
    frame 17 (a chunk's first) and frame 20 (inside a chunk); a weight
    reload, which the next call recaptures. K1 and K2 launch from the host
    as often as in the eager runner, T - 1 each a call, and each launch is
    one record of its kernel on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU counterpart")
    cfg = ModelConfig(dtype=dtype)
    model = SWEM(cfg, device="cuda")
    model.load_state_dict(weights(cfg, 1))
    n = 32

    def draw(seed, N):
        return em.init_bases(torch.Generator().manual_seed(seed), 1, N, cfg.keydim, cfg.valdim,
                             cfg.num_bases)

    graphed, eager = card_runner(model), card_runner(model)
    graphed.warmup(RAW, 1, 2, np.uint8)
    assert len(graphed._graphs) == 1 and not eager._graphs
    first = next(iter(graphed._graphs.values()))
    for seed in (7, 8):
        frames, mask = clip(seed, n, 2)
        args = (None, frames, mask, np.ones((1, 2), bool))
        g, g_host, g_card = counted(graphed, *args, bases=draw(seed, 2))
        e, e_host, e_card = counted(eager, *args, bases=draw(seed, 2))
        np.testing.assert_array_equal(g, e, err_msg=f"video {seed}")
        assert g_host == e_host == [n - 1, n - 1] and g_card == e_card == g_host, (g_host, g_card)
    assert next(iter(graphed._graphs.values())) is first

    inj_g, inj_e = (card_runner(model, injectable=True) for _ in range(2))
    inj_g.warmup(RAW, 1, 4, np.uint8)
    frames, mask = clip(9, n, 4)
    new3, new4 = np.zeros((1, 4), bool), np.zeros((1, 4), bool)
    new3[0, 2], new4[0, 3] = True, True
    injections = {17: (box(3, 60, 320), new3), 20: (box(4, 150, 40), new4)}
    active = np.asarray([[True, True, False, False]])
    args = (None, frames, mask, active, injections)
    g, g_host, g_card = counted(inj_g, *args, bases=draw(9, 4))
    e, e_host, e_card = counted(inj_e, *args, bases=draw(9, 4))
    np.testing.assert_array_equal(g, e)
    assert g_host == e_host == g_card == e_card == [n - 1, n - 1]
    assert (g[16] == 3).any() and (g[19] == 4).any()

    model.load_state_dict(weights(cfg, 2))
    frames, mask = clip(10, n, 2)
    args = (None, frames, mask, np.ones((1, 2), bool))
    g, _, _ = counted(graphed, *args, bases=draw(10, 2))
    e, _, _ = counted(eager, *args, bases=draw(10, 2))
    np.testing.assert_array_equal(g, e)
    again = next(iter(graphed._graphs.values()))
    assert again is not first and not again.stale()
