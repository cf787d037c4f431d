"""The streaming session's CUDA graph of a push (``serve._PushGraph``).

On the CPU: the rule that decides which sessions capture a graph and which
pushes replay it (the capture itself stubbed out), and the resize taps
that the capture needs on the device, kept across calls. On the card
(marked ``card``, skipped without one): a graphed session against an eager
one with the same weights and bases, at bf16 and float32, map for map and
memory tensor for memory tensor, through an injection, a new ``start``, a
weight reload and two ``grow``s, one of them prepared, with K1 and K2
counted where they run: the profiler's records of the card's kernels.

This file imports no JAX, so that the card's tests run where JAX is not
installed: ``python -m pytest --noconftest -m card
tests/test_torch_port_serve_graph.py``.
"""

import re
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from swem_tpu_torch import serve
from swem_tpu_torch.config import ModelConfig
from swem_tpu_torch.models import em
from swem_tpu_torch.models.swem import SWEM
from swem_tpu_torch.ops import em_kernel, read_kernel, resize
from swem_tpu_torch.parallel.mesh import make_mesh2
from swem_tpu_torch.serve import StreamingSession, _memory, _memory_tensors
from swem_tpu_torch.utils import profiling

RAW, IN = (240, 427), (240, 432)
SPANS = ("serve.upload", "serve.replay", "serve.fetch", "engine.encode_keys", "engine.read",
         "engine.decode", "engine.inject", "engine.memorize", "engine.init_memory")


TINY, TINY_HW = ModelConfig(backbone="resnet18", num_bases=8, mdim=32), (32, 48)


def tiny_session(mesh=None) -> StreamingSession:
    """A CPU session of a resnet18 SWEM with two slots, at 32 x 48."""
    donor = SWEM(TINY, device="cpu").init_weights(0)
    return StreamingSession(TINY, donor.state_dict(), raw_hw=TINY_HW, in_size=TINY_HW,
                            out_size=TINY_HW, n_slots=2, device="cpu", mesh=mesh)


def tiny_frames(n: int):
    frames = (np.random.default_rng(0).random((n,) + TINY_HW + (3,)) * 255).astype(np.uint8)
    labels = np.zeros(TINY_HW, np.uint8)
    labels[4:16, 6:20], labels[18:28, 26:40] = 1, 2
    return frames, labels


@pytest.mark.parametrize("where, captures", [("cuda", True), ("cpu", False), ("mesh", False)])
def test_only_a_cuda_session_without_a_mesh_captures(monkeypatch, where, captures):
    """``_capture`` builds a graph on a CUDA device without a mesh and
    nothing elsewhere (the device is faked and the graph stubbed, so the
    rule runs without a card)."""
    mesh = make_mesh2(1, 2, devices=["cpu", "cpu"]) if where == "mesh" else None
    sess = tiny_session(mesh)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: "stream")
    monkeypatch.setattr(serve, "_PushGraph", lambda session, stream: ("graph", stream))
    if where != "cpu":
        sess.device = torch.device("cuda", 0)
    sess._capture()
    assert sess._graph == (("graph", "stream") if captures else None)


@pytest.mark.parametrize("case", ["unwarmed", "other frame size", "raw_hw"])
def test_a_held_graph_replays_only_raw_hw_frames(monkeypatch, case):
    """A push replays only while the session holds a graph (none before
    ``warmup``) and only for a frame at ``raw_hw``; any other push runs
    eagerly, today's path, and writes its memory into the graph's state
    tensors, so the next replay reads it."""
    frames, labels = tiny_frames(3)
    want = tiny_session()
    want.start(frames[0], labels)
    sess = tiny_session()
    sess.start(frames[0], labels)
    replays = []
    monkeypatch.setattr(sess, "_replay", lambda frame: replays.append(frame) or "replayed")
    frame = frames[1]
    if case != "unwarmed":
        sess._graph = types.SimpleNamespace(
            mem=_memory(t.clone() for t in _memory_tensors(sess._mem)),
            active=sess._active.clone())
    if case == "other frame size":
        frame = np.concatenate([frame, frame[:16]], axis=0)
        assert frame.shape != TINY_HW + (3,)
    got = sess.push(frame)
    if case == "raw_hw":
        assert got == "replayed" and replays[0] is frame
        return
    assert not replays
    np.testing.assert_array_equal(got, want.push(frame))
    if case == "other frame size":
        assert sess._mem is sess._graph.mem and sess._active is sess._graph.active
    for a, b in zip(_memory_tensors(sess._mem), _memory_tensors(want._mem)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method", ["nearest", "bilinear", "bicubic"])
def test_resize_keeps_its_taps(method):
    """A second resize at a shape reuses the first one's index and weight
    tensors (a capture copies nothing from the host), with the same bits
    as taps made afresh."""
    x = torch.rand((2, 3, 20, 30), generator=torch.Generator().manual_seed(0))
    x = x.to(torch.bfloat16)
    resize._kept.clear()
    first = resize.resize_nchw(x, (33, 17), method)
    kept = dict(resize._kept)
    assert kept
    again = resize.resize_nchw(x, (33, 17), method)
    assert all(resize._kept[k] is v for k, v in kept.items()) and len(resize._kept) == len(kept)
    resize._kept.clear()
    fresh = resize.resize_nchw(x, (33, 17), method)
    assert torch.equal(first, again) and torch.equal(first, fresh)


# ------------------------------------------------------------------------ #
# on the card

def weights(cfg: ModelConfig, seed: int) -> dict:
    """Seeded random weights, the key projection and the decoder's logit
    scaled down as the benchmark's are."""
    donor = SWEM(cfg, device="cpu").init_weights(seed)
    with torch.no_grad():
        donor.key_proj.key_proj.weight.mul_(0.003)
        donor.decoder.pred.weight.mul_(0.01)
    return donor.state_dict()


def clip(seed: int, T: int):
    """uint8 frames (T, *RAW, 3) of three boxes moving over noise; the label
    map of boxes 1 and 2 at frame 0 and the map of box 3 (both at RAW)."""
    rng = np.random.default_rng(seed)
    frames = (rng.random((T,) + RAW + (3,)) * 64).astype(np.uint8)
    colours = rng.integers(96, 256, (3, 3))
    corners = [(20, 30), (120, 200), (60, 320)]
    for t in range(T):
        for (y, x), c in zip(corners, colours):
            frames[t, y + t:y + t + 60, x + 2 * t:x + 2 * t + 80] = c
    labels, third = np.zeros(RAW, np.uint8), np.zeros(RAW, np.uint8)
    for n, (y, x) in enumerate(corners[:2]):
        labels[y:y + 60, x:x + 80] = n + 1
    y, x = corners[2]
    third[y + 10:y + 70, x + 20:x + 100] = 3
    return frames, labels, third


def draw(cfg: ModelConfig, seed: int, n_slots: int) -> em.Bases:
    return em.init_bases(torch.Generator().manual_seed(seed), 1, n_slots, cfg.keydim,
                         cfg.valdim, cfg.num_bases)


def assert_same_state(graphed: StreamingSession, eager: StreamingSession, where) -> None:
    for a, b in zip(_memory_tensors(graphed._mem), _memory_tensors(eager._mem)):
        assert torch.equal(a, b), where
    assert torch.equal(graphed._active, eager._active), where


def assert_flat(prof) -> None:
    evs = sorted((e for e in prof.events() if e.name in SPANS), key=lambda e: e.time_range.start)
    assert any(e.name == "serve.replay" for e in evs)
    for a, b in zip(evs, evs[1:]):
        assert a.time_range.end <= b.time_range.start, (a.name, b.name)


def replayed_push(session: StreamingSession, frame) -> np.ndarray:
    """``session.push(frame)`` under the profiler, held to a replay: no K1
    or K2 launch from the host, and one record of each kernel on the card."""
    host = em_kernel.launches, read_kernel.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = session.push(frame)
        torch.cuda.synchronize()
    assert (em_kernel.launches, read_kernel.launches) == host
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    ran = [sum(bool(re.search(rf"\b{k}\b", n)) for n in names)
           for k in ("em_loop_kernel", "read_kernel")]
    assert ran == [1, 1], ran
    return out


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_graphed_pushes_equal_eager_pushes(dtype):
    """40 steps: an ``add_objects`` of slot 3 at step 10, a new ``start`` at
    step 20, pushes elsewhere. The graphed session replays every push,
    launching no K1 or K2 from the host, and its maps and memory equal the
    eager session's bit for bit; three more replays, and each after a
    ``grow``, run one K1 and one K2 on the card by the profiler's kernel
    records; a weight reload after ``warmup`` is read by the next push, and
    ``grow(4)`` captures the grown push."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU counterpart")
    cfg = ModelConfig(dtype=dtype)
    frames, labels, third = clip(7, 49)

    def session():
        return StreamingSession(cfg, weights(cfg, 1), raw_hw=RAW, in_size=IN, out_size=RAW,
                                n_slots=3, seed=5, device="cuda")

    graphed, eager = session(), session()
    graphed.warmup()
    first_graph = graphed._graph
    assert first_graph is not None and eager._graph is None
    for s in (graphed, eager):
        s.start(frames[0], labels, bases=draw(cfg, 11, 3))
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for t in range(1, 41):
            if t == 10:
                got = [s.add_objects(frames[t], third, [3]) for s in (graphed, eager)]
            elif t == 20:
                for s in (graphed, eager):
                    s.start(frames[t], labels, bases=draw(cfg, 12, 3))
                assert_same_state(graphed, eager, t)
                continue
            else:
                k1, k2 = em_kernel.launches, read_kernel.launches
                g = graphed.push(frames[t])
                assert (em_kernel.launches, read_kernel.launches) == (k1, k2), t
                got = [g, eager.push(frames[t])]
            np.testing.assert_array_equal(got[0], got[1], err_msg=f"step {t}")
            assert_same_state(graphed, eager, t)
    counts = profiling.recorded("serve.push")["counts"]
    assert counts["serve.pushes"] == 2 * 38 and counts["serve.graph_replays"] == 38
    assert graphed._graph is first_graph
    assert_flat(prof)
    for t in (41, 42, 43):
        np.testing.assert_array_equal(replayed_push(graphed, frames[t]), eager.push(frames[t]))
        assert_same_state(graphed, eager, t)

    # a weight reload after warmup(): the next push recaptures and reads it
    new = weights(cfg, 2)
    for s in (graphed, eager):
        s.model.load_state_dict(new)
    got = [s.push(frames[44]) for s in (graphed, eager)]
    np.testing.assert_array_equal(got[0], got[1])
    assert_same_state(graphed, eager, "reload")
    assert graphed._graph is not first_graph and not graphed._graph.stale()

    # grow(4) captures the grown push on the caller's thread, after waiting
    # for a prepared warm-up of another size; grow(6) then joins that one
    before = graphed._graph
    graphed.prepare_grow(6)
    for s in (graphed, eager):
        s.grow(4, bases=draw(cfg, 13, 4))
    assert graphed._graph is not before and graphed._graph.active.shape == (1, 4)
    assert graphed._prepared is not None and not graphed._prepared.thread.is_alive()
    for t in (45, 46, 47, 48):
        if t == 47:
            for s in (graphed, eager):
                s.grow(6, bases=draw(cfg, 14, 6))
            assert graphed._prepared is None and graphed._graph.active.shape == (1, 6)
        np.testing.assert_array_equal(replayed_push(graphed, frames[t]), eager.push(frames[t]))
        assert_same_state(graphed, eager, f"grown {t}")
