"""The port's streaming session against swem_tpu's, and the TF32 scope
across threads, on the CPU.

Both packages run the same tiny model (seeded weights carried across by the
weight bridge) on the same uint8 frames, with the JAX package's draws of
initial bases handed to the port's ``start`` and ``grow``. The JAX session
runs op by op (``jax.disable_jit``, see ``test_torch_port_runner.py``);
index maps are held at >= 99.9% of pixels per frame.
"""

import dataclasses
import threading

import numpy as np
import jax
import pytest
import torch

from swem_tpu.serve import StreamingSession as JaxSession
from swem_tpu_torch import engine
from swem_tpu_torch.config import full_float32
from swem_tpu_torch.models import em
from swem_tpu_torch.serve import StreamingSession, measure_device_latency, measure_latency
from _torch_port_util import jax_bases, tiny_pair

IN = OUT = (64, 64)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=2, max_objs=3)


def stream(seed, T, raw=IN):
    """uint8 frames (T,H,W,3), a label map with objects 1 and 2, and the
    ground truth of object 3 as a label map."""
    rng = np.random.default_rng(seed)
    frames = (rng.random((T,) + raw + (3,)) * 255).astype(np.uint8)
    labels = np.zeros(OUT, np.uint8)
    labels[8:20, 8:20] = 1
    labels[28:40, 28:40] = 2
    third = np.zeros(OUT, np.uint8)
    third[46:60, 44:60] = 3
    return frames, labels, third


def session(pair, n_slots=3, raw=IN, **kw):
    _, _, port = pair
    return StreamingSession(port.cfg, port.state_dict(), raw_hw=raw, in_size=IN, out_size=OUT,
                            n_slots=n_slots, device="cpu", **kw)


def jax_session(pair, n_slots=3, raw=IN):
    model, variables, _ = pair
    return JaxSession(dataclasses.replace(model.cfg, max_objs=n_slots), variables, raw_hw=raw,
                      in_size=IN, out_size=OUT, seed=0)


def assert_frames_agree(got, ref, label):
    for f, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape == OUT and g.dtype == np.uint8
        agree = float((g == r).mean())
        assert agree >= 0.999, (label, f, agree)


def test_push_is_init_memory_and_step(pair):
    """``start`` + ``push`` are the engine's ``init_memory`` + ``step`` on the
    normalized frames and the session's seeded draw, bit for bit."""
    _, _, port = pair
    frames, labels, _ = stream(1, 4)
    sess = session(pair, seed=5)
    sess.warmup()
    sess.start(frames[0], labels)
    got = [sess.push(f) for f in frames[1:]]
    assert sess.frames_seen == 4

    x = torch.from_numpy(frames).float() / 255.0
    onehot = torch.from_numpy(np.eye(4, dtype=np.float32)[labels])[None]
    active = torch.tensor([[True, True, False]])
    cfg = port.cfg
    bases = em.init_bases(torch.Generator().manual_seed(5), 1, 3, cfg.keydim, cfg.valdim,
                          cfg.num_bases)
    mem = engine.init_memory(port, None, x[:1], onehot, active, bases=bases)
    for f in range(1, 4):
        mem, pred, _ = engine.step(port, mem, x[f:f + 1], active, OUT)
        np.testing.assert_array_equal(got[f - 1], pred[0].numpy())


@pytest.mark.parametrize("raw", [IN, (32, 32)], ids=["raw = in_size", "raw 32x32 -> 64x64"])
def test_session_matches_jax(pair, raw):
    """start, push, add_objects (object 3 appears at frame 2), push."""
    model, _, _ = pair
    frames, labels, third = stream(2, 5, raw)
    ref_sess = jax_session(pair, raw=raw)
    with jax.disable_jit():
        ref_sess.start(frames[0], labels)
        ref = [ref_sess.push(frames[1]), ref_sess.add_objects(frames[2], third, [3]),
               ref_sess.push(frames[3]), ref_sess.push(frames[4])]
    sess = session(pair, raw=raw)
    sess.start(frames[0], labels, bases=jax_bases(model.cfg, jax.random.PRNGKey(0)))
    got = [sess.push(frames[1]), sess.add_objects(frames[2], third, [3]),
           sess.push(frames[3]), sess.push(frames[4])]
    assert (got[1][third > 0] == 3).all() and (ref[1][third > 0] == 3).all()
    assert not (got[0] == 3).any()
    assert_frames_agree(got, ref, raw)


def test_grow_without_injection_is_exact_noop(pair):
    """Carried bases keep their bits and the new slots are exact EM no-ops."""
    frames, labels, _ = stream(3, 5)
    base = session(pair, n_slots=2)
    base.start(frames[0], labels)
    want = [base.push(f) for f in frames[1:]]
    grown = session(pair, n_slots=2)
    grown.start(frames[0], labels)
    got = [grown.push(frames[1])]
    grown.grow(4)
    assert grown.n_slots == 4 and grown.cfg.max_objs == 4
    got += [grown.push(f) for f in frames[2:]]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def test_grow_then_inject_matches_jax(pair):
    """Two slots, push, grow to 3 with both draws handed in, inject object 3."""
    model, _, _ = pair
    frames, labels, third = stream(4, 5)
    ref_sess = jax_session(pair, n_slots=2)
    with jax.disable_jit():
        ref_sess.start(frames[0], labels)
        ref = [ref_sess.push(frames[1])]
        ref_sess.grow(3)
        ref += [ref_sess.add_objects(frames[2], third, [3]), ref_sess.push(frames[3]),
                ref_sess.push(frames[4])]
    sess = session(pair, n_slots=2)
    key = jax.random.PRNGKey(0)
    sess.start(frames[0], labels, bases=jax_bases(model.cfg, key, 2))
    got = [sess.push(frames[1])]
    # the JAX session draws the new slots from fold_in(key, frames seen)
    sess.grow(3, bases=jax_bases(model.cfg, jax.random.fold_in(key, 2), 3))
    got += [sess.add_objects(frames[2], third, [3]), sess.push(frames[3]),
            sess.push(frames[4])]
    assert (got[1][third > 0] == 3).all()
    assert_frames_agree(got, ref, "grow")


def test_prepare_grow_equals_inline_grow(pair):
    """A prepared grow gives the inline grow's stream bit for bit. A grow of
    another size keeps the prepared warm-up, and a later grow to the
    prepared size joins it; a failure on the thread is raised from grow."""
    frames, labels, third = stream(5, 5)

    def run(prepare, sizes):
        sess = session(pair, n_slots=2)
        sess.start(frames[0], labels)
        if prepare:
            sess.prepare_grow(prepare)
        preds = [sess.push(frames[1])]
        for i, n in enumerate(sizes):
            sess.grow(n)
            if prepare and n != prepare:
                assert sess._prepared is not None and sess._prepared.n_slots == prepare
            preds.append(sess.add_objects(frames[2 + i], third, [3]))
        assert sess._prepared is None or not prepare
        preds.append(sess.push(frames[4]))
        return np.stack(preds)

    np.testing.assert_array_equal(run(4, [4]), run(None, [4]))
    np.testing.assert_array_equal(run(8, [4, 8]), run(None, [4, 8]))

    sess = session(pair, n_slots=2)
    sess.start(frames[0], labels)

    def broken(n_slots):
        raise MemoryError("warm-up failed")

    sess._warm = broken
    sess.prepare_grow(3)
    with pytest.raises(RuntimeError, match="prepare_grow") as err:
        sess.grow(3)
    assert isinstance(err.value.__cause__, MemoryError)


def test_bad_calls_raise(pair):
    frames, labels, _ = stream(6, 2)
    sess = session(pair)
    with pytest.raises(RuntimeError, match="start"):
        sess.push(frames[1])
    with pytest.raises(TypeError, match="uint8"):
        sess.start(frames[0].astype(np.float32) / 255.0, labels)
    sess.start(frames[0], labels)
    with pytest.raises(TypeError, match="uint8"):
        sess.push(frames[1].astype(np.float32))
    for n in (3, 2):
        with pytest.raises(ValueError, match="shrink"):
            sess.grow(n)
        with pytest.raises(ValueError, match="shrink"):
            sess.prepare_grow(n)
    with pytest.raises(ValueError, match="budget"):
        sess.add_objects(frames[1], labels, [4])


def test_latency_measures(pair):
    """``measure_latency`` returns the asked percentiles and the mean over one
    push per frame; ``measure_device_latency`` raises where no CUDA kernel
    ran, rather than report 0."""
    frames, labels, _ = stream(7, 4)
    sess = session(pair)
    out = measure_latency(sess, frames[0], labels, frames[1:], percentiles=(50, 95))
    assert set(out) == {"p50", "p95", "mean"}
    assert 0 < out["p50"] <= out["p95"]
    assert sess.frames_seen == 4
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        measure_device_latency(sess, frames[0], labels, frames[1:])


def test_default_device_is_cuda(pair, monkeypatch):
    """``device=None`` means CUDA: without a card the session raises."""
    _, _, port = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingSession(port.cfg, port.state_dict(), raw_hw=IN, in_size=IN, out_size=OUT)


def tf32_flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


def test_full_float32_overlapping_scopes_in_two_threads():
    """A enters, B enters, A leaves, B leaves: B still reads TF32 off after A
    has left, and both flags read as found once B has left."""
    saved = tf32_flags()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    a_in, b_in, a_out, b_read = (threading.Event() for _ in range(4))
    seen = {}

    def a():
        with full_float32():
            a_in.set()
            assert b_in.wait(10)
        a_out.set()

    def b():
        assert a_in.wait(10)
        with full_float32():
            b_in.set()
            assert a_out.wait(10)
            seen["b after a left"] = tf32_flags()
        b_read.set()

    try:
        threads = [threading.Thread(target=a), threading.Thread(target=b)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(20)
        assert not any(th.is_alive() for th in threads)
        assert b_read.is_set()
        assert seen["b after a left"] == (False, False)
        assert tf32_flags() == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
