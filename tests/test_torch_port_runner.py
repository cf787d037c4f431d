"""The port's chunked runner, scores and injection against swem_tpu's, on the CPU.

Both packages run the same tiny model (seeded weights carried across by the
weight bridge, three object slots) on the same uint8 host videos, with the
JAX package's initial EM bases handed to the port. The JAX side runs op by
op (``jax.disable_jit``): at tau = 0.05 the EM loop turns the ~1e-3 by which
XLA's fused programs move the features into other pixels, so on these
videos the JAX package's own jitted runner agrees with its own eager one on
as little as 57% of pixels, while the port agrees with the eager one on
>= 99.99%. Index maps are held at >= 99.9% of pixels (a pixel may flip at
an argmax near-tie), injected ground truth exactly.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swem_tpu import engine as jeng
from swem_tpu.ops.resize import resize as jax_resize
from swem_tpu_torch import engine
from swem_tpu_torch.models import em
from swem_tpu_torch.models.swem import SWEM
from swem_tpu_torch.ops.resize import resize
from _torch_port_util import jax_bases, t, tiny_pair
from test_model import make_video

# an exact 2x upsample: the two packages' bicubic taps agree to the bit there.
# At other ratios they differ by ~2e-7, which the EM loop at tau = 0.05 can
# already turn into other pixels on a noise video (the port's own run_video
# on its own and on the JAX package's resized frames then differ by 1.5%).
RAW, IN, OUT = (32, 32), (64, 64), (64, 64)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=1, max_objs=3)


def jax_runner(model, chunk, **kw):
    return jeng.ChunkedVideoRunner(model, OUT, chunk=chunk, preprocess=jax_pre, **kw)


def jax_pre(f):
    return jax_resize(f.astype(jnp.float32) / 255.0, IN, "bicubic")


def port_pre(f):
    return resize(f.float() / 255.0, IN, "bicubic")


def uint8_video(seed, T, n_objs=3):
    """uint8 frames (T,1,32,32,3) and a one-hot init mask (1,64,64,4)."""
    rng = np.random.default_rng(seed)
    frames = (rng.random((T, 1) + RAW + (3,)) * 255).astype(np.uint8)
    _, init_mask, active = make_video(rng, T=1, n_objs=n_objs, n_slots=3)
    return frames, np.asarray(init_mask), np.asarray(active)


def late_third_object(init_mask):
    """(init mask without object 3, its (1,Ho,Wo) uint8 index map, active [T,T,F])."""
    first = init_mask.copy()
    first[..., 0] += first[..., 3]
    first[..., 3] = 0.0
    idx_map = (init_mask[..., 3] > 0).astype(np.uint8) * 3
    return first, idx_map, np.asarray([[True, True, False]])


def agreement(got, ref):
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float((np.asarray(got) == np.asarray(ref)).mean())


def test_ladder_sizes_match():
    for chunk in range(1, 41):
        assert engine.ladder_sizes(chunk) == jeng.ladder_sizes(chunk), chunk


def test_run_video_scores_matches(pair):
    """Soft scores: the 99th percentile of |port - JAX| under 1e-3 (the JAX
    package's own bound between its jitted programs), argmax >= 99.9%."""
    model, variables, port = pair
    frames, init_mask, active = make_video(np.random.default_rng(3), T=5, n_objs=3, n_slots=3)
    with jax.disable_jit():
        ref = np.asarray(jeng.run_video_scores(model, variables, jax.random.PRNGKey(4), frames,
                                               init_mask, active, OUT))
    got = engine.run_video_scores(port, None, t(frames), t(init_mask), t(active), OUT,
                                  bases=jax_bases(model.cfg, jax.random.PRNGKey(4)))
    assert got.dtype == torch.float32 and got.shape == (4, 1) + OUT + (4,)
    diff = np.abs(got.numpy() - ref)
    print(f"run_video_scores: |diff| 99th percentile {np.quantile(diff, 0.99):.3e}, "
          f"max {diff.max():.3e}")
    assert np.quantile(diff, 0.99) < 1e-3
    assert agreement(got.numpy().argmax(-1), ref.argmax(-1)) >= 0.999
    empty = engine.run_video_scores(port, None, t(frames[:1]), t(init_mask), t(active), OUT,
                                    bases=jax_bases(model.cfg, jax.random.PRNGKey(4)))
    assert empty.shape == (0, 1) + OUT + (4,) and empty.dtype == torch.float32


def test_run_chunk_with_injection_matches(pair):
    """C = 4, slot 3 inactive until t = 2, where its ground truth is injected."""
    model, variables, port = pair
    frames, init_mask, _ = make_video(np.random.default_rng(5), T=5, n_objs=3, n_slots=3)
    first, idx_map, active = late_third_object(np.asarray(init_mask))
    inject_idx = np.zeros((4, 1) + OUT, np.uint8)
    inject_idx[2] = idx_map
    inject_new = np.zeros((4, 1, 3), bool)
    inject_new[2, 0, 2] = True
    key = jax.random.PRNGKey(6)
    with jax.disable_jit():
        jmem = jeng.init_memory(model, variables, key, frames[0], first, active)
        _, ref = jeng.run_chunk(model, variables, jmem, frames[1:], active, OUT,
                                inject_idx=inject_idx, inject_new=inject_new)
    pmem = engine.init_memory(port, None, t(frames[0]), t(first), t(active),
                              bases=jax_bases(model.cfg, key))
    pmem, got, got_active = engine.run_chunk(port, pmem, t(frames[1:]), t(active), OUT,
                                             inject_idx=inject_idx, inject_new=inject_new)
    ref, got = np.asarray(ref), got.numpy()
    box = idx_map[0] > 0
    assert (ref[2, 0][box] == 3).all() and (got[2, 0][box] == 3).all()
    assert not (got[:2] == 3).any()  # slot 3 is never predicted before it appears
    assert bool(got_active.all()) and bool(pmem.obj_seen.all())
    assert agreement(got, ref) >= 0.999


@pytest.mark.parametrize("T,chunk", [(6, 4), (9, 4), (5, 16)])
def test_runner_matches(pair, T, chunk):
    """The index runner on uint8 host frames with a /255 + bicubic preprocess:
    full chunks, ladder tails and a video shorter than one chunk."""
    model, variables, port = pair
    frames, init_mask, active = uint8_video(10 + T, T)
    key = jax.random.PRNGKey(T)
    with jax.disable_jit():
        ref = jax_runner(model, chunk)(variables, key, frames, init_mask, active)
    runner = engine.ChunkedVideoRunner(port, OUT, chunk=chunk, preprocess=port_pre)
    got = runner(None, frames, init_mask, active, bases=jax_bases(model.cfg, key))
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    assert got.shape == (T - 1, 1) + OUT
    assert len(np.unique(ref)) > 2  # the comparison has content
    assert agreement(got, ref) >= 0.999


def test_scores_runner_matches(pair):
    """The scores runner against JAX's, and its argmax against the port's
    index runner bit for bit."""
    model, variables, port = pair
    frames, init_mask, active = uint8_video(20, 6)
    key = jax.random.PRNGKey(21)
    bases = jax_bases(model.cfg, key)
    with jax.disable_jit():
        ref = np.asarray(jax_runner(model, 4, scores=True)(variables, key, frames, init_mask,
                                                          active))
    got = engine.ChunkedVideoRunner(port, OUT, chunk=4, scores=True, preprocess=port_pre)(
        None, frames, init_mask, active, bases=bases)
    assert got.dtype == torch.float32 and got.shape == (5, 1) + OUT + (4,)
    assert np.quantile(np.abs(got.numpy() - ref), 0.99) < 1e-3
    assert agreement(got.numpy().argmax(-1), ref.argmax(-1)) >= 0.999
    idx = engine.ChunkedVideoRunner(port, OUT, chunk=4, preprocess=port_pre)(
        None, frames, init_mask, active, bases=bases)
    np.testing.assert_array_equal(got.argmax(-1).numpy(), idx)


def test_injectable_runner_matches(pair):
    """Slot 3 appears at frame 3, in the second chunk of T = 7 (4 + 2)."""
    model, variables, port = pair
    frames, init_mask, _ = uint8_video(30, 7)
    first, idx_map, active = late_third_object(init_mask)
    injections = {3: (idx_map, np.asarray([[False, False, True]]))}
    key = jax.random.PRNGKey(31)
    with jax.disable_jit():
        ref = jax_runner(model, 4, injectable=True)(variables, key, frames, first, active,
                                                    injections=injections)
    got = engine.ChunkedVideoRunner(port, OUT, chunk=4, injectable=True, preprocess=port_pre)(
        None, frames, first, active, injections, bases=jax_bases(model.cfg, key))
    box = idx_map[0] > 0
    assert (got[2, 0][box] == 3).all() and (ref[2, 0][box] == 3).all()
    assert not (got[:2] == 3).any()
    assert agreement(got, ref) >= 0.999


def test_runner_single_frame_and_bad_calls(pair):
    """T = 1 predicts nothing; a tensor video raises TypeError; injections
    without ``injectable`` raise ValueError."""
    _, _, port = pair
    frames, init_mask, active = uint8_video(40, 1)
    gen = torch.Generator().manual_seed(0)
    idx = engine.ChunkedVideoRunner(port, OUT, chunk=4, preprocess=port_pre)
    assert idx(gen, frames, init_mask, active).shape == (0, 1) + OUT
    scores = engine.ChunkedVideoRunner(port, OUT, chunk=4, scores=True, preprocess=port_pre)(
        gen, frames, init_mask, active)
    assert scores.shape == (0, 1) + OUT + (4,) and scores.dtype == torch.float32
    with pytest.raises(TypeError, match="HOST"):
        idx(gen, torch.from_numpy(frames), init_mask, active)
    with pytest.raises(ValueError, match="injectable"):
        idx(gen, frames, init_mask, active, {1: (np.zeros((1,) + OUT, np.uint8),
                                                 np.ones((1, 3), bool))})


def test_bf16_runner_keeps_memory_and_kernel_inputs_float32(pair, monkeypatch):
    """In bf16 the runner's memory and both kernels' inputs stay float32 (on
    the CPU a missed promotion would run the plain versions in bf16 without
    a word); warm-up runs every chunk size."""
    _, _, port = pair
    bf16 = SWEM(dataclasses.replace(port.cfg, dtype="bfloat16"), device="cpu")
    bf16.load_state_dict(port.state_dict())
    seen = []

    def spy(fn, name):
        def wrapped(*args, **kwargs):
            seen.extend((name, a.dtype) for a in args if a.is_floating_point())
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(em, "em_loop", spy(em.em_loop, "em_loop"))
    monkeypatch.setattr(em, "read_affinity", spy(em.read_affinity, "read_affinity"))
    frames, init_mask, active = uint8_video(50, 4)
    runner = engine.ChunkedVideoRunner(bf16, OUT, chunk=2, scores=True, preprocess=port_pre)
    runner.warmup(RAW, 1, 3, np.uint8)
    got = runner(torch.Generator().manual_seed(0), frames, init_mask, active)
    assert got.dtype == torch.float32 and got.shape == (3, 1) + OUT + (4,)
    assert {name for name, _ in seen} == {"em_loop", "read_affinity"}
    assert all(dtype == torch.float32 for _, dtype in seen), seen
