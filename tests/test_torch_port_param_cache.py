"""The port's prepared parameters kept across calls (``models.layers.prepared``:
kernels and biases cast to the compute dtype, batch norms folded; and the
encoders' normalization constants), on the CPU with the tiny model at
float32 and bfloat16.

Warm calls give the bits of code that prepares every parameter on every
call (``keeps_prepared`` patched to say no, the path before the cache); an
in-place update of the weights (an SGD step under ``no_grad``,
``load_state_dict``) reaches the next call; with gradients on every call
prepares afresh, so the gradients are those of that code and nothing kept
joins the autograd graph; and an export traced after warm calls still takes
the weights as inputs of its programs.
"""

import contextlib
import os
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from swem_tpu_torch import engine
from swem_tpu_torch.io.export import export_runner
from swem_tpu_torch.models import layers
from swem_tpu_torch.models.swem import SWEM
from swem_tpu_torch.serve import StreamingSession
from swem_tpu_torch.utils import profiling
from _torch_port_util import port_cfg
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse fixture)
from test_model import tiny_cfg

DTYPES = ["float32", "bfloat16"]
HW = (64, 64)
T, CHUNK = 6, 4  # chunks of 4 and 1 frames


def model_of(dtype, seed=5):
    return SWEM(port_cfg(tiny_cfg(dtype=dtype)), device="cpu").init_weights(seed)


@contextlib.contextmanager
def per_call():
    """Every call prepares its parameters afresh, as before the cache."""
    with mock.patch.object(layers, "keeps_prepared", lambda sources: False):
        yield


def kept(model):
    """Every tensor the model's modules keep, by (module name, slot)."""
    out = {}
    for name, m in model.named_modules():
        for slot, (_, _, tensors) in getattr(m, "_prepared", {}).items():
            out[name, slot] = tensors
    return out


def assert_unchanged(model, entries):
    now = kept(model)
    assert now.keys() == entries.keys()
    assert all(now[k] is entries[k] for k in entries)


def video(seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.random((T, 1) + HW + (3,)).astype(np.float32)
    mask = np.zeros((1,) + HW + (3,), np.float32)
    mask[..., 0] = 1.0
    for n, (y, x) in enumerate([(8, 8), (30, 34)]):
        mask[0, y:y + 14, x:x + 14] = np.eye(3, dtype=np.float32)[n + 1]
    return frames, mask, np.ones((1, 2), bool)


def run_video(model):
    """The runner's float32 soft masks (T-1, 1, Ho, Wo, 3) as a tensor."""
    runner = engine.ChunkedVideoRunner(model, HW, chunk=CHUNK, scores=True)
    return torch.as_tensor(np.asarray(runner(torch.Generator().manual_seed(0), *video())))


def stream(n=4):
    rng = np.random.default_rng(1)
    labels = np.zeros(HW, np.uint8)
    labels[8:22, 8:22] = 1
    labels[30:44, 34:48] = 2
    return (rng.random((n,) + HW + (3,)) * 255).astype(np.uint8), labels


def run_stream(model):
    """Each push's map and the session's memory after the last push."""
    frames, labels = stream()
    sess = StreamingSession(model.cfg, model.state_dict(), raw_hw=HW, in_size=HW, out_size=HW,
                            n_slots=2, seed=3, device="cpu")
    sess.start(frames[0], labels)
    maps = [torch.as_tensor(sess.push(f)) for f in frames[1:]]
    mem = sess._mem
    return maps + [mem.first.kappa, mem.first.nu, mem.first.zita, mem.update.kappa,
                   mem.update.nu, mem.update.zita, mem.mem_count]


def assert_same_bits(a, b):
    """Tensors (None: a parameter without a gradient) equal bit for bit."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None and y is None) or (x.dtype == y.dtype and torch.equal(x, y))


def other_weights(model, seed):
    """``model``'s state with every float tensor moved by a seeded factor
    and offset (running variances stay positive)."""
    g = torch.Generator().manual_seed(seed)
    return {k: v * (1 + 0.05 * torch.rand(v.shape, generator=g))
            + 0.01 * torch.rand(v.shape, generator=g)
            for k, v in model.state_dict().items()}


def counts_of(fn):
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return profiling.recorded()["counts"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_warm_runner_and_session_are_the_per_call_bits(dtype):
    model = model_of(dtype)
    with per_call():
        want_video = run_video(model)
    assert not kept(model)
    cold, warm = run_video(model), run_video(model)
    assert kept(model)
    for got in (cold, warm):
        assert torch.equal(got, want_video)

    with per_call():
        want_stream = run_stream(model)
    assert_same_bits(run_stream(model), want_stream)
    # the session's model is its own: a second session starts cold, so
    # time a warm session by pushing on after the first stream's pushes
    frames, labels = stream()
    sess = StreamingSession(model.cfg, model.state_dict(), raw_hw=HW, in_size=HW, out_size=HW,
                            n_slots=2, seed=3, device="cpu")
    sess.start(frames[0], labels)
    sess.push(frames[1])
    counts = counts_of(lambda: sess.push(frames[2]))
    assert counts.get("models.param_preps", 0) == 0 < counts["models.param_cache_hits"]


@pytest.mark.parametrize("update", ["sgd_step", "load_state_dict"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_in_place_updates_reach_the_next_call(dtype, update):
    model = model_of(dtype)
    before = run_video(model)
    entries = kept(model)
    if update == "sgd_step":
        opt = torch.optim.SGD(model.parameters(), lr=0.01)
        g = torch.Generator().manual_seed(9)
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        opt.step()  # in place, under no_grad
    else:
        model.load_state_dict(other_weights(model, 9))
    got = run_video(model)
    with per_call():
        want = run_video(model)
    assert torch.equal(got, want)
    assert not torch.equal(got, before)
    after = kept(model)
    assert after.keys() == entries.keys()
    assert all(after[k] is not entries[k] for k in entries)  # every entry made again


@pytest.mark.parametrize("dtype", DTYPES)
def test_gradients_take_the_per_call_path(dtype):
    """Gradients on, parameters requiring them: the forward prepares per
    call, reuses nothing and keeps nothing, and gives the per-call
    gradients. Parameters frozen after an ``inference_mode`` warm-up: the
    kept tensors (made outside inference mode) serve a forward whose input
    needs a gradient, and give the per-call input gradient."""
    model = model_of(dtype)
    frame = torch.rand((1,) + HW + (3,), generator=torch.Generator().manual_seed(2))
    masks = torch.softmax(torch.randn((1,) + HW + (3,),
                                      generator=torch.Generator().manual_seed(3)), -1)

    def loss(x):
        qk16, qv16, s16, skip8, skip4, vf = model.encode_frame(x)
        mv16 = model.encode_value(x, masks, s16, vf)
        return sum(t.float().square().mean() for t in (qk16, qv16, skip8, skip4, mv16))

    def grads():
        model.zero_grad(set_to_none=True)
        loss(frame).backward()
        return [p.grad for p in model.parameters()]

    with per_call():
        want = grads()
    with torch.no_grad():
        loss(frame)
    entries = kept(model)
    counts = counts_of(lambda: assert_same_bits(grads(), want))
    assert counts.get("models.param_cache_hits", 0) == 0 < counts["models.param_preps"]
    assert_unchanged(model, entries)
    for tensors in entries.values():
        for t in tensors:
            assert t is None or (not t.requires_grad and t.grad_fn is None
                                 and not t.is_inference())

    model.requires_grad_(False)
    x = frame.clone().requires_grad_(True)
    with per_call():
        loss(x).backward()
    want_x = x.grad
    for m in model.modules():
        if hasattr(m, "_prepared"):
            m._prepared.clear()
    with torch.inference_mode():
        loss(frame)
    x = frame.clone().requires_grad_(True)
    counts = counts_of(lambda: loss(x).backward())
    assert counts.get("models.param_preps", 0) == 0 < counts["models.param_cache_hits"]
    assert torch.equal(x.grad, want_x)


@pytest.mark.parametrize("dtype", DTYPES)
def test_export_after_warm_calls_takes_the_weights_as_inputs(dtype, tmp_path):
    model = model_of(dtype)
    run_video(model)
    entries = kept(model)
    path = str(tmp_path / "art")
    export_runner(model, path, frame_hw=HW, chunk=1)
    assert_unchanged(model, entries)  # the trace wrote no kept tensor
    shapes = {tuple(p.shape) for p in model.parameters() if p.dim() > 1}
    n_weights = len(model.state_dict())
    programs = os.listdir(os.path.join(path, "programs"))
    assert programs
    for name in programs:
        ep = torch.export.load(os.path.join(path, "programs", name))
        assert not ep.state_dict, name
        # constants: the normalization's mean and std (3,) and scalars
        assert all(t.numel() <= 3 and tuple(t.shape) not in shapes
                   for t in ep.constants.values()), name
        inputs = [n for n in ep.graph.nodes if n.op == "placeholder"]
        assert len(inputs) > n_weights, name


@pytest.mark.parametrize("dtype", DTYPES)
def test_compiled_calls_keep_nothing(dtype):
    """Under ``torch.compile`` the casts and folds are ops of the graph:
    nothing is kept, and the compiled call gives the eager bits."""
    torch._dynamo.reset()
    dt = getattr(torch, dtype)
    block = torch.nn.Sequential(layers.Conv2d(4, 8, 3, padding=1, compute_dtype=dt),
                                layers.FrozenBatchNorm(8))
    with torch.no_grad():
        block[1].running_var.uniform_(0.5, 2.0, generator=torch.Generator().manual_seed(1))
    x = torch.randn((2, 4, 8, 8), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = torch.compile(block, backend="eager", fullgraph=True)(x)
        assert all(not m._prepared for m in block)
        assert torch.equal(got, block(x))
    # eager: the fold kept at both dtypes, the casts at bfloat16 alone
    assert bool(block[0]._prepared) == (dtype != "float32") and block[1]._prepared


def test_inference_tensor_weights_prepare_per_call():
    """Weights made under ``inference_mode`` track no version: each call
    prepares them, keeps nothing and gives the per-call bits."""
    x = torch.randn((1, 4, 8, 8), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        conv = layers.Conv2d(4, 8, 3, padding=1, compute_dtype=torch.bfloat16)
        got = conv(x)
    with per_call(), torch.inference_mode():
        want = conv(x)
    assert not conv._prepared
    assert torch.equal(got, want)
