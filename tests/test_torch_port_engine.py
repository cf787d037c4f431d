"""The PyTorch port's inference engine against swem_tpu's, on the CPU.

Both packages run the same tiny model (seeded weights carried across by the
weight bridge) on the same numpy video, with the JAX package's initial EM
bases handed to the port (the two frameworks draw different random numbers).
"""

import os
import subprocess
import sys
from collections import Counter
from functools import partial
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from swem_tpu import engine as jeng
from swem_tpu.models import em as jem
from swem_tpu_torch import engine
from swem_tpu_torch.config import full_float32
from swem_tpu_torch.models import em
from swem_tpu_torch.models.swem import SWEM
from _torch_port_util import port_cfg, t, tiny_pair
from test_model import make_video, tiny_cfg

ROOT = Path(__file__).resolve().parent.parent
OUT = (64, 64)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=1)


def initial_bases(cfg, seed):
    """The JAX draw of initial bases, for both packages."""
    mem = jem.fresh_memory(jax.random.PRNGKey(seed), 1, cfg.max_objs, cfg.keydim, cfg.valdim,
                           cfg.num_bases)
    return mem, em.Bases(t(mem.first.kappa), t(mem.first.nu), t(mem.first.zita))


def test_step_pred_mask_matches(pair):
    """Per-frame ``step`` over T=4 frames: pred_mask within 1e-4.

    The memory carries each frame into the next, so this also holds
    init_memory, match, decode and the memorize chain to the JAX engine.
    The JAX side runs op by op, as its own engine tests do: under jit XLA
    fuses the EM loop's exponentials differently.
    """
    model, variables, port = pair
    frames, init_mask, active = make_video(np.random.default_rng(2))
    jmem = jeng.init_memory(model, variables, jax.random.PRNGKey(3), frames[0], init_mask,
                            active)
    _, bases = initial_bases(model.cfg, 3)
    pmem = engine.init_memory(port, None, t(frames[0]), t(init_mask), t(active), bases=bases)
    for f in range(1, frames.shape[0]):
        jmem, jidx, jpm = jeng.step(model, variables, jmem, frames[f], active, OUT)
        pmem, pidx, ppm = engine.step(port, pmem, t(frames[f]), t(active), OUT)
        # float32 conv stacks and EM loops agree to ~1e-6 per frame; 1e-4
        # leaves room for three frames of carried memory
        np.testing.assert_allclose(ppm.numpy(), np.asarray(jpm), rtol=0, atol=1e-4,
                                   err_msg=f"frame {f}")
        np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("n_objs", [2, 1], ids=["two objects", "one inactive slot"])
def test_run_video_index_maps_agree(pair, n_objs):
    """Whole-video inference: the uint8 index maps agree on >= 99.9% of pixels
    (a pixel may flip only at an argmax near-tie)."""
    model, variables, port = pair
    frames, init_mask, active = make_video(np.random.default_rng(4), T=5, n_objs=n_objs)
    ref = np.asarray(jax.jit(partial(jeng.run_video, model), static_argnames=("out_size",))(
        variables, jax.random.PRNGKey(5), frames, init_mask, active, out_size=OUT))
    _, bases = initial_bases(model.cfg, 5)
    got = engine.run_video(port, None, t(frames), t(init_mask), t(active), OUT,
                           bases=bases).numpy()
    assert got.shape == ref.shape == (4, 1) + OUT and got.dtype == np.uint8
    agree = float((got == ref).mean())
    print(f"run_video, {n_objs} of 2 slots active: {agree:.6f} of index pixels identical")
    assert agree >= 0.999, agree
    assert len(np.unique(ref)) > 1  # not all background: the comparison has content
    if n_objs == 1:
        assert got.max() <= 1  # the inactive slot is never predicted


def test_step_with_injection_matches(pair):
    """A frame where a new object's ground truth is injected."""
    model, variables, port = pair
    frames, init_mask, _ = make_video(np.random.default_rng(6))
    active = np.asarray([[True, False]])
    first = np.asarray(init_mask).copy()
    first[..., 0] += first[..., 2]
    first[..., 2] = 0.0
    inject = np.asarray(init_mask).copy()
    inject[..., 1] = 0.0
    inject_new = np.asarray([[False, True]])
    jmem = jeng.init_memory(model, variables, jax.random.PRNGKey(7), frames[0], first, active)
    _, bases = initial_bases(model.cfg, 7)
    pmem = engine.init_memory(port, None, t(frames[0]), t(first), t(active), bases=bases)
    jmem, jidx, jpm = jeng.step(model, variables, jmem, frames[1], active, OUT,
                                inject_mask=inject, inject_new=inject_new)
    pmem, pidx, ppm = engine.step(port, pmem, t(frames[1]), t(active), OUT,
                                  inject_mask=t(inject), inject_new=t(inject_new))
    np.testing.assert_allclose(ppm.numpy(), np.asarray(jpm), rtol=0, atol=1e-4)
    assert bool(pmem.obj_seen.all()) and bool(np.asarray(jmem.obj_seen).all())


class DispatchedOps(TorchDispatchMode):
    """The aten ops dispatched inside, by name, views aside: a view launches
    nothing on a device."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def plain_step(port, mem, frame, active, inject):
    """One frame as the plain composition of the model's stages, on one device."""
    with torch.no_grad(), full_float32():
        qk16, qv16, s16, skip8, skip4, vf = port.encode_frame(frame)
        context = port.match(qk16, qv16, mem)
        _, pred_mask = port.decode(context, skip8, skip4, active.float(), OUT)
        if inject:
            pred_mask, active = engine._inject(pred_mask, active, inject["inject_mask"],
                                               inject["inject_new"])
        pred_idx = pred_mask.argmax(dim=-1).to(torch.uint8)
        mem = engine.memorize_from_pred(port, mem, frame, active, qk16, s16, vf, pred_idx,
                                        pred_mask)
    return mem, pred_idx, pred_mask


@pytest.mark.parametrize("injecting", [False, True], ids=["no injection", "injection"])
def test_step_launches_the_plain_composition(pair, injecting):
    """``engine.step`` without ``sharding=`` runs over the 1x1 grid of the
    model's device and dispatches exactly the ops of the plain composition
    (encode -> match -> decode -> argmax -> inject -> memorize): the grid
    adds no ``aten.cat`` and no ``aten.copy_``, nor any other op that could
    launch, and gives the composition's bits."""
    _, _, port = pair
    frames, init_mask, _ = make_video(np.random.default_rng(6))
    frame, active = t(frames[1]), t(np.asarray([[True, False]]))
    mem = engine.init_memory(port, torch.Generator().manual_seed(0), t(frames[0]),
                             t(init_mask), active)
    inject = {}
    if injecting:
        inject = dict(inject_mask=t(init_mask), inject_new=t(np.asarray([[False, True]])))
    with DispatchedOps() as grid:
        got = engine.step(port, mem, frame, active, OUT, **inject)
    with DispatchedOps() as plain:
        want = plain_step(port, mem, frame, active, inject)
    assert grid.ops == plain.ops, (grid.ops - plain.ops, plain.ops - grid.ops)
    assert plain.ops["aten.cat.default"] > 0  # the count sees the stages' own cats
    for a, b in zip(got[1:] + (got[0].update.kappa, got[0].update.nu, got[0].obj_seen),
                    want[1:] + (want[0].update.kappa, want[0].update.nu, want[0].obj_seen)):
        assert torch.equal(a, b)


def test_init_memory_draw_is_seeded(pair):
    """Without injected bases the draw comes from the caller's generator."""
    _, _, port = pair
    frames, init_mask, active = make_video(np.random.default_rng(8))
    args = (t(frames[0]), t(init_mask), t(active))
    a = engine.init_memory(port, torch.Generator().manual_seed(0), *args)
    b = engine.init_memory(port, torch.Generator().manual_seed(0), *args)
    c = engine.init_memory(port, torch.Generator().manual_seed(1), *args)
    assert torch.equal(a.update.kappa, b.update.kappa)
    assert not torch.equal(a.update.kappa, c.update.kappa)


def test_default_device_is_cuda(monkeypatch):
    """``device=None`` means CUDA: without a card it raises, never runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SWEM(port_cfg(tiny_cfg()))


def test_port_imports_no_jax():
    """Importing the port's engine, session, weight bridge, benchmark,
    evaluator, registry, evaluation CLI, trainer, training CLI, training
    data modules, process-group helpers, export module and export CLI, the
    scoring CLIs, the profiling helpers and the utilities loads neither JAX,
    flax, optax or orbax nor any module of the JAX package."""
    code = (
        "import sys\n"
        "import swem_tpu_torch.engine, swem_tpu_torch.io.jax_import, swem_tpu_torch.bench\n"
        "import swem_tpu_torch.serve, swem_tpu_torch.registry, swem_tpu_torch.io.checkpoint\n"
        "import swem_tpu_torch.eval.evaluator, swem_tpu_torch.eval.__main__\n"
        "import swem_tpu_torch.eval.benchmark, swem_tpu_torch.utils.visualization\n"
        "import swem_tpu_torch.train.__main__, swem_tpu_torch.train.loop\n"
        "import swem_tpu_torch.train.trainer, swem_tpu_torch.train.losses\n"
        "import swem_tpu_torch.train.solver, swem_tpu_torch.data.factory\n"
        "import swem_tpu_torch.data.loader, swem_tpu_torch.data.transforms\n"
        "import swem_tpu_torch.data.tps, swem_tpu_torch.data.video_dataset\n"
        "import swem_tpu_torch.data.static_dataset, swem_tpu_torch.parallel\n"
        "import swem_tpu_torch.parallel.mesh\n"
        "import swem_tpu_torch.io.export, swem_tpu_torch.export\n"
        "import swem_tpu_torch.evaluation_method, swem_tpu_torch.evaluation_codalab\n"
        "import swem_tpu_torch.utils.profiling, swem_tpu_torch.utils\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'optax', 'orbax', 'swem_tpu')]\n"
        "assert {'swem_tpu_torch.engine', 'swem_tpu_torch.serve', 'swem_tpu_torch.registry',\n"
        "        'swem_tpu_torch.eval.evaluator', 'swem_tpu_torch.eval.__main__',\n"
        "        'swem_tpu_torch.train.__main__', 'swem_tpu_torch.train.loop',\n"
        "        'swem_tpu_torch.data.factory', 'swem_tpu_torch.parallel',\n"
        "        'swem_tpu_torch.parallel.mesh',\n"
        "        'swem_tpu_torch.io.export', 'swem_tpu_torch.export',\n"
        "        'swem_tpu_torch.evaluation_method', 'swem_tpu_torch.evaluation_codalab',\n"
        "        'swem_tpu_torch.utils.profiling', 'swem_tpu_torch.utils'} <= set(sys.modules)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
