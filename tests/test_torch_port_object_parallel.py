"""The port's object parallelism against swem_tpu's, on the CPU.

The port runs the shards of a ('data', 'obj') grid in one process; on the
CPU the grid's devices are ``cpu`` repeated, each cell still its own shard
with its own calls. ``cpu:0`` does not compare equal to ``cpu`` although
its tensors live in the same memory, so a grid that mixes the two holds a
device other than the model's: its shards there run on a copied replica,
and every split and gather crosses between the two. Counterparts of ``tests/test_object_parallel.py``: the
mesh helpers against the JAX package's, the sharded runner (1x4 and 2x4
grids, 4 slots, 3 objects, an object injected at a middle frame), the
memory carried split by slot, reloaded weights reaching the replicas, the
divisibility checks, the session, the evaluator and the train step.

Tolerances: the sharded runner's index maps differ from the port's
unsharded runner's on < 1e-3 of pixels (the JAX test's own limit: a
shard's convolutions see a smaller batch, which may flip an argmax tie)
and equal the JAX package's eager unsharded runner on >= 99.9%; the
session and the evaluator hold >= 99.9% against the unsharded port; the
sharded train step's loss within 1e-5 relative and every gradient within
1e-4 of its norm (+ 1e-7) of the unsharded step. The JAX side runs op by
op (``jax.disable_jit``), as in ``test_torch_port_runner.py``.
"""

import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swem_tpu import engine as jeng
from swem_tpu.parallel import mesh as jmesh
from swem_tpu_torch import engine, parallel
from swem_tpu_torch.config import EvalConfig, SWEMConfig
from swem_tpu_torch.eval import __main__ as eval_cli
from swem_tpu_torch.eval.evaluator import Evaluator
from swem_tpu_torch.models import em
from swem_tpu_torch.models.swem import SWEM
from swem_tpu_torch.ops import em_kernel, read_kernel
from swem_tpu_torch.parallel import EngineSharding, make_mesh, make_mesh2
from swem_tpu_torch.serve import StreamingSession
from swem_tpu_torch.train import trainer
from _torch_port_util import jax_bases, tiny_pair
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse fixture)
from test_eval_e2e import build_fake_davis
from test_model import make_video

HW = (64, 64)
CPU4, CPU8 = ["cpu"] * 4, ["cpu"] * 8
OTHER = torch.device("cpu", 0)  # not the model's device ``cpu``: shards there run on a copy


@pytest.fixture(scope="module")
def pair():
    """The tiny model with a 4-slot budget, in both packages."""
    return tiny_pair(seed=1, max_objs=4)


def pre(f):
    return f.float() / 255.0


def agreement(got, ref) -> float:
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float((np.asarray(got) == np.asarray(ref)).mean())


@pytest.fixture(scope="module")
def video(pair):
    """T = 6 uint8 frames of B = 2 videos at 64x64, 3 objects in 4 slots,
    object 3 of video 0 absent from frame 0 and injected at frame 3; and
    the JAX package's eager unsharded runner on it."""
    model, variables, _ = pair
    rng = np.random.default_rng(3)
    _, init_mask, active = make_video(rng, T=1, B=2, n_objs=3, n_slots=4)
    init_mask, active = np.asarray(init_mask).copy(), np.asarray(active).copy()
    frames = (rng.random((6, 2) + HW + (3,)) * 255).astype(np.uint8)
    box = init_mask[0, ..., 3] > 0
    init_mask[0, ..., 0] += init_mask[0, ..., 3]
    init_mask[0, ..., 3] = 0.0
    active[0, 2] = False
    idx_map = np.zeros((2,) + HW, np.uint8)
    idx_map[0][box] = 3
    new = np.zeros((2, 4), bool)
    new[0, 2] = True
    injections = {3: (idx_map, new)}
    key = jax.random.PRNGKey(7)
    with jax.disable_jit():
        runner = jeng.ChunkedVideoRunner(model, HW, chunk=4, injectable=True,
                                         preprocess=lambda f: f.astype(jnp.float32) / 255.0)
        ref = runner(variables, key, frames, init_mask, active, injections=injections)
    return dict(frames=frames, init_mask=init_mask, active=active, injections=injections,
                box=box, bases=jax_bases(model.cfg, key), jax=np.asarray(ref))


def run_port(port, video, mesh=None, **kw):
    runner = engine.ChunkedVideoRunner(port, HW, chunk=4, injectable=True, preprocess=pre,
                                       mesh=mesh, **kw)
    return runner(None, video["frames"], video["init_mask"], video["active"],
                  video["injections"], bases=video["bases"])


@pytest.fixture(scope="module")
def local_preds(pair, video):
    return run_port(pair[2], video)


# ------------------------------------------------------------ the mesh --
def test_clamp_pow2_matches():
    for limit in range(1, 18):
        for divisors in ((), (8,), (12,), (6,), (5,), (8, 4), (6, 8, 4), (8, 8, 6), (12, 8)):
            assert parallel.clamp_pow2(limit, *divisors) == jmesh.clamp_pow2(limit, *divisors)


def test_derive_eval_mesh_extents_matches():
    for ndev in range(1, 9):
        for obj_parallel in (1, 2, 3, 4, 8, 16):
            for vb in range(1, 9):
                assert (parallel.derive_eval_mesh_extents(ndev, obj_parallel, vb)
                        == jmesh.derive_eval_mesh_extents(ndev, obj_parallel, vb))


def test_make_mesh2_raises_where_jax_does():
    """The same arguments over the same number of devices: equal grids, or a
    ValueError in both packages. Unlike a JAX mesh, a port mesh may repeat
    a device, and a mesh asking for more devices than its list raises."""
    for n_dev in (1, 2, 4, 6, 8):
        for n_data, n_obj in ((None, 1), (None, 2), (None, 3), (None, 4), (1, 4), (2, 4),
                              (4, 2), (3, 3), (8, 2)):
            devs = jax.devices()[:n_dev]
            try:
                want = jmesh.make_mesh2(n_data, n_obj, devices=devs).devices.shape
            except ValueError:
                with pytest.raises(ValueError):
                    make_mesh2(n_data, n_obj, devices=["cpu"] * n_dev)
                continue
            got = make_mesh2(n_data, n_obj, devices=["cpu"] * n_dev)
            assert got.devices.shape == want and got.axis_names == ("data", "obj")
            assert got.shape == {"data": want[0], "obj": want[1]}
    assert make_mesh(2, devices=CPU4).devices.shape == (2,)
    with pytest.raises(ValueError, match="need 8 devices"):
        make_mesh(8, devices=CPU4)
    with pytest.raises(ValueError, match="no 'obj' axis"):
        EngineSharding(make_mesh(2, devices=CPU4))


def test_eval_devices_single_process():
    """Without a process group: every visible CUDA device (none here), or
    the one device asked for when it is not a card."""
    assert not torch.distributed.is_initialized()
    assert parallel.eval_devices() == [torch.device("cuda", i)
                                       for i in range(torch.cuda.device_count())]
    assert parallel.eval_devices("cpu") == [torch.device("cpu")]


# ------------------------------------------------------------ the runner --
@pytest.mark.parametrize("n_data,n_obj", [(1, 4), (2, 4)])
def test_sharded_runner_matches(pair, video, local_preds, n_data, n_obj):
    """1x4: each video's 4 slots over 4 shards; 2x4: the 2 videos over
    'data' too. The injected object holds its box at frame 3 and is never
    predicted before it; each kernel launches once per shard per frame."""
    port = pair[2]
    mesh = make_mesh2(n_data, n_obj, devices=CPU8)
    got = run_port(port, video, mesh=mesh)
    assert got.dtype == np.uint8 and got.shape == (5, 2) + HW
    assert (got[2, 0][video["box"]] == 3).all() and not (got[:2, 0] == 3).any()
    assert len(np.unique(local_preds)) == 4  # the comparison has content
    assert 1.0 - agreement(got, local_preds) < 1e-3
    assert agreement(got, video["jax"]) >= 0.999
    assert em_kernel.launches == read_kernel.launches == 0  # plain versions on the CPU


def test_sharded_scores_and_run_video(pair, video, local_preds):
    """``scores=True`` and ``run_video(sharding=)`` on a 1x2 grid: the
    scores' argmax is the index runner's maps, and ``run_video`` agrees."""
    port = pair[2]
    sh = EngineSharding(make_mesh2(1, 2, devices=CPU4))
    active = video["active"].copy()
    active[0, 2] = True  # no injection here: slot 3 of video 0 stays in the background
    scores = engine.ChunkedVideoRunner(port, HW, chunk=4, scores=True, preprocess=pre,
                                       mesh=sh.mesh)(None, video["frames"], video["init_mask"],
                                                     active, bases=video["bases"])
    index = engine.ChunkedVideoRunner(port, HW, chunk=4, preprocess=pre, mesh=sh.mesh)(
        None, video["frames"], video["init_mask"], active, bases=video["bases"])
    np.testing.assert_array_equal(scores.argmax(-1).numpy(), index)
    frames = pre(torch.from_numpy(video["frames"]))
    whole = engine.run_video(port, None, frames, torch.from_numpy(video["init_mask"]),
                             torch.from_numpy(active), HW, bases=video["bases"], sharding=sh)
    assert 1.0 - agreement(whole.numpy(), index) < 1e-3


def test_memory_carry_is_obj_sharded(pair, video):
    """``init_memory(sharding=)`` gives the grid of shards: each holds its
    rows and its N / n_obj slots, bit for bit the unsharded ``init_memory``
    of that shard's rows and slots (background + its slots of the mask);
    ``join_memory`` and ``split_memory`` invert each other."""
    port = pair[2]
    sh = EngineSharding(make_mesh2(2, 2, devices=CPU8))
    frame0 = pre(torch.from_numpy(video["frames"][0]))
    mask, active = torch.from_numpy(video["init_mask"]), torch.from_numpy(video["active"])
    grid = engine.init_memory(port, None, frame0, mask, active, bases=video["bases"],
                              sharding=sh)
    assert len(grid) == 2 and all(len(row) == 2 for row in grid)
    for i, j, d in sh.shards():
        m = grid[i][j]
        assert m.first.kappa.shape[:2] == (1, 2) and m.first.kappa.device == d
        assert m.obj_seen.shape == (1, 2) and int(m.mem_count) == 1
        r, c = slice(i, i + 1), slice(2 * j, 2 * j + 2)
        b = video["bases"]
        own = engine.init_memory(port, None, frame0[r], torch.cat([mask[r, ..., :1],
                                                                   mask[r, ..., 2 * j + 1:2 * j + 3]],
                                                                  dim=-1),
                                 active[r, c], bases=em.Bases(b.kappa[:, c], b.nu[:, c],
                                                              b.zita[:, c]))
        for bank in ("first", "update"):
            for f in ("kappa", "nu", "zita"):
                assert torch.equal(getattr(getattr(m, bank), f),
                                   getattr(getattr(own, bank), f)), (i, j, bank, f)
    whole = engine.init_memory(port, None, frame0, mask, active, bases=video["bases"])
    joined = sh.join_memory(grid, "cpu")
    assert torch.equal(joined.obj_seen, whole.obj_seen)
    assert joined.first.kappa.shape == whole.first.kappa.shape
    again = sh.split_memory(joined)
    for i, j, _ in sh.shards():
        assert torch.equal(again[i][j].update.nu, grid[i][j].update.nu)
        assert torch.equal(again[i][j].first.kappa, grid[i][j].first.kappa)


def same_weights(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def test_reloaded_weights_reach_the_replicas(pair, video, local_preds):
    """A warmed runner over a grid of ``cpu`` and ``cpu:0`` holds the source
    model (by reference) for ``cpu`` and a copy of it for ``cpu:0``; after
    ``load_state_dict`` of other weights the copy is rebuilt with those
    weights, and the runner gives their predictions."""
    port = pair[2]
    model = SWEM(port.cfg, device="cpu")
    model.load_state_dict(port.state_dict())
    mesh = make_mesh2(1, 4, devices=["cpu", OTHER] * 2)
    runner = engine.ChunkedVideoRunner(model, HW, chunk=4, injectable=True, preprocess=pre,
                                       mesh=mesh)
    runner.warmup(HW, 2, 4, np.uint8)
    reps = runner.sharding.replicas(model)
    assert list(reps) == [torch.device("cpu"), OTHER] and reps[torch.device("cpu")] is model
    copy = reps[OTHER]
    assert copy is not model and same_weights(copy, port)
    assert runner.sharding.replicas(model) is reps  # cached while the weights stand
    other = SWEM(port.cfg, device="cpu").init_weights(5)
    model.load_state_dict(other.state_dict())
    again = runner.sharding.replicas(model)
    assert again is not reps and again[OTHER] is not copy  # the versions moved
    assert same_weights(again[OTHER], other) and not same_weights(copy, other)
    assert runner.sharding._replicas[0] is model
    got = runner(None, video["frames"], video["init_mask"], video["active"],
                 video["injections"], bases=video["bases"])
    want = run_port(other, video)
    assert 1.0 - agreement(got, want) < 1e-3
    assert agreement(got, local_preds) < 0.99  # other weights, other maps


def test_copied_replicas_match(pair, video, local_preds):
    """Shards on a device other than the model's run on copies: the runner
    over a 2x2 grid of ``cpu:0`` and ``cpu`` and the session over a 1x2 grid
    whose model lives on ``cpu:0`` (its ``cpu`` column a copy) agree with
    the unsharded port as the single-device grids do."""
    port = pair[2]
    mesh = make_mesh2(2, 2, devices=[OTHER, "cpu", "cpu", OTHER])
    runner = engine.ChunkedVideoRunner(port, HW, chunk=4, injectable=True, preprocess=pre,
                                       mesh=mesh)
    got = runner(None, video["frames"], video["init_mask"], video["active"],
                 video["injections"], bases=video["bases"])
    assert runner.sharding.replicas(port)[OTHER] is not port
    assert (got[2, 0][video["box"]] == 3).all()
    assert 1.0 - agreement(got, local_preds) < 1e-3
    assert agreement(got, video["jax"]) >= 0.999
    want, _ = session_stream(port, None)
    maps, sess = session_stream(port, make_mesh2(1, 2, devices=[OTHER, "cpu"]))
    assert sess.device == OTHER and sess._esh.replicas(sess.model)[torch.device("cpu")] \
        is not sess.model
    assert agreement(maps, want) >= 0.999


def test_divisibility_enforced(pair, video):
    port = pair[2]
    thirds = engine.ChunkedVideoRunner(port, HW, chunk=4, mesh=make_mesh2(1, 3, devices=CPU4))
    with pytest.raises(ValueError, match="divisible"):  # 4 slots over 3 shards
        thirds.warmup(HW, 2, 4, np.uint8)
    runner = engine.ChunkedVideoRunner(port, HW, chunk=4, preprocess=pre,
                                       mesh=make_mesh2(2, 2, devices=CPU4))
    with pytest.raises(ValueError, match="divisible"):  # a batch of 1 over 2 rows
        runner(None, video["frames"][:, :1], video["init_mask"][:1], video["active"][:1],
               bases=video["bases"])
    with pytest.raises(ValueError, match="divisible"):  # 3 slots over 2 shards
        runner(None, video["frames"], video["init_mask"][..., :4], video["active"][:, :3],
               bases=em.Bases(*(t[:, :3] for t in (video["bases"].kappa, video["bases"].nu,
                                                    video["bases"].zita))))


# ----------------------------------------------------------- the session --
def session_stream(port, mesh):
    """Start with 2 slots, 3 pushes, ``grow(4)``, an object added in slot 3,
    2 more pushes -> (the 6 maps, the session); over ``mesh``, ``grow(3)``
    raises first."""
    rng = np.random.default_rng(11)
    frames = (rng.random((7,) + HW + (3,)) * 255).astype(np.uint8)
    labels = np.zeros(HW, np.uint8)
    labels[8:20, 8:20], labels[30:44, 28:40] = 1, 2
    third = np.zeros(HW, np.uint8)
    third[46:60, 4:20] = 3
    draw = em.init_bases(torch.Generator().manual_seed(2), 1, 4, port.cfg.keydim,
                         port.cfg.valdim, port.cfg.num_bases)
    sess = StreamingSession(port.cfg, port.state_dict(), raw_hw=HW, in_size=HW,
                            out_size=HW, n_slots=2, device="cpu" if mesh is None else None,
                            mesh=mesh)
    sess.warmup()
    sess.start(frames[0], labels, bases=em.Bases(draw.kappa[:, :2], draw.nu[:, :2],
                                                 draw.zita[:, :2]))
    maps = [sess.push(f) for f in frames[1:4]]
    if mesh is not None:
        with pytest.raises(ValueError, match="divisible"):
            sess.grow(3)
    sess.grow(4, bases=draw)
    maps.append(sess.add_objects(frames[4], third, [3]))
    maps += [sess.push(f) for f in frames[5:]]
    assert (maps[3][third > 0] == 3).all()
    return np.stack(maps), sess


def test_sharded_session_matches(pair):
    """1x2 grid: ``session_stream``'s every map >= 99.9% of the unsharded
    session's. ``grow(3)`` over the 2 shards raises, and so does a session
    of 3 slots over them."""
    port = pair[2]
    want, _ = session_stream(port, None)
    got, sess = session_stream(port, make_mesh2(1, 2, devices=CPU4))
    assert sess.device == torch.device("cpu") and len(sess._mem[0]) == 2
    assert sess._mem[0][1].first.kappa.shape[1] == 2
    assert agreement(got, want) >= 0.999
    with pytest.raises(ValueError, match="divisible"):
        StreamingSession(port.cfg, port.state_dict(), raw_hw=HW, in_size=HW, out_size=HW,
                         n_slots=3, mesh=make_mesh2(1, 2, devices=CPU4))


# --------------------------------------------------------- the evaluator --
@pytest.fixture(scope="module")
def fake_davis(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("davis"))
    build_fake_davis(root)  # 2 videos of 5 frames at 64x96, 2 objects each
    return root


def read_maps(out_root):
    from PIL import Image

    return {v: np.stack([np.array(Image.open(os.path.join(out_root, v, f)))
                         for f in sorted(os.listdir(os.path.join(out_root, v)))])
            for v in sorted(os.listdir(out_root))}


@pytest.mark.parametrize("video_batch", [1, 2])
def test_sharded_evaluator_matches(pair, fake_davis, tmp_path, monkeypatch, video_batch):
    """With four CPU devices (``eval_devices`` patched), ``obj_parallel=2``
    shards each video's 2 slots over 2 devices (sequential) or the batch of
    two videos over 2 rows x 2 slot shards (``video_batch=2``); the PNGs
    equal the unsharded evaluation's on >= 99.9% of pixels."""
    port = pair[2]

    def evaluate(tag, obj_parallel):
        cfg = SWEMConfig(model=port.cfg, log_dir=str(tmp_path / tag),
                         eval=EvalConfig(eval_set="DAVIS17", data_root=fake_davis, max_objs=4,
                                         davis_in_size=(64, 96), chunk=2,
                                         video_batch=video_batch, obj_parallel=obj_parallel))
        ev = Evaluator(cfg, port.state_dict(), device="cpu")
        ev.val()
        return ev

    want = evaluate("local", 1)
    monkeypatch.setattr(parallel, "eval_devices", lambda device=None: [torch.device("cpu")] * 4)
    got = evaluate("sharded", 2)
    meshes = [k[-1] for k in got._runners]
    shape = (1, 2) if video_batch == 1 else (2, 2)
    assert meshes and all(m is not None and m[1] == shape for m in meshes)
    ref, maps = read_maps(want.out_root), read_maps(got.out_root)
    assert maps.keys() == ref.keys() and len(maps) == 2
    for v in ref:
        assert agreement(maps[v], ref[v]) >= 0.999, v
    if video_batch == 2:
        log = "".join(open(f).read() for f in glob.glob(os.path.join(got.save_dir, "*.log")))
        assert "sharding video batches over 2 devices x 2 object shards" in log


def test_obj_mesh_clamps_by_the_bucket(pair, fake_davis, tmp_path, monkeypatch):
    """'obj' takes the largest power of two within ``obj_parallel``, the
    bucket and the devices per row that divides the bucket, as the JAX
    evaluator's ``_obj_mesh`` does: not the model's own ``max_objs`` (2
    here), since one port model serves every bucket of the 8-slot budget."""
    import dataclasses

    port = pair[2]
    cfg = SWEMConfig(model=dataclasses.replace(port.cfg, max_objs=2), log_dir=str(tmp_path),
                     eval=EvalConfig(eval_set="DAVIS17", data_root=fake_davis, max_objs=8,
                                     obj_parallel=4))
    ev = Evaluator(cfg, port.state_dict(), device="cpu")
    monkeypatch.setattr(parallel, "eval_devices", lambda device=None: [torch.device("cpu")] * 4)
    for (bucket, n_data), shape in (((2, 1), (1, 2)), ((4, 1), (1, 4)), ((8, 1), (1, 4)),
                                    ((4, 2), (2, 2))):
        assert ev._obj_mesh(bucket, n_data).devices.shape == shape, (bucket, n_data)
    monkeypatch.setattr(parallel, "eval_devices", lambda device=None: [torch.device("cpu")])
    assert ev._obj_mesh(4) is None


def test_cli_takes_obj_parallel(tmp_path):
    args = eval_cli.get_args(["--data_root", str(tmp_path), "--resume", "x.pth",
                              "--obj_parallel", "2", "--video_batch", "2"])
    cfg = eval_cli.build_config(args)
    assert cfg.eval.obj_parallel == 2 and cfg.eval.video_batch == 2
    assert not hasattr(__import__("swem_tpu_torch.eval.evaluator",
                                  fromlist=["x"]), "OBJ_PARALLEL_TODO")


# ---------------------------------------------------------- the train step --
B, T, N = 2, 3, 2


@pytest.fixture(scope="module")
def train_port():
    from swem_tpu.config import ModelConfig as JaxModelConfig

    dims = dict(backbone="resnet18", keydim=8, valdim=16, num_bases=4, num_em_iters=2, topl=2,
                max_objs=2, mdim=16)
    return tiny_pair(seed=3, jcfg=JaxModelConfig(**dims))[2]


def train_batch():
    """The training tests' tiny batch (test_torch_port_train.py): two boxes, the first
    moving; slot 2 invalid in clip 1."""
    rng = np.random.default_rng(0)
    label = np.zeros((B, T, 32, 32), np.uint8)
    for i in range(T):
        label[:, i, 4 + 2 * i:14 + 2 * i, 4:14] = 1
    label[0, :, 18:28, 18:28] = 2
    valid = np.ones((B, N + 1), np.float32)
    valid[1, 2] = 0.0
    return {"frames": rng.integers(0, 256, (B, T, 32, 32, 3), dtype=np.uint8), "label": label,
            "valid_obj": valid}


def step_grads(port, bases, sharding=None, remat=None):
    model = SWEM(port.cfg, device="cpu")
    model.load_state_dict(port.state_dict())
    cfg = SWEMConfig(model=port.cfg)
    state = trainer.create_train_state(model, cfg.solver)
    step = trainer.make_train_step(cfg, remat=remat, sharding=sharding)
    out = step(state, trainer.batch_to_device(train_batch(), "cpu"), bases=bases)
    return out, {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("grid,remat", [((1, 2), None), ((2, 2), "block")])
def test_sharded_train_step_matches(train_port, grid, remat):
    """One float32 step over a 1x2 grid (and a 2x2 grid with whole-block
    recomputation): loss within 1e-5 relative, each gradient within 1e-4 of
    its norm of the unsharded step's, the same parameters reached."""
    bases, _ = trainer.draw_step(train_port, torch.Generator().manual_seed(0), B, T)
    want, want_g = step_grads(train_port, bases)
    sh = EngineSharding(make_mesh2(*grid, devices=CPU4))
    got, got_g = step_grads(train_port, bases, sh, remat)
    for k in ("total_loss", "main_loss", "aux_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert set(got_g) == set(want_g)
    worst = max(float(torch.linalg.vector_norm(got_g[n] - want_g[n])
                      / (1e-4 * torch.linalg.vector_norm(want_g[n]) + 1e-7)) for n in want_g)
    print(f"worst gradient error over its limit: {worst:.3f}")
    assert worst <= 1.0
    assert ({n for n, g in got_g.items() if bool(g.any())}
            == {n for n, g in want_g.items() if bool(g.any())})


def test_sharded_train_step_refuses_other_devices(train_port):
    """The sharded step runs every shard on the model's device: a grid
    holding another device (``cpu:0``, whose shards would run on a copy that
    the optimizer never steps) raises."""
    sh = EngineSharding(make_mesh2(1, 2, devices=["cpu", OTHER]))
    bases, _ = trainer.draw_step(train_port, torch.Generator().manual_seed(0), B, T)
    with pytest.raises(ValueError, match="model's device"):
        step_grads(train_port, bases, sh)
