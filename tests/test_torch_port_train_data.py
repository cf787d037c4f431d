"""The port's training data, trainer loop, checkpoints and CLI, on the CPU.

- The loader's batches are bit-equal to the JAX package's for every stage
  (the port keeps its own copies of the host-side data modules).
- ``Trainer`` on the CPU: 6 steps equal 3, a checkpoint and 3 resumed steps
  bit for bit; the SIGTERM checkpoint; weights-only resume with the
  single-object widening; ``--backbone_init`` against the JAX package's
  converter; the CLI with ``--device cpu``.
- The slice as a whole: 3 ``train_step``s on loader batches against the JAX
  package's ``make_train_step`` from the same weights and bases: the loss
  at each step within 1e-4 relative, the parameters after them within
  3 lr absolute (Adam's first steps turn float32 noise in tiny gradients
  into O(lr) moves). The JAX step runs op by op (``jax.disable_jit``): on
  these batches its jitted step's own logits move by up to 1.4e-3 (EM at
  tau = 0.05 amplifies XLA's fused rounding), and its losses part from the
  eager ones by 6.5e-3 at the second step; op by op the port's logits
  agree to 6e-7.
The model is the tiny one of ``test_torch_port_train.py``; the port runs
on one PyTorch thread.
"""

import dataclasses
import importlib.util
import os
import signal

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swem_tpu.config import DataConfig as JaxDataConfig
from swem_tpu.config import LossConfig as JaxLossConfig
from swem_tpu.config import ModelConfig as JaxModelConfig
from swem_tpu.config import SolverConfig as JaxSolverConfig
from swem_tpu.config import SWEMConfig as JaxSWEMConfig
from swem_tpu.data.factory import build_train_loader as jax_build_train_loader
from swem_tpu.data.palette import davis_palette, save_seg_mask
from swem_tpu.io.torch_import import convert_resnet_state_dict
from swem_tpu.models import em as jem
from swem_tpu.train.solver import make_optimizer as jax_make_optimizer
from swem_tpu.train.trainer import TrainState as JaxTrainState
from swem_tpu.train.trainer import make_train_step as jax_make_train_step
from swem_tpu.utils import AvgMeter as JaxAvgMeter
from swem_tpu_torch.config import DataConfig, LossConfig, ModelConfig, SolverConfig, SWEMConfig
from swem_tpu_torch.data.factory import build_train_loader
from swem_tpu_torch.io.checkpoint import STATE_FILE, VARIABLES_FILE, init_backbones
from swem_tpu_torch.io.jax_import import jax_to_state_dict
from swem_tpu_torch.models import em
from swem_tpu_torch.models.resnet import make_stages
from swem_tpu_torch.models.swem import SWEM
from swem_tpu_torch.train import __main__ as cli
from swem_tpu_torch.train import trainer
from swem_tpu_torch.train.loop import Trainer
from swem_tpu_torch.utils import AvgMeter
from _torch_port_util import tiny_pair
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse fixture)
from test_factory import build_roots

TRAIN_DIMS = dict(backbone="resnet18", keydim=8, valdim=16, num_bases=4, num_em_iters=2,
                  topl=2, max_objs=2, mdim=16)
KEY = jax.random.PRNGKey(5)


def build_static_root(root, n=4, size=(60, 70)):
    """An STCN_PreTrain-shaped tree: ``n`` FSS images with one object each."""
    rng = np.random.default_rng(1)
    pal = davis_palette()
    jdir = os.path.join(root, "STCN_PreTrain", "JPEGImages", "FSS")
    adir = os.path.join(root, "STCN_PreTrain", "Annotations", "FSS")
    os.makedirs(jdir)
    os.makedirs(adir)
    from PIL import Image

    for i in range(n):
        Image.fromarray((rng.random(size + (3,)) * 255).astype(np.uint8)).save(
            os.path.join(jdir, f"im{i}.jpg"))
        lab = np.zeros(size, np.uint8)
        lab[10 + i:40, 15:50 - i] = 1
        save_seg_mask(lab, os.path.join(adir, f"im{i}.png"), pal)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("train_data"))
    build_roots(base)  # DAVIS and YouTube-VOS train layouts, 2 videos each
    build_static_root(base)
    return base


def data_kw(root, **kw):
    return dict(data_root=root, vid_crop_size=(32, 32), max_num_objs=2, batch_size=2,
                num_workers=0, davis_samples_per_video=2, pretrain_sets=("FSS",),
                pretrain_set_ratio=(1,), **kw)


def solver_kw(stage, **kw):
    return dict(stage=stage, davis_iters=(3, 6), maintrain_iters=(3, 6), pretrain_iters=(3, 6),
                **kw)


def port_cfg(root, log_dir=None, stage=1, data=None, solver=None, **kw):
    return SWEMConfig(model=ModelConfig(**TRAIN_DIMS),
                      data=DataConfig(**data_kw(root, **(data or {}))),
                      solver=SolverConfig(**solver_kw(stage, **(solver or {}))),
                      loss=LossConfig(bs_period=(1000, 2000)),
                      log_dir=log_dir or root, exp_name="porttest",
                      **{"log_period": 2, "save_period": 3, "vis_period": 2, **kw})


def take(loader, n):
    it = iter(loader)
    out = [next(it) for _ in range(n)]
    loader.close()
    return out


# ------------------------------------------------------------- the data --
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_loader_batches_equal_jax(data_root, stage):
    """Two batches from iteration 4 on, every key bit-equal."""
    jcfg = JaxSWEMConfig(data=JaxDataConfig(**data_kw(data_root)),
                         solver=JaxSolverConfig(**solver_kw(stage)))
    ref = take(jax_build_train_loader(jcfg, start_iter=4), 2)
    got = take(build_train_loader(port_cfg(data_root, stage=stage), start_iter=4), 2)
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (stage, k)


def test_loader_pool_matches_serial(data_root):
    """Two spawned workers give the in-process batches; a second iterator
    stops the first one's producer, and ``close`` stops the second's within
    its 5 s join (a producer waiting on the pool polls the stop event)."""
    cfg = port_cfg(data_root, stage=3)
    serial = take(build_train_loader(cfg), 2)
    loader = build_train_loader(dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, num_workers=2)))
    first = iter(loader)
    next(first)
    old = loader._thread
    again = iter(loader)
    next(again)
    assert not old.is_alive()
    loader.close()
    assert loader._thread is None
    pool = take(build_train_loader(dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, num_workers=2))), 2)
    for a, b in zip(pool, serial):
        assert all(np.array_equal(a[k], b[k]) for k in b)



def test_loader_close_lets_the_workers_finish(data_root):
    """``close`` right after a batch, while the workers build the next ones:
    the batches in flight finish and every worker exits on its own (exit
    code 0). A worker killed while it sends a sample (``Pool.terminate``)
    can leave the result pipe's lock taken, and the pool's shutdown then
    waits on it for ever."""
    cfg = port_cfg(data_root, stage=3)
    loader = build_train_loader(dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, num_workers=2)))
    batches = iter(loader)
    next(batches)
    workers = list(loader._pool._pool)
    loader.close()
    assert loader._pool is None and loader._thread is None
    assert [w.exitcode for w in workers] == [0, 0]

def test_avg_meter_matches_jax():
    ours, ref = AvgMeter(3), JaxAvgMeter(3)
    for v in (1.0, 4.0, 2.5, 7.0, -1.0):
        ours.update(v)
        ref.update(v)
        assert (ours.avg, ours.global_avg, ours.count) == (ref.avg, ref.global_avg, ref.count)


# ---------------------------------------------------------- the trainer --
def params_of(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_trainer_resume_is_bit_equal(data_root, tmp_path):
    """6 steps in one run equal 3 steps, the checkpoint written when the run
    is stopped there, and 3 resumed steps: weights and optimizer state bit
    for bit. The first run writes both checkpoint files and, where
    tensorboardX imports, its logs."""
    whole = Trainer(port_cfg(data_root, str(tmp_path / "a")), device="cpu")
    state = whole.train()
    assert state.step == 6
    ckpt = os.path.join(whole.exp_dir, "checkpoints")
    assert {STATE_FILE, VARIABLES_FILE} <= set(os.listdir(ckpt))
    if importlib.util.find_spec("tensorboardX") is not None:
        assert any("tfevents" in f for f in os.listdir(os.path.join(whole.exp_dir, "tb")))

    half = Trainer(port_cfg(data_root, str(tmp_path / "b"), save_period=100), device="cpu")
    step = half.train_step

    def stop_after_three(st, *a, **kw):
        out = step(st, *a, **kw)
        if st.step == 3:
            half._preempt_signum = signal.SIGTERM  # what the handler records
        return out

    half.train_step = stop_after_three
    assert half.train().step == 3
    resumed = Trainer(port_cfg(data_root, str(tmp_path / "b"), resume=os.path.join(
        half.exp_dir, "checkpoints"), from_scratch=False), device="cpu")
    assert resumed.state.step == 3
    assert resumed.train().step == 6
    a, b = params_of(whole.model), params_of(resumed.model)
    assert all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = whole.state.optimizer.state_dict(), resumed.state.optimizer.state_dict()
    for i, s in sa["state"].items():
        assert all(torch.equal(s[k], sb["state"][i][k]) for k in s)
    assert whole.state.scheduler.get_last_lr() == resumed.state.scheduler.get_last_lr()

    # weights only: the schedule restarts at 0 with variables.pth's weights
    fresh = Trainer(port_cfg(data_root, str(tmp_path / "c"), resume=ckpt, from_scratch=True),
                    device="cpu")
    assert fresh.state.step == 0 and not fresh.state.optimizer.state
    c = params_of(fresh.model)
    assert all(torch.equal(a[k], c[k]) for k in a)


def test_sigterm_checkpoints_and_resumes(data_root, tmp_path):
    """SIGTERM during a step checkpoints at the next step boundary and
    returns; the previous handler comes back; --resume finishes the run."""
    tr = Trainer(port_cfg(data_root, str(tmp_path), save_period=100), device="cpu")
    step, calls = tr.train_step, []

    def step_with_preemption(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(*a, **kw)

    tr.train_step = step_with_preemption
    handler = signal.getsignal(signal.SIGTERM)
    assert tr.train().step == 2 and len(calls) == 2
    assert tr._preempt_signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is handler
    ckpt = os.path.join(tr.exp_dir, "checkpoints")
    assert torch.load(os.path.join(ckpt, STATE_FILE), weights_only=True)["step"] == 2
    again = Trainer(port_cfg(data_root, str(tmp_path), save_period=100, resume=ckpt,
                             from_scratch=False), device="cpu")
    assert again.state.step == 2 and again.train().step == 6


def test_resume_widens_a_single_object_checkpoint(data_root, tmp_path):
    """Weights-only resume from a single-object ``.pth`` (4-channel value
    conv1) into a multi-object trainer widens conv1 as the evaluator does;
    an orbax directory raises."""
    so = SWEM(dataclasses.replace(ModelConfig(**TRAIN_DIMS), single_object=True, max_objs=1),
              device="cpu").init_weights(7)
    path = str(tmp_path / "so.pth")
    torch.save(so.state_dict(), path)
    tr = Trainer(port_cfg(data_root, str(tmp_path), resume=path), device="cpu")
    w = tr.model.state_dict()["value_encoder.conv1.weight"]
    assert w.shape[1] == 5 and torch.equal(w[:, :4], so.state_dict()["value_encoder.conv1.weight"])
    orbax = tmp_path / "orbax_ckpt"
    orbax.mkdir()
    with pytest.raises(ValueError, match="orbax"):
        Trainer(port_cfg(data_root, str(tmp_path), resume=str(orbax)), device="cpu")


def torchvision_resnet18(seed: int) -> dict:
    """A torchvision-shaped resnet18 state_dict of random numbers, layer4
    and fc included (the converter drops them)."""
    g = torch.Generator().manual_seed(seed)
    stages = torch.nn.ModuleList(make_stages("resnet18", bias=False))
    sd = {"conv1.weight": torch.randn((64, 3, 7, 7), generator=g)}
    for name in ("bn1", ):
        for leaf in ("weight", "bias", "running_mean"):
            sd[f"{name}.{leaf}"] = torch.randn(64, generator=g)
        sd[f"{name}.running_var"] = torch.rand(64, generator=g) + 0.5
        sd[f"{name}.num_batches_tracked"] = torch.tensor(7)
    for i, stage in enumerate(stages):
        for k, v in stage.state_dict().items():
            sd[f"layer{i + 1}.{k}"] = (torch.rand(v.shape, generator=g) + 0.5 if
                                       k.endswith("running_var") else
                                       torch.randn(v.shape, generator=g))
    sd["layer4.0.conv1.weight"] = torch.randn((512, 256, 3, 3), generator=g)
    sd["fc.weight"], sd["fc.bias"] = torch.randn((1000, 512), generator=g), torch.zeros(1000)
    return sd


def test_backbone_init_matches_jax_converter(tmp_path):
    """``--backbone_init key.pth,value.pth``: the key and value trunks take
    what the JAX package's ``convert_resnet_state_dict`` gives (the value
    trunk with two orthogonal mask channels and zero conv biases), bit for
    bit; every other weight stays."""
    paths = [str(tmp_path / f"{n}.pth") for n in ("key", "value")]
    sds = [torchvision_resnet18(s) for s in (1, 2)]
    for p, sd in zip(paths, sds):
        torch.save(sd, p)
    model = SWEM(ModelConfig(**TRAIN_DIMS), device="cpu").init_weights(0)
    before = params_of(model)
    init_backbones(model, *paths)
    np_sd = [{k: v.numpy() for k, v in sd.items()} for sd in sds]
    key = convert_resnet_state_dict(np_sd[0])
    value = convert_resnet_state_dict(np_sd[1], extra_chan=2, add_zero_conv_biases=True)
    ref = jax_to_state_dict({
        "params": {"key_encoder": {"trunk": key["params"]},
                   "value_encoder": {"trunk": value["params"]}},
        "batch_stats": {"key_encoder": {"trunk": key["batch_stats"]},
                        "value_encoder": {"trunk": value["batch_stats"]}}})
    after = params_of(model)
    assert len(ref) > 100
    for k, v in ref.items():
        assert torch.equal(after[k], v), k
    assert all(torch.equal(after[k], before[k]) for k in after if k not in ref)


def test_cli_trains_checkpoints_and_resumes_on_the_cpu(data_root, tmp_path, monkeypatch):
    args = ["--device", "cpu", "--stage", "2", "--data_root", data_root, "--backbone",
            "resnet18", "--key_dim", "8", "--val_dim", "16", "--num_bases", "4", "--em_iters",
            "2", "--top_l", "2", "--crop_size", "32", "--batch_size", "2", "--num_workers", "0",
            "--log_dir", str(tmp_path), "--exp", "cli", "--log_period", "1", "--save_period",
            "2", "--vis_period", "0"]
    state = cli.main(args + ["--total_iters", "2", "3"])
    assert state.step == 3
    ckpt = os.path.join(str(tmp_path), "SWEM", "S2", "cli", "checkpoints")
    state = cli.main(args + ["--total_iters", "2", "5", "--resume", ckpt])  # not from scratch
    assert state.step == 5
    # the multi-process flags join a process group: --distributed alone the
    # environment's (none here), the three rendezvous flags only together
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for flag, match in ((["--distributed"], "RANK"),
                        (["--coordinator", "localhost:1234"], "go together"),
                        (["--num_processes", "2"], "go together")):
        with pytest.raises(ValueError, match=match):
            cli.main(args + flag)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(args[2:])  # no --device: CUDA, raising without a card


# ------------------------------------------------------ the whole slice --
def test_three_steps_match_jax_make_train_step(data_root):
    """3 steps on the loader's batches, the port's ``make_train_step``
    against the JAX package's, op by op, from the same weights and, each
    step, the same bases (the JAX draw from ``fold_in(rng, step)``)."""
    lr = 2e-4
    jcfg = JaxSWEMConfig(model=JaxModelConfig(**TRAIN_DIMS),
                         solver=JaxSolverConfig(**solver_kw(1, base_lr=lr)),
                         loss=JaxLossConfig(bs_period=(1000, 2000)))
    jmodel, variables, port = tiny_pair(seed=3, jcfg=jcfg.model)
    tx, _ = jax_make_optimizer(jcfg.solver)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(params=params, batch_stats=variables["batch_stats"],
                           opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    jstep = jax_make_train_step(jmodel, jcfg, tx)
    cfg = port_cfg(data_root, solver={"base_lr": lr})
    state = trainer.create_train_state(port, cfg.solver)
    step = trainer.make_train_step(cfg)
    batches = take(build_train_loader(cfg), 3)
    for i, b in enumerate(batches):
        b.pop("skips")
        with jax.disable_jit():
            jstate, jl = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()}, KEY)
        mem = jem.fresh_memory(jax.random.fold_in(KEY, i), 2, 2, 8, 16, 4)
        bases = em.Bases(*(torch.tensor(np.asarray(a)) for a in (
            mem.first.kappa, mem.first.nu, mem.first.zita)))
        out = step(state, trainer.batch_to_device(b, "cpu"), bases=bases)
        np.testing.assert_allclose(float(out["total_loss"]), float(jl["total_loss"]), rtol=1e-4)
    assert state.step == int(jstate.step) == 3
    ref = jax_to_state_dict({"params": jax.device_get(jstate.params), "batch_stats": {}})
    got = dict(port.named_parameters())
    worst = max(float((got[k].detach() - v).abs().max()) for k, v in ref.items())
    print(f"largest parameter difference after 3 steps: {worst:.3e} (3 lr = {3 * lr:.1e})")
    assert worst <= 3 * lr
