"""TPU checkpoints into the port: ``scripts/orbax_to_pth.py`` and the
optimizer-state bridge ``swem_tpu_torch.io.jax_import.train_snapshot``, on
the CPU.

- Flagship width: the JAX trainer's abstract ``TrainState`` of the default
  ``ModelConfig`` (AdamW) filled with seeded numpy leaves (no JAX init),
  saved with orbax and converted by the script's CLI: every tensor of
  ``variables.pth`` and every moment of ``state.pth`` exactly
  ``jax_to_state_dict`` of the same leaves; step, LR and schedule.
- Small width (``test_torch_port_train.py``'s tamed model, its batch), for
  AdamW, Adam and SGD at lr 2e-5 (S3's), weight decay 5e-2: two
  ``make_train_step`` steps (a milestone at step 2), saved with orbax and
  converted. The resumed ``Trainer``: step 2, the LR past the milestone
  (optax's float32 value to 1e-6), JAX's moments bit for bit. Then one more
  step on each side on the same batch and bases:
  - against JAX's step: the loss within 1e-5 relative; the updates and the
    moments within 1e-2 global relative L2 (measured: updates 2.1e-3 AdamW,
    6.0e-5 Adam, 2.2e-4 SGD; moments 3.4e-5, 1.8e-7, 1.1e-4). Per
    parameter they part further where the step's float32 noise is the
    signal: a channel gate whose one hidden unit sits at the ReLU's kink
    (the port's gradient 0, JAX's not; AdamW's update 44% apart) and batch
    norm scales of ~1 whose update is two float32 ulps (3%);
  - the bridge alone: the port's own gradients of that step through
    optax's ``update`` from the converted state give the port's
    parameters and moments (1e-6 relative, moments 1e-6 of their largest
    entry), as ``test_optimizers_match_optax`` holds the optimizers.
  The JAX steps run jitted, one compile per optimizer (op by op the first
  step alone took 75 s on this host, every primitive compiled); on this
  batch with the tamed weights the jitted step agrees with the port's.
- A single-object ``variables`` checkpoint comes out widened; a
  ``variables``-only directory resumes the port's ``Trainer`` at step 0
  with a fresh optimizer; a converted ``state`` at the converted step.
- Moments with a foreign key, a missing key or a wrong shape raise.
"""

import dataclasses
import functools
import importlib.util
from collections import Counter
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from swem_tpu.config import ModelConfig as JaxModelConfig
from swem_tpu.config import SolverConfig as JaxSolverConfig
from swem_tpu.config import SWEMConfig as JaxSWEMConfig
from swem_tpu.io.checkpoint import save_checkpoint
from swem_tpu.io.checkpoint import widen_value_encoder as jax_widen
from swem_tpu.io.torch_import import convert_swem_state_dict
from swem_tpu.models import em as jem
from swem_tpu.models.swem import SWEM as JaxSWEM
from swem_tpu.train.solver import lr_schedule
from swem_tpu.train.solver import make_optimizer as jax_make_optimizer
from swem_tpu.train.trainer import TrainState, create_train_state
from swem_tpu.train.trainer import make_train_step as jax_make_train_step
from swem_tpu_torch.config import DataConfig, ModelConfig, SolverConfig, SWEMConfig
from swem_tpu_torch.io.checkpoint import STATE_FILE, VARIABLES_FILE
from swem_tpu_torch.io.jax_import import jax_to_state_dict, moments_state_dict, train_snapshot
from swem_tpu_torch.models import em
from swem_tpu_torch.models.swem import SWEM
from swem_tpu_torch.train import trainer
from swem_tpu_torch.train.loop import Trainer
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse fixture)
from _torch_port_util import tiny_pair
from test_torch_port_train import KEY, TRAIN_DIMS, B, N, make_batch

ROOT = Path(__file__).resolve().parents[1]
SOLVER = dict(base_lr=2e-5, weight_decay=5e-2, davis_iters=(2, 10), stage=1, gamma=0.1)


def load_script():
    spec = importlib.util.spec_from_file_location("orbax_to_pth",
                                                  ROOT / "scripts" / "orbax_to_pth.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def moments_by_param(snap: dict, model: torch.nn.Module) -> dict:
    """A snapshot's optimizer state keyed by parameter name."""
    names = [n for n, _ in model.named_parameters()]
    return {names[i]: s for i, s in snap["optimizer"]["state"].items()}


# ---------------------------------------------------------- flagship --
def test_flagship_state_converts_exactly(tmp_path):
    """The default flags (the flagship model, AdamW, stage 0) through the
    script's CLI: weights, batch statistics and both moments bit for bit."""
    cfg = JaxModelConfig()
    tx, _ = jax_make_optimizer(JaxSolverConfig())
    abstract = jax.eval_shape(lambda: create_train_state(
        JaxSWEM(cfg), jax.random.PRNGKey(0), tx, jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 64, 64, cfg.max_objs + 1))))
    rng = np.random.default_rng(13)
    count = 150_001  # past stage 0's milestone: the LR has taken gamma

    def fill(leaf):
        if leaf.dtype == jnp.int32:
            return np.asarray(count, np.int32)
        return rng.random(leaf.shape, dtype=np.float32)

    state = jax.tree.map(fill, abstract)
    src = tmp_path / "ckpt"
    save_checkpoint(str(src / "state"), state)
    save_checkpoint(str(src / "variables"), {"params": state.params,
                                             "batch_stats": state.batch_stats})
    written = load_script().main(["--src", str(src), "--dst", str(tmp_path / "out")])
    assert written["step"] == count

    want = jax_to_state_dict({"params": state.params, "batch_stats": state.batch_stats})
    got = torch.load(tmp_path / "out" / VARIABLES_FILE, weights_only=True)
    snap = torch.load(tmp_path / "out" / STATE_FILE, weights_only=True)
    assert got.keys() == snap["model"].keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v) and torch.equal(snap["model"][k], v), k
    adam = state.opt_state[0]
    mu, nu = moments_state_dict(adam.mu), moments_state_dict(adam.nu)
    with torch.device("meta"):
        model = SWEM(ModelConfig(), device="meta")
    slots = moments_by_param(snap, model)
    assert slots.keys() == mu.keys() == nu.keys()
    for name in mu:
        s = slots[name]
        assert torch.equal(s["exp_avg"], mu[name]) and torch.equal(s["exp_avg_sq"], nu[name])
        assert s["step"].dtype == torch.float32 and float(s["step"]) == count
    assert snap["step"] == count
    assert snap["scheduler"]["last_epoch"] == count
    assert snap["scheduler"]["milestones"] == Counter({150_000: 1, 300_000: 1})
    lr = float(lr_schedule(JaxSolverConfig())(count))
    assert snap["optimizer"]["param_groups"][0]["lr"] == pytest.approx(lr, rel=1e-6)
    assert snap["scheduler"]["_last_lr"] == [snap["optimizer"]["param_groups"][0]["lr"]]


# -------------------------------------------------------- small width --
def port_config(log_dir, optimizer: str, resume=None) -> SWEMConfig:
    return SWEMConfig(model=ModelConfig(**TRAIN_DIMS), data=DataConfig(data_root=str(log_dir)),
                      solver=SolverConfig(optimizer=optimizer, **SOLVER), log_dir=str(log_dir),
                      resume=None if resume is None else str(resume), from_scratch=False)


def jax_config(optimizer: str) -> JaxSWEMConfig:
    return JaxSWEMConfig(model=JaxModelConfig(**TRAIN_DIMS),
                         solver=JaxSolverConfig(optimizer=optimizer, **SOLVER))


@functools.lru_cache(maxsize=None)
def bases_at(step: int) -> em.Bases:
    """The JAX step's initial bases at ``step`` (``fold_in(KEY, step)``)."""
    mem = jem.fresh_memory(jax.random.fold_in(KEY, step), B, N, TRAIN_DIMS["keydim"],
                           TRAIN_DIMS["valdim"], TRAIN_DIMS["num_bases"])
    return em.Bases(*(torch.tensor(np.asarray(a)) for a in (mem.first.kappa, mem.first.nu,
                                                            mem.first.zita)))


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a.double() - b.double())
                 / max(float(torch.linalg.vector_norm(b.double())), 1e-30))


@pytest.fixture(scope="module")
def tamed():
    jmodel, variables, _ = tiny_pair(seed=3, jcfg=JaxModelConfig(**TRAIN_DIMS))
    return jmodel, variables


def adam_or_trace(opt_state, optimizer: str):
    """The ``ScaleByAdamState`` or ``TraceState`` of a ``make_optimizer`` state."""
    return opt_state[0] if optimizer == "AdamW" else opt_state[1][0]


def global_rel(got: dict, ref: dict) -> float:
    """||got - ref|| / ||ref|| over every tensor of the two dicts together."""
    d2 = sum(float(torch.linalg.vector_norm(got[k].double() - ref[k].double())) ** 2 for k in ref)
    r2 = sum(float(torch.linalg.vector_norm(ref[k].double())) ** 2 for k in ref)
    return (d2 / r2) ** 0.5


@pytest.mark.parametrize("optimizer", ["AdamW", "Adam", "SGD"])
def test_resumed_step_matches_jax(tamed, tmp_path, optimizer):
    jmodel, variables = tamed
    jcfg = jax_config(optimizer)
    tx, sched = jax_make_optimizer(jcfg.solver)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    jstep = jax.jit(jax_make_train_step(jmodel, jcfg, tx))
    batch = make_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(2):
        state, _ = jstep(state, jb, KEY)
    src = tmp_path / "ckpt"
    host = jax.device_get(state)
    save_checkpoint(str(src / "state"), host)
    save_checkpoint(str(src / "variables"), {"params": host.params,
                                             "batch_stats": host.batch_stats})
    pcfg = port_config(tmp_path, optimizer, resume=tmp_path / "out")
    written = load_script().convert(str(src), str(tmp_path / "out"), jcfg, pcfg)
    assert written["step"] == 2

    # the resumed Trainer: step, LR past the milestone, JAX's moments bit for bit
    tr = Trainer(pcfg, device="cpu")
    opt = tr.state.optimizer
    assert tr.state.step == 2
    assert opt.param_groups[0]["lr"] == pytest.approx(float(sched(2)), rel=1e-6)
    assert opt.param_groups[0]["lr"] == pytest.approx(SOLVER["base_lr"] * SOLVER["gamma"])
    assert tr.state.scheduler.get_last_lr() == [opt.param_groups[0]["lr"]]
    params = dict(tr.model.named_parameters())
    kinds = {"mu": "exp_avg", "nu": "exp_avg_sq"} if optimizer != "SGD" else {
        "trace": "momentum_buffer"}
    loaded = adam_or_trace(host.opt_state, optimizer)
    for kind, slot in kinds.items():
        ref = moments_state_dict(getattr(loaded, kind))
        for n, p in params.items():
            assert torch.equal(opt.state[p][slot], ref[n]), (kind, n)
            assert opt.state[p][slot].dtype == torch.float32
        if optimizer != "SGD":
            assert all(opt.state[p]["step"].device.type == "cpu" and float(opt.state[p]["step"])
                       == 2 for p in params.values())

    # one more step on each side, on the same batch and bases
    before = {n: p.detach().clone() for n, p in params.items()}
    out = tr.train_step(tr.state, trainer.batch_to_device(batch, "cpu"), bases=bases_at(2))
    new_state, jl = jstep(state, jb, KEY)
    assert tr.state.step == int(new_state.step) == 3
    np.testing.assert_allclose(float(out["total_loss"]), float(jl["total_loss"]), rtol=1e-5)
    start = jax_to_state_dict({"params": host.params, "batch_stats": {}})
    after = jax_to_state_dict({"params": jax.device_get(new_state.params), "batch_stats": {}})
    upd_port = {n: p.detach().double() - before[n].double() for n, p in params.items()}
    upd_jax = {n: after[n].double() - start[n].double() for n in params}
    moved = adam_or_trace(jax.device_get(new_state.opt_state), optimizer)
    mom_port = {f"{kind} {n}": opt.state[p][slot] for kind, slot in kinds.items()
                for n, p in params.items()}
    mom_jax = {f"{kind} {n}": v for kind in kinds
               for n, v in moments_state_dict(getattr(moved, kind)).items()}
    per_param = sorted(((rel_l2(upd_port[n], upd_jax[n]), n) for n in params), reverse=True)
    upd_rel, mom_rel = global_rel(upd_port, upd_jax), global_rel(mom_port, mom_jax)
    print(f"{optimizer} against make_train_step: updates {upd_rel:.3e}, moments {mom_rel:.3e} "
          f"(global relative L2); per parameter, worst {per_param[:3]}")
    assert upd_rel <= 1e-2 and mom_rel <= 1e-2

    # the bridge alone: the port's own gradients through optax from the
    # converted state give the port's parameters and moments
    grads = convert_swem_state_dict({n: p.grad.numpy() for n, p in params.items()})["params"]

    @jax.jit
    def optax_step(g, opt_state, p):
        updates, opt_state = tx.update(g, opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    p3, o3 = jax.device_get(optax_step(grads, host.opt_state, host.params))
    want = jax_to_state_dict({"params": p3, "batch_stats": {}})
    for n, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=n)
    for kind, slot in kinds.items():
        ref = moments_state_dict(getattr(adam_or_trace(o3, optimizer), kind))
        for n, p in params.items():
            np.testing.assert_allclose(opt.state[p][slot].numpy(), ref[n].numpy(), rtol=1e-6,
                                       atol=1e-6 * float(ref[n].abs().max()),
                                       err_msg=f"{kind} {n}")


# ------------------------------------------- weights only, widening --
def test_single_object_variables_widen_and_resume_fresh(tamed, tmp_path):
    """A ``variables``-only checkpoint of a single-object model (4-channel
    value conv1) converts for a multi-object one with the JAX package's
    widening; the port's ``Trainer`` resumes it at step 0 with a fresh
    optimizer, and ``registry.load_state_dict`` reads the directory."""
    from swem_tpu_torch import registry

    _, variables = tamed
    params = jax.tree.map(np.asarray, variables["params"])
    conv1 = params["value_encoder"]["trunk"]["conv1"]
    conv1["kernel"] = conv1["kernel"][:, :, :4]
    src = tmp_path / "ckpt"
    save_checkpoint(str(src / "variables"), {"params": params,
                                             "batch_stats": variables["batch_stats"]})
    pcfg = port_config(tmp_path, "AdamW", resume=tmp_path / "out")
    written = load_script().convert(str(src), str(tmp_path / "out"), jax_config("AdamW"), pcfg)
    assert set(written) == {"variables"} and not (tmp_path / "out" / STATE_FILE).exists()
    want = jax_to_state_dict({"params": jax_widen(params),
                              "batch_stats": variables["batch_stats"]})
    got = torch.load(tmp_path / "out" / VARIABLES_FILE, weights_only=True)
    assert got["value_encoder.conv1.weight"].shape[1] == 5
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    tr = Trainer(pcfg, device="cpu")
    assert tr.state.step == 0 and not tr.state.optimizer.state
    assert tr.state.optimizer.param_groups[0]["lr"] == SOLVER["base_lr"]
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    loaded = registry.load_state_dict(pcfg, str(tmp_path / "out"))
    assert all(torch.equal(loaded[k], v) for k, v in want.items())
    # --weights_only skips a state that is there
    save_checkpoint(str(src / "state"), {"unused": np.zeros(1)})
    written = load_script().convert(str(src), str(tmp_path / "w"), jax_config("AdamW"), pcfg,
                                    weights_only=True)
    assert set(written) == {"variables"}


def test_foreign_moments_raise():
    cfg = ModelConfig(**TRAIN_DIMS)
    model = SWEM(cfg, device="cpu")
    sd = model.state_dict()
    ok = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    solver = SolverConfig(**SOLVER)
    snap = train_snapshot(model, solver, sd, 3, {"mu": ok, "nu": ok})
    assert snap["step"] == 3 and len(snap["optimizer"]["state"]) == len(ok)
    with pytest.raises(KeyError, match="decoder.extra.weight"):
        train_snapshot(model, solver, sd, 3, {"mu": {**ok, "decoder.extra.weight": torch.zeros(2)},
                                              "nu": ok})
    missing = dict(ok)
    missing.pop("decoder.pred.weight")
    with pytest.raises(KeyError, match="decoder.pred.weight"):
        train_snapshot(model, solver, sd, 3, {"mu": ok, "nu": missing})
    bad = {**ok, "decoder.pred.weight": torch.zeros(3, 3)}
    with pytest.raises(ValueError, match="decoder.pred.weight"):
        train_snapshot(model, solver, sd, 3, {"mu": ok, "nu": bad})
    with pytest.raises(KeyError, match="trace"):
        train_snapshot(model, solver, sd, 3, {"trace": ok})
    with pytest.raises(KeyError, match="model state"):
        train_snapshot(model, solver, {**sd, "extra.weight": torch.zeros(1)}, 3,
                       {"mu": ok, "nu": ok})
    sgd = dataclasses.replace(solver, optimizer="SGD")
    snap = train_snapshot(model, sgd, sd, 3, {"trace": ok})
    assert set(snap["optimizer"]["state"][0]) == {"momentum_buffer"}
