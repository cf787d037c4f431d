"""The port's training step against swem_tpu's, on the CPU.

Both packages run the tiny model of ``_torch_port_util.tiny_pair`` at the
JAX package's training-test widths (resnet18, keydim 8, valdim 16, L 4,
2 EM rounds, top-l 2, 2 slots; ``key_proj`` and ``decoder.pred`` scaled
down) on the same numpy batch (B 2, T 3, 32x32, uint8 frames and slot
labels), from the same initial bases (the JAX package's draw from
``fold_in(rng, step)``) and, where ``p_drop > 0``, the same keep masks. The
JAX side is computed once per module, under ``jax.jit`` (the tamed weights
keep the hard masks stable there). Tolerances, stated per test:
- each loss and its gradient: rtol 1e-5 (atol 1e-5 of the largest entry);
- the differentiable read: outputs at rtol 1e-5, atol 1e-6, gradients at
  rtol 1e-5, atol 1e-5 of the largest entry;
- the unrolled forward's logits: 1e-4 absolute on O(1) logits;
- one float32 step: the loss at 1e-5 relative, every parameter's gradient
  at ||port - jax|| <= 1e-4 ||jax|| + 1e-7;
- one bfloat16 step: logits and loss at 3e-2 of their scale, the
  gradients' global relative L2 difference at 3e-2, as PR 6's bf16
  stages are held;
- the optimizers against optax over 3 steps across a milestone: 1e-6
  relative.
The port runs on one PyTorch thread (see ``test_torch_port_eval.py``).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from swem_tpu.config import LossConfig as JaxLossConfig
from swem_tpu.config import ModelConfig as JaxModelConfig
from swem_tpu.config import SolverConfig as JaxSolverConfig
from swem_tpu.models import em as jem
from swem_tpu.models.swem import SWEM as JaxSWEM
from swem_tpu.train import losses as jlosses
from swem_tpu.train import trainer as jtrainer
from swem_tpu.train.solver import make_optimizer as jax_make_optimizer
from swem_tpu_torch.config import LossConfig, SolverConfig, SWEMConfig
from swem_tpu_torch.io.jax_import import jax_to_state_dict
from swem_tpu_torch.models import em
from swem_tpu_torch.models.swem import SWEM
from swem_tpu_torch.ops import em_kernel, read_kernel
from swem_tpu_torch.train import losses, solver, trainer
from _torch_port_util import port_cfg, t, tiny_pair
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse fixture)

B, T, H, W, N = 2, 3, 32, 32, 2
TRAIN_DIMS = dict(backbone="resnet18", keydim=8, valdim=16, num_bases=4, num_em_iters=2,
                  topl=2, max_objs=2, mdim=16)
KEY = jax.random.PRNGKey(5)


def make_batch(seed: int = 0) -> dict:
    """uint8 frames and slot labels: two boxes, the first moving; slot 2
    invalid in the second clip (one object only)."""
    rng = np.random.default_rng(seed)
    label = np.zeros((B, T, H, W), np.uint8)
    for i in range(T):
        label[:, i, 4 + 2 * i:14 + 2 * i, 4:14] = 1
    label[0, :, 18:28, 18:28] = 2
    valid = np.ones((B, N + 1), np.float32)
    valid[1, 2] = 0.0
    return {"frames": rng.integers(0, 256, (B, T, H, W, 3), dtype=np.uint8), "label": label,
            "valid_obj": valid}


def jax_step_grads(jmodel, variables, batch, step: int, p_drop_keys=False):
    """(loss dict, logits, grads) of the JAX package's step loss at ``step``."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    mem_rng = jax.random.fold_in(KEY, step)
    criterion = jlosses.make_criterion(JaxLossConfig())

    def loss_fn(params):
        frames, init_mask, label = jtrainer._model_inputs(jb, N + 1)
        logits = jtrainer._unrolled_forward(
            jmodel, {"params": params, "batch_stats": variables["batch_stats"]}, frames,
            init_mask, jb["valid_obj"], mem_rng)
        out = criterion(logits, label[:, 1:], jnp.asarray(step, jnp.int32), jb["valid_obj"])
        return out["total_loss"], (out, logits)

    (_, (out, logits)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return out, np.asarray(logits), jax_to_state_dict({"params": grads, "batch_stats": {}})


def jax_draws(jmodel, variables, step: int, p_drop: float):
    """The JAX package's initial bases at ``step`` and, for ``p_drop > 0``,
    the keep masks its ``match`` draws (the top-level 'memdrop' stream of
    ``fold_in(mem_rng, i)``), as the port's types."""
    cfg = jmodel.cfg
    mem_rng = jax.random.fold_in(KEY, step)
    mem = jem.fresh_memory(mem_rng, B, N, cfg.keydim, cfg.valdim, cfg.num_bases)
    bases = em.Bases(t(mem.first.kappa), t(mem.first.nu), t(mem.first.zita))
    if p_drop <= 0:
        return bases, None
    keeps = []
    for i in range(1, T):
        key = jmodel.apply(variables, method=lambda m: m.make_rng("memdrop"),
                           rngs={"memdrop": jax.random.fold_in(mem_rng, i)})
        keeps.append(t(jax.random.uniform(key, (B, N, 1, 2 * cfg.num_bases, 1)) > p_drop))
    return bases, keeps


@pytest.fixture(scope="module")
def f32():
    jcfg = JaxModelConfig(**TRAIN_DIMS)
    jmodel, variables, port = tiny_pair(seed=3, jcfg=jcfg)
    batch = make_batch()
    out, logits, grads = jax_step_grads(jmodel, variables, batch, 0)
    return dict(jmodel=jmodel, variables=variables, port=port, batch=batch, out=out,
                logits=logits, grads=grads, draws=jax_draws(jmodel, variables, 0, 0.0))


def port_forward(port, batch, bases, keeps=None, remat=None):
    tb = trainer.batch_to_device(batch, "cpu")
    frames, init_mask, label = trainer._model_inputs(tb, N + 1)
    with torch.enable_grad():
        logits = trainer._unrolled_forward(port, frames, init_mask, tb["valid_obj"].float(),
                                           bases, keeps, remat=remat)
    return logits, label


def port_step(port, batch, bases, keeps=None, remat=None, cfg=None):
    """One port train step on a copy of ``port``: (losses, grads by name, the copy)."""
    model = SWEM(port.cfg, device="cpu")
    model.load_state_dict(port.state_dict())
    cfg = cfg or SWEMConfig(model=port.cfg)
    state = trainer.create_train_state(model, cfg.solver)
    step = trainer.make_train_step(cfg, remat=remat)
    out = step(state, trainer.batch_to_device(batch, "cpu"), bases=bases, keeps=keeps)
    return out, {n: p.grad.clone() for n, p in model.named_parameters()}, model


# ---------------------------------------------------------------- losses --
def loss_inputs(case: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    Bl, Tl, Hl, Wl, C = 2, 2, 8, 8, 3
    logits = rng.standard_normal((Bl, Tl, Hl, Wl, C)).astype(np.float32)
    valid = np.ones((Bl, C), np.float32)
    valid[0, -1] = 0.0  # an invalid slot in clip 0
    target = rng.integers(0, C, (Bl, Tl, Hl, Wl)).astype(np.int32)
    target[0] = np.minimum(target[0], C - 2)
    if case == "saturated":
        # the aggregation's clamp at random init: logits at +-log((1-1e-7)/1e-7),
        # so that many pixels share one CE value exactly (ties at the threshold)
        sat = np.float32(np.log((1 - 1e-7) / 1e-7))
        logits = np.where(rng.random(logits.shape) < 0.5, -sat, sat).astype(np.float32)
    return logits, target, valid


LOSS_CASES = [
    ("pixel_ce", "normal", 0), ("plain_ce", "normal", 0),
    ("bootstrapped_ce", "normal", 0), ("bootstrapped_ce", "normal", 45000),
    ("bootstrapped_ce", "normal", 90000), ("bootstrapped_ce", "saturated", 90000),
    ("bootstrapped_ce", "saturated", 31234), ("mask_iou_loss", "normal", 0),
    ("lovasz_softmax_loss", "normal", 0), ("lovasz_softmax_loss", "saturated", 0),
    ("lovasz_hinge_loss", "normal", 0), ("criterion_iou", "normal", 50000),
    ("criterion_lovasz", "saturated", 50000),
]


def _loss_call(mod, name: str, it: int, logits, target, valid, jax_side: bool):
    warm = dict(start_warm=20000, end_warm=70000, top_p=0.3)
    it_arg = jnp.asarray(it, jnp.int32) if jax_side else it
    if name == "pixel_ce":
        return mod.pixel_ce(logits, target, valid).sum()
    if name in ("plain_ce", "bootstrapped_ce"):
        return getattr(mod, name)(logits, target, it_arg, valid, **warm)[0]
    if name in ("mask_iou_loss", "lovasz_softmax_loss"):
        return getattr(mod, name)(logits, target, valid)
    if name == "lovasz_hinge_loss":
        return mod.lovasz_hinge_loss(logits[..., 1], target > 0)
    aux = name.split("_")[1]
    cfg = (JaxLossConfig if jax_side else LossConfig)(aux=aux, aux_ratio=0.7)
    return mod.make_criterion(cfg)(logits, target, it_arg, valid)["total_loss"]


@pytest.mark.parametrize("name,case,it", LOSS_CASES)
def test_loss_values_and_gradients(name, case, it):
    logits, target, valid = loss_inputs(case)
    ref, ref_g = jax.value_and_grad(
        lambda lg: _loss_call(jlosses, name, it, lg, jnp.asarray(target), jnp.asarray(valid),
                              True))(jnp.asarray(logits))
    lg = torch.tensor(logits, requires_grad=True)
    got = _loss_call(losses, name, it, lg, torch.tensor(target), torch.tensor(valid), False)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    ref_g = np.asarray(ref_g)
    np.testing.assert_allclose(lg.grad.numpy(), ref_g, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref_g).max()))


@pytest.mark.parametrize("it", [0, 19999, 20000, 45000, 69999, 70000, 123456])
def test_bootstrap_fraction_is_float32_exact(it):
    """The host fraction and its pixel count equal the JAX package's float32 ones."""
    ref = float(jlosses.bootstrap_fraction(jnp.asarray(it, jnp.int32), 20000, 70000, 0.3))
    assert losses.bootstrap_fraction(it, 20000, 70000, 0.3) == ref
    k_ref = int(jnp.floor(1024 * jnp.asarray(ref, jnp.float32)).astype(jnp.int32))
    assert int(np.floor(np.float32(1024) * np.float32(ref))) == k_ref


def test_bootstrapped_ties_take_memory_order():
    """With every CE equal, exactly the first k pixels of each frame carry the gradient."""
    logits = np.zeros((1, 1, 4, 4, 2), np.float32)
    target = np.zeros((1, 1, 4, 4), np.int32)
    lg = torch.tensor(logits, requires_grad=True)
    loss, p = losses.bootstrapped_ce(lg, torch.tensor(target), 90000)
    loss.backward()
    k = int(np.floor(np.float32(16) * np.float32(p)))
    g = lg.grad[0, 0, ..., 0].flatten()
    assert p == pytest.approx(0.3) and k == 4
    assert (g[:k] != 0).all() and (g[k:] == 0).all()


# ------------------------------------------------------- the memory read --
def read_inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    Bq, Nq, P, Ck, Lm, Cv = 2, 3, 12, 8, 8, 6
    qk = rng.standard_normal((Bq, P, Ck)).astype(np.float32)
    mk = rng.standard_normal((Bq, Nq, 2, Ck, Lm)).astype(np.float32)
    mv = rng.standard_normal((Bq, Nq, 2, Cv, Lm)).astype(np.float32)
    valid = np.ones((Bq, Nq, 2, Lm), bool)
    valid[:, 0, :, Lm // 2:] = False  # object 0: update bank not yet valid
    valid[:, 2] = False  # object 2: never seen
    return qk, mk, mv, valid


@pytest.mark.parametrize("p_drop,topl", [(0.0, 2), (0.5, 2), (0.0, 6)])
def test_differentiable_read_matches(p_drop, topl):
    """``read_memory(train=True)`` against the JAX package's differentiable
    XLA read: outputs at rtol 1e-5 / atol 1e-6, and gradients w.r.t. qk, mk
    and mv of a random projection of both outputs at rtol 1e-5 / atol 1e-5
    of the largest entry (the l2 norms' backward cancels). The masked
    bases' exact zeros (an object never seen included) give finite,
    equal gradients; at top-l 6 an object with 4 valid bases of 8 per
    branch takes tied zeros into its feature."""
    qk, mk, mv, valid = read_inputs()
    Bq, Nq, _, _, Lm = mk.shape
    drop_rng = jax.random.PRNGKey(11) if p_drop else None
    keep = None
    if p_drop:
        keep = np.asarray(jax.random.uniform(drop_rng, (Bq, Nq, 1, Lm, 1)) > p_drop)
    rng = np.random.default_rng(1)
    w_out = rng.standard_normal((Bq, Nq, qk.shape[1], mv.shape[3])).astype(np.float32)
    w_S = rng.standard_normal((Bq, Nq, qk.shape[1], 2 * topl)).astype(np.float32)

    def jax_obj(q, k, v):
        out, S = jem.read_memory(q, k, v, jnp.asarray(valid), tau=0.05, topl=topl, p_drop=p_drop,
                                 drop_rng=drop_rng, differentiable=True)
        return jnp.sum(out * w_out) + jnp.sum(S * w_S), (out, S)

    (_, (ref_out, ref_S)), ref_g = jax.value_and_grad(jax_obj, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(qk), jnp.asarray(mk), jnp.asarray(mv))
    q, k, v = (torch.tensor(a, requires_grad=True) for a in (qk, mk, mv))
    out, S = em.read_memory(q, k, v, torch.tensor(valid), tau=0.05, topl=topl, train=True,
                            keep=None if keep is None else torch.tensor(keep))
    ((out * torch.tensor(w_out)).sum() + (S * torch.tensor(w_S)).sum()).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(S.detach().numpy(), np.asarray(ref_S), rtol=1e-5, atol=1e-6)
    assert not out[:, 2].any()
    for name, got, ref in zip(("qk", "mk", "mv"), (q.grad, k.grad, v.grad), ref_g):
        assert torch.isfinite(got).all(), name
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()), err_msg=name)
    assert read_kernel.launches == 0


def test_topk_feature_gradient_matches_custom_vjp():
    """``_perm_inv_feat``'s autograd backward (``topk``'s scatter) equals the
    JAX package's hand-built ``_topk_vals`` VJP. Where the top-l reaches a
    row's exact-zero masked bases, the two may pick other zeros of the tie:
    the valid bases' gradients are equal, and each row's zeros receive the
    same total (the read's ``where`` then drops it)."""
    rng = np.random.default_rng(2)
    exp_aff = rng.random((2, 2, 2, 6, 5)).astype(np.float32) + 0.1
    masked = np.zeros(exp_aff.shape, bool)
    masked[0, 0, :, 2:] = True  # 2 valid bases of 6: the top-3 takes one zero of four
    masked[1, 1] = True  # an object never seen: all zeros
    exp_aff[masked] = 0.0
    w = rng.standard_normal((2, 2, 5, 6)).astype(np.float32)
    ref, ref_g = jax.value_and_grad(
        lambda x: jnp.sum(jem._perm_inv_feat_sorted(x, 3) * w))(jnp.asarray(exp_aff))
    x = torch.tensor(exp_aff, requires_grad=True)
    got = (em._perm_inv_feat(x, 3) * torch.tensor(w)).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    g, ref_g = x.grad.numpy(), np.asarray(ref_g)
    np.testing.assert_allclose(g[~masked], ref_g[~masked], rtol=1e-5, atol=1e-6)
    assert np.isfinite(g).all()
    zero_sum = lambda a: np.where(masked, a, 0.0).sum(axis=3)  # noqa: E731
    finite = np.isfinite(zero_sum(ref_g))
    assert finite[0, 0].all() and not finite[1, 1].any()
    np.testing.assert_allclose(zero_sum(g)[finite], zero_sum(ref_g)[finite], rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------------------- the step --
def test_unrolled_forward_logits_match(f32):
    bases, _ = f32["draws"]
    logits, _ = port_forward(f32["port"], f32["batch"], bases)
    assert logits.shape == (B, T - 1, H, W, N + 1)
    np.testing.assert_allclose(logits.detach().numpy(), f32["logits"], rtol=0, atol=1e-4)


def test_train_step_loss_and_gradients_match(f32):
    """One float32 step: the loss at 1e-5 relative, each parameter's
    gradient at ||d|| <= 1e-4 ||g|| + 1e-7 against ``jax.grad``."""
    bases, _ = f32["draws"]
    out, grads, _ = port_step(f32["port"], f32["batch"], bases)
    for k in ("total_loss", "main_loss", "aux_loss"):
        np.testing.assert_allclose(float(out[k]), float(f32["out"][k]), rtol=1e-5, err_msg=k)
    assert out["p"] == float(f32["out"]["p"]) == 1.0
    ref = f32["grads"]
    assert set(grads) == set(ref)
    worst = max(float(torch.linalg.vector_norm(grads[n] - ref[n])
                      / (1e-4 * torch.linalg.vector_norm(ref[n]) + 1e-7)) for n in ref)
    print(f"worst gradient error over its limit: {worst:.3f}")
    assert worst <= 1.0
    assert em_kernel.launches == read_kernel.launches == 0


def test_train_step_bf16_matches():
    """One bfloat16 step: logits and loss at 3e-2 of their scale, the
    gradients' global relative L2 difference at 3e-2."""
    jcfg = JaxModelConfig(**TRAIN_DIMS, dtype="bfloat16")
    jmodel, variables, port = tiny_pair(seed=3, jcfg=jcfg)
    batch = make_batch()
    out_ref, logits_ref, grads_ref = jax_step_grads(jmodel, variables, batch, 0)
    bases, _ = jax_draws(jmodel, variables, 0, 0.0)
    logits, _ = port_forward(port, batch, bases)
    err = float(np.abs(logits.detach().float().numpy() - logits_ref).max()
                / np.abs(logits_ref).max())
    out, grads, _ = port_step(port, batch, bases)
    d2 = sum(float(torch.linalg.vector_norm(grads[n] - grads_ref[n]) ** 2) for n in grads_ref)
    g2 = sum(float(torch.linalg.vector_norm(g) ** 2) for g in grads_ref.values())
    rel = (d2 / g2) ** 0.5
    loss_rel = abs(float(out["total_loss"]) - float(out_ref["total_loss"])) / float(
        out_ref["total_loss"])
    print(f"bf16 step: logits {err:.2e}, loss {loss_rel:.2e}, gradients {rel:.2e}")
    assert err <= 3e-2 and loss_rel <= 3e-2 and rel <= 3e-2


def test_train_step_p_drop_matches(f32):
    """p_drop = 0.5: the JAX package's 'memdrop' keep masks handed to the
    port give its logits at 1e-4 and its loss at 1e-5."""
    jcfg = JaxModelConfig(**TRAIN_DIMS, p_drop=0.5)
    jmodel = JaxSWEM(jcfg)
    variables = f32["variables"]
    port = SWEM(dataclasses.replace(port_cfg(jcfg), p_drop=0.5), device="cpu")
    port.load_state_dict(f32["port"].state_dict())
    out_ref, logits_ref, _ = jax_step_grads(jmodel, variables, f32["batch"], 0)
    bases, keeps = jax_draws(jmodel, variables, 0, 0.5)
    assert all(0 < float(k.float().mean()) < 1 for k in keeps)
    logits, _ = port_forward(port, f32["batch"], bases, keeps)
    np.testing.assert_allclose(logits.detach().numpy(), logits_ref, rtol=0, atol=1e-4)
    assert not np.allclose(logits_ref, f32["logits"], atol=1e-4)  # the dropout changed the read
    out, _, _ = port_step(port, f32["batch"], bases, keeps)
    np.testing.assert_allclose(float(out["total_loss"]), float(out_ref["total_loss"]), rtol=1e-5)
    with pytest.raises(ValueError, match="keep mask"):
        port_forward(port, f32["batch"], bases)


@pytest.mark.parametrize("remat,p_drop", [("encoder", 0.0), ("block", 0.0), ("block", 0.5)])
def test_remat_is_bit_equal(f32, remat, p_drop):
    """Recomputation in the backward pass changes no bit: the keep masks are
    inputs of the checkpointed block, so the recomputed read drops the same
    bases."""
    port = f32["port"]
    if p_drop:
        port = SWEM(dataclasses.replace(port.cfg, p_drop=p_drop), device="cpu")
        port.load_state_dict(f32["port"].state_dict())
    bases, keeps = trainer.draw_step(port, torch.Generator().manual_seed(0), B, T)
    assert (keeps is None) == (p_drop == 0)
    ref, ref_g, _ = port_step(port, f32["batch"], bases, keeps)
    got, got_g, _ = port_step(port, f32["batch"], bases, keeps, remat=remat)
    assert float(got["total_loss"]) == float(ref["total_loss"])
    for n in ref_g:
        assert torch.equal(got_g[n], ref_g[n]), n


def test_uint8_and_float_batches_step_alike(f32):
    """The loader's compact batch (uint8 frames, slot labels) and the
    expanded one (float frames in [0, 1], one-hot masks) give the same bits:
    /255 on the device is the host conversion."""
    bases, _ = f32["draws"]
    batch = f32["batch"]
    onehot = (batch["label"][..., None] == np.arange(N + 1)).astype(np.float32)
    expanded = {"frames": batch["frames"].astype(np.float32) / 255.0, "masks": onehot,
                "label": batch["label"].astype(np.int64), "valid_obj": batch["valid_obj"]}
    a, ga, _ = port_step(f32["port"], batch, bases)
    b, gb, _ = port_step(f32["port"], expanded, bases)
    assert float(a["total_loss"]) == float(b["total_loss"])
    assert all(torch.equal(ga[n], gb[n]) for n in ga)


def test_frozen_batch_norm_stays_frozen(f32):
    """The trainer puts the model in train mode; batch norms keep their
    statistics (the JAX trainer never updates ``batch_stats``) and compute
    as in eval mode; the step moves the weights."""
    bases, _ = f32["draws"]
    before = {k: v.clone() for k, v in f32["port"].state_dict().items()}
    _, _, model = port_step(f32["port"], f32["batch"], bases)
    assert model.training
    after = model.state_dict()
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    assert stats and all(torch.equal(after[k], before[k]) for k in stats)
    assert not torch.equal(after["key_proj.key_proj.weight"], before["key_proj.key_proj.weight"])
    x = torch.rand(1, 32, 32, 3)
    with torch.no_grad():
        train_out = model.key_encoder(x)
        eval_out = model.eval().key_encoder(x)
    assert all(torch.equal(a, b) for a, b in zip(train_out, eval_out))


def test_kernel_wrappers_refuse_gradients():
    """Off the CPU, an input that requires grad raises in both wrappers
    before any launch (meta tensors stand in for the card's here); without
    grad the wrappers go on to their device checks."""
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    x, masks, k0, z0 = meta(1, 32, 16), meta(1, 2, 2, 32), meta(1, 2, 2, 16, 8), meta(1, 2, 2, 1, 8)
    qk, mk, mv = meta(1, 32, 16), meta(1, 2, 2, 16, 8), meta(1, 2, 2, 8, 8)
    valid = torch.ones((1, 2, 2, 8), dtype=torch.bool, device="meta")
    before = (em_kernel.launches, read_kernel.launches)
    with pytest.raises(RuntimeError, match="em_loop kernel: x require grad.*no backward"):
        em_kernel.em_loop(x.requires_grad_(), masks, k0, z0, n_iters=2, tau=0.05)
    with pytest.raises(RuntimeError, match="read_memory kernel: mv require grad.*no backward"):
        read_kernel.read_normalized(qk, mk, mv.requires_grad_(), valid, tau=0.05)
    with torch.no_grad(), pytest.raises(ValueError, match="expected"):
        em_kernel.em_loop(x, masks, k0, z0, n_iters=2, tau=0.05)
    assert (em_kernel.launches, read_kernel.launches) == before


# ---------------------------------------------------- optimizer, schedule --
@pytest.mark.parametrize("name", ["AdamW", "Adam", "SGD"])
def test_optimizers_match_optax(name):
    """The same gradients fed to both for 3 steps across the milestone at
    step 2 (its update takes gamma): parameters within 1e-6 relative."""
    kw = dict(optimizer=name, base_lr=1e-2, weight_decay=5e-2, davis_iters=(2, 10), stage=1,
              gamma=0.1)
    rng = np.random.default_rng(4)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    tx, _ = jax_make_optimizer(JaxSolverConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    opt, sched = solver.make_optimizer(SolverConfig(**kw), params.values())
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in params.items():
            p.grad = torch.tensor(g[k])
        opt.step()
        sched.step()
        for k in p0:
            np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7)


def test_lr_schedule_matches_optax():
    """MultiStepLR stepped once per iteration gives optax's piecewise-constant
    rate at every update (gamma from count >= milestone on)."""
    from swem_tpu.train.solver import lr_schedule

    cfg = dict(base_lr=2e-5, davis_iters=(3, 6), stage=1)
    sched_ref = lr_schedule(JaxSolverConfig(**cfg))
    opt, sched = solver.make_optimizer(SolverConfig(**cfg), [torch.nn.Parameter(torch.zeros(1))])
    for it in range(8):
        ref = float(sched_ref(jnp.asarray(it, jnp.int32)))
        assert opt.param_groups[0]["lr"] == pytest.approx(ref, rel=1e-6)
        opt.step()
        sched.step()
    assert solver.max_iter_for_stage(SolverConfig(**cfg)) == 6


def test_solver_config_rejects_unknown_remat():
    with pytest.raises(ValueError, match="remat"):
        SolverConfig(remat="everything")
