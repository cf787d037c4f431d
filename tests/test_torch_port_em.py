"""The PyTorch port's EM core and memory read against swem_tpu, on the CPU.

On a CPU tensor the port's kernel wrappers take their plain PyTorch
versions; these are held against the JAX package's XLA path and against its
Pallas kernels in interpret mode. The CUDA kernels themselves are held
against the plain versions on the card by ``chip_smoke.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swem_tpu.models import em as jem
from swem_tpu.ops.em_pallas import em_loop_pallas
from swem_tpu.ops.read_pallas import read_memory_pallas
from swem_tpu_torch.models import em
from swem_tpu_torch.ops import em_kernel, read_kernel
from _torch_port_util import t
from test_em import make_inputs

TAU = 0.05
# jitted JAX references: one compile per shape instead of op-by-op dispatch.
# em_update stays eager, as the JAX package's own kernel test runs it: under
# jit XLA fuses the chaotic 4-round loop differently.
jax_em_loop = jax.jit(em_loop_pallas, static_argnames=("n_iters", "tau", "interpret"))
jax_memorize = jax.jit(jem.memorize, static_argnames=("n_iters", "tau"))
jax_read = jax.jit(read_memory_pallas, static_argnames=("tau", "interpret"))
jax_read_memory = jax.jit(jem.read_memory, static_argnames=("tau", "topl"))


def em_tol(n_iters):
    # the JAX package's kernel-test bounds: tight for one round; at tau=0.05
    # the loop is chaotic over rounds, so float32 summation-order ulps grow
    return (1e-4, 1e-5) if n_iters == 1 else (5e-2, 1e-2)


@pytest.mark.parametrize("P", [48, 130])  # 130: ragged against any tile size
@pytest.mark.parametrize("n_iters", [1, 4])
@pytest.mark.parametrize("N", [2, 8])
def test_em_loop_matches_pallas_and_em_update(P, n_iters, N):
    x, v, masks, kappa0, nu0, zita0 = make_inputs(np.random.default_rng(P + N), B=2, N=N, P=P,
                                                  Ck=16, Cv=8, L=8)
    rtol, atol = em_tol(n_iters)
    z, kappa, zita = em_kernel.em_loop(t(x), t(masks), t(kappa0), t(zita0),
                                       n_iters=n_iters, tau=TAU)
    pz, pkappa, pzita = jax_em_loop(*(jnp.asarray(a) for a in (x, masks, kappa0, zita0)),
                                    n_iters=n_iters, tau=TAU, interpret=True)
    for got, ref in ((z, pz), (kappa, pkappa), (zita, pzita)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol)

    ref = jem.em_update(*(jnp.asarray(a) for a in (x, v, masks)),
                        jem.Bases(*(jnp.asarray(a) for a in (kappa0, nu0, zita0))),
                        n_iters=n_iters, tau=TAU)
    got = em.em_update(t(x), t(v), t(masks), em.Bases(t(kappa0), t(nu0), t(zita0)),
                       n_iters=n_iters, tau=TAU)
    for name in ("kappa", "nu", "zita"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_em_steps_match():
    x, _, masks, kappa0, _, zita0 = make_inputs(np.random.default_rng(1))
    z = em._e_step(t(x), t(kappa0), t(masks), TAU)
    np.testing.assert_allclose(z.numpy(), np.asarray(jem._e_step(
        jnp.asarray(x), jnp.asarray(kappa0), jnp.asarray(masks), TAU)), rtol=1e-4, atol=1e-6)
    k, zt = em._m_step(z, t(x), t(kappa0), t(zita0))
    rk, rzt = jem._m_step(jnp.asarray(z.numpy()), jnp.asarray(x), jnp.asarray(kappa0),
                          jnp.asarray(zita0))
    np.testing.assert_allclose(k.numpy(), np.asarray(rk), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(zt.numpy(), np.asarray(rzt), rtol=1e-5, atol=1e-6)
    xn = em.l2norm(t(x), -1)
    w = em._w_step(xn, k, t(masks), TAU)
    rw = jem._w_step(jnp.asarray(xn.numpy()), jnp.asarray(k.numpy()), jnp.asarray(masks), TAU)
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=1e-4, atol=1e-6)


def test_memorize_and_gather_match():
    """memorize (active gating, first/update banks) and gather_memory's
    validity mask over three frames, one slot activating late."""
    rng = np.random.default_rng(2)
    B, N, P, Ck, Cv, L = 1, 3, 40, 16, 8, 8
    bases = jem.fresh_memory(jax.random.PRNGKey(0), 1, N, Ck, Cv, L)
    jmem = bases
    pmem = em.fresh_memory(em.Bases(*(t(a) for a in (bases.first.kappa, bases.first.nu,
                                                     bases.first.zita))))
    for frame, act in enumerate(([True, True, False], [True, True, False], [True, True, True])):
        x, v, masks, _, _, _ = make_inputs(rng, B=B, N=N, P=P, Ck=Ck, Cv=Cv, L=L)
        active = np.asarray([act])
        jmem = jax_memorize(jmem, jnp.asarray(x), jnp.asarray(v), jnp.asarray(masks),
                            jnp.asarray(active), n_iters=1, tau=TAU)
        pmem = em.memorize(pmem, t(x), t(v), t(masks), t(active), n_iters=1, tau=TAU)
        for got, ref in zip(em.gather_memory(pmem), jem.gather_memory(jmem)):
            np.testing.assert_allclose(got.numpy().astype(np.float32),
                                       np.asarray(ref).astype(np.float32),
                                       rtol=1e-4, atol=1e-5, err_msg=f"frame {frame}")
    assert pmem.mem_count == int(jmem.mem_count) == 3


def _read_inputs(rng, P, valid_case, B=2, N=2, Ck=16, Cv=8, L=8):
    Lm = 2 * L
    qk = rng.standard_normal((B, P, Ck)).astype(np.float32)
    mk = rng.standard_normal((B, N, 2, Ck, Lm)).astype(np.float32)
    mv = rng.standard_normal((B, N, 2, Cv, Lm)).astype(np.float32)
    valid = np.ones((B, N, 2, Lm), bool)
    if valid_case == "update bank invalid":
        valid[:, 0, :, L:] = False
    elif valid_case == "object never seen":
        valid[:, 0, :, L:] = False
        valid[:, 1] = False
    return qk, mk, mv, valid


# mem_out is a softmax-weighted mean of O(1) values; exp_aff and S come from
# exp((a - max) / tau) of float32 dot products: 1e-4 relative, 1e-6 absolute
READ_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("P", [48, 130])
@pytest.mark.parametrize("valid_case", ["all valid", "update bank invalid", "object never seen"])
def test_read_matches_pallas_and_read_memory(P, valid_case):
    qk, mk, mv, valid = _read_inputs(np.random.default_rng(P), P, valid_case)
    mem_out, exp_aff = read_kernel.read_affinity(t(qk), t(mk), t(mv), t(valid), tau=TAU)
    p_out, p_exp = jax_read(*(jnp.asarray(a) for a in (qk, mk, mv, valid)), tau=TAU,
                            interpret=True)
    np.testing.assert_allclose(mem_out.numpy(), np.asarray(p_out), **READ_TOL)
    np.testing.assert_allclose(exp_aff.numpy(), np.asarray(p_exp), **READ_TOL)

    ref_out, ref_S = jax_read_memory(*(jnp.asarray(a) for a in (qk, mk, mv, valid)), tau=TAU,
                                     topl=4)
    got_out, got_S = em.read_memory(t(qk), t(mk), t(mv), t(valid), tau=TAU, topl=4)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(ref_out), **READ_TOL)
    np.testing.assert_allclose(got_S.numpy(), np.asarray(ref_S), **READ_TOL)
    if valid_case == "object never seen":
        assert not got_out[:, 1].any() and not exp_aff[:, 1].any()


def test_perm_inv_feat_with_ties():
    """topk + cumsum gives the argmax-delete scan's values, ties included."""
    rng = np.random.default_rng(3)
    exp_aff = rng.integers(0, 4, (1, 2, 2, 16, 30)).astype(np.float32) * 0.25
    ref = np.asarray(jem._perm_inv_feat(jnp.asarray(exp_aff), 6))
    got = em._perm_inv_feat(t(exp_aff), 6).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_cpu_tensors_take_the_plain_versions():
    """Routing: a CPU tensor runs the plain version and launches nothing."""
    x, _, masks, kappa0, _, zita0 = make_inputs(np.random.default_rng(4))
    em_before, read_before = em_kernel.launches, read_kernel.launches
    got = em_kernel.em_loop(t(x), t(masks), t(kappa0), t(zita0), n_iters=2, tau=TAU)
    ref = em_kernel.em_loop_plain(t(x), t(masks), t(kappa0), t(zita0), n_iters=2, tau=TAU)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    qk, mk, mv, valid = _read_inputs(np.random.default_rng(5), 20, "all valid")
    got = read_kernel.read_affinity(t(qk), t(mk), t(mv), t(valid), tau=TAU)
    ref = read_kernel.read_plain(em.l2norm(t(qk), -1), em.l2norm(t(mk), -2), t(mv), t(valid),
                                 tau=TAU)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert (em_kernel.launches, read_kernel.launches) == (em_before, read_before) == (0, 0)


def test_non_cpu_tensors_never_take_the_plain_versions():
    """A tensor that is not on the CPU goes to the kernel path, which raises
    here rather than falling back to the plain version."""
    x, _, masks, kappa0, _, zita0 = make_inputs(np.random.default_rng(6))
    meta = [torch.from_numpy(a).to("meta") for a in (x, masks, kappa0, zita0)]
    with pytest.raises(ValueError, match="expected"):
        em_kernel.em_loop(*meta, n_iters=2, tau=TAU)
    qk, mk, mv, valid = (torch.from_numpy(a).to("meta") for a in _read_inputs(
        np.random.default_rng(7), 20, "all valid"))
    with pytest.raises(ValueError, match="expected"):
        read_kernel.read_affinity(qk, mk, mv, valid, tau=TAU)
    assert (em_kernel.launches, read_kernel.launches) == (0, 0)
