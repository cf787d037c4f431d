"""The port's two kernel ops on the CPU: the shape padding, the custom-op
registration and the memory's tensor ``mem_count``.

On the card the kernels take Ck and L (K1) or Ck and Lm (K2) in multiples
of 16 / 8 / 4, and their wrappers pad any other width inside the op. The
padding must be exact: here the plain versions on padded inputs, with the
count of real bases (K1) or the padded bases marked invalid (K2), are held
against the plain versions on the unpadded inputs, and against the JAX
package at those widths. ``chip_smoke.py`` holds the kernels themselves at
the padded shapes against float64 on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from swem_tpu.ops.em_pallas import em_loop_pallas
from swem_tpu.ops.read_pallas import read_memory_pallas
from swem_tpu_torch import engine
from swem_tpu_torch.models import em
from swem_tpu_torch.models.swem import SWEM
from swem_tpu_torch.ops import em_kernel, read_kernel
from _torch_port_util import one_torch_thread, port_cfg, t  # noqa: F401  (module fixture)
from test_model import tiny_cfg

TAU = 0.05
# (Ck, L): below the kernels' multiples, ragged against them, and wide L
WIDTHS = [(8, 4), (24, 12), (100, 300)]


def em_inputs(rng, Ck, L, B=1, N=2, P=40):
    x = rng.standard_normal((B, P, Ck)).astype(np.float32) * np.float32(0.3)
    fg = (rng.random((B, N, P)) > 0.5).astype(np.float32)
    masks = np.stack([1.0 - fg, fg], axis=2)
    kappa0 = rng.standard_normal((B, N, 2, Ck, L)).astype(np.float32)
    kappa0 /= np.linalg.norm(kappa0, axis=-2, keepdims=True) + 1e-6
    zita0 = np.full((B, N, 2, 1, L), 1e-6, np.float32)
    return x, masks, kappa0, zita0


def read_inputs(rng, Ck, Lm, B=1, N=2, P=40, Cv=16):
    qk = rng.standard_normal((B, P, Ck)).astype(np.float32)
    mk = rng.standard_normal((B, N, 2, Ck, Lm)).astype(np.float32)
    mv = rng.standard_normal((B, N, 2, Cv, Lm)).astype(np.float32)
    valid = np.ones((B, N, 2, Lm), bool)
    valid[:, 0, :, Lm // 2:] = False  # object 0: its update bank not yet valid
    return qk, mk, mv, valid


@pytest.mark.parametrize("n_iters", [1, 4])
@pytest.mark.parametrize("Ck, L", WIDTHS)
def test_em_padding_is_exact(Ck, L, n_iters):
    """The loop on pad_em's inputs with the real-L count, cut back, equals
    the loop on the unpadded inputs: zero channels change no dot product or
    norm, and the padded bases take no mass. One round within 1e-6 (the
    padded products only sum in another order); four rounds within the
    kernel tests' 4-round bounds, since at tau = 0.05 each round magnifies
    those ulps (2e-6 on a kappa of 0.05 after two rounds at (24, 12))."""
    inputs = [t(a) for a in em_inputs(np.random.default_rng(Ck + L), Ck, L)]
    ref = em_kernel.em_loop_plain(*inputs, n_iters=n_iters, tau=TAU)
    x, masks, kappa0, zita0, n_real = em_kernel.pad_em(*inputs)
    assert n_real == L
    assert x.shape[-1] % em_kernel.CK_MULT == 0 and kappa0.shape[-1] % em_kernel.L_MULT == 0
    z, kappa, zita = em_kernel.em_loop_plain(x, masks, kappa0, zita0, n_iters=n_iters, tau=TAU,
                                             n_bases=n_real)
    assert not z[..., L:].any() and not kappa[..., L:].any()  # the padded bases stay empty
    rtol, atol = (1e-6, 1e-6) if n_iters == 1 else (5e-2, 1e-2)
    for name, got, want in (("z", z[..., :L], ref[0]), ("kappa", kappa[..., :Ck, :L], ref[1]),
                            ("zita", zita[..., :L], ref[2])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("Ck, L", WIDTHS)
def test_read_padding_is_exact(Ck, L):
    """The read on pad_read's inputs (padded bases invalid), exp_aff cut
    back, equals the read on the unpadded inputs."""
    qk, mk, mv, valid = (t(a) for a in read_inputs(np.random.default_rng(Ck + L), Ck, 2 * L))
    qk, mk = em_kernel.l2norm(qk, -1), em_kernel.l2norm(mk, -2)
    ref = read_kernel.read_plain(qk, mk, mv, valid, tau=TAU)
    padded = read_kernel.pad_read(qk, mk, mv, valid)
    assert padded[0].shape[-1] % read_kernel.MULT == 0
    assert padded[1].shape[-1] % read_kernel.MULT == 0
    mem_out, exp_aff = read_kernel.read_plain(*padded, tau=TAU)
    np.testing.assert_allclose(mem_out.numpy(), ref[0].numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(exp_aff[..., :2 * L, :].numpy(), ref[1].numpy(), rtol=1e-6,
                               atol=1e-6)
    assert not exp_aff[..., 2 * L:, :].any()


@pytest.mark.parametrize("Ck, L", WIDTHS[:2])
def test_ops_match_pallas_at_unpadded_widths(Ck, L):
    """At widths off the kernels' multiples, both ops on the CPU agree with
    the JAX package's Pallas kernels in interpret mode (1 round of K1, at its
    tight bound)."""
    rng = np.random.default_rng(7)
    x, masks, kappa0, zita0 = em_inputs(rng, Ck, L, P=20)
    got = em_kernel.em_loop(t(x), t(masks), t(kappa0), t(zita0), n_iters=1, tau=TAU)
    ref = em_loop_pallas(*(jnp.asarray(a) for a in (x, masks, kappa0, zita0)), n_iters=1,
                         tau=TAU, interpret=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)
    qk, mk, mv, valid = read_inputs(rng, Ck, 2 * L, P=20)
    got = read_kernel.read_affinity(t(qk), t(mk), t(mv), t(valid), tau=TAU)
    ref = read_memory_pallas(*(jnp.asarray(a) for a in (qk, mk, mv, valid)), tau=TAU,
                             interpret=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-6)


def test_kernel_takes_every_cli_width():
    """Every --key_dim and --num_bases of the grid fits a CTA of both
    kernels once padded (K1 in 16-pixel tiles where 32 do not fit)."""
    for Ck in (8, 24, 100, 128, 256, 512):
        for L in (4, 12, 128, 256, 300, 512):
            tile = em_kernel.kernel_tile(Ck, L)
            assert tile in em_kernel.TILES, (Ck, L)
            assert read_kernel.smem_bytes(Ck + -Ck % read_kernel.MULT) <= read_kernel.MAX_SMEM
    assert em_kernel.kernel_tile(128, 128) == 32  # the flagship keeps its tile
    assert em_kernel.kernel_tile(512, 512) == 16


def test_opcheck_em_loop():
    """The K1 op's schema, fake (meta) implementation and dispatch, by
    ``torch.library.opcheck`` on CPU tensors."""
    x, masks, kappa0, zita0 = (t(a) for a in em_inputs(np.random.default_rng(1), 16, 8, P=12))
    torch.library.opcheck(em_kernel.em_loop_op, (x, masks, kappa0, zita0, 2, TAU))


def test_opcheck_read_normalized():
    qk, mk, mv, valid = (t(a) for a in read_inputs(np.random.default_rng(2), 16, 16, P=12))
    torch.library.opcheck(read_kernel.read_op, (em_kernel.l2norm(qk, -1),
                                                em_kernel.l2norm(mk, -2), mv, valid, TAU))


def test_ops_are_registered_and_return_fresh_tensors():
    """The wrappers go through ``torch.ops.swem_tpu_torch``; the outputs
    share no storage with the inputs."""
    x, masks, kappa0, zita0 = (t(a) for a in em_inputs(np.random.default_rng(3), 16, 8, P=12))
    outs = torch.ops.swem_tpu_torch.em_loop(x, masks, kappa0, zita0, 1, TAU)
    ins = {a.untyped_storage().data_ptr() for a in (x, masks, kappa0, zita0)}
    assert not ins & {o.untyped_storage().data_ptr() for o in outs}
    for g, r in zip(outs, em_kernel.em_loop(x, masks, kappa0, zita0, n_iters=1, tau=TAU)):
        assert torch.equal(g, r)
    assert (em_kernel.launches, read_kernel.launches) == (0, 0)


def test_mem_count_is_a_device_tensor():
    """``mem_count`` is a 0-d int32 tensor from ``init_memory`` on, 1 after
    it and 3 after two more memorizes (two one-frame chunks), as in the JAX
    package."""
    cfg = port_cfg(tiny_cfg())
    model = SWEM(cfg, device="cpu").init_weights(0)
    rng = np.random.default_rng(4)
    frames = torch.from_numpy(rng.random((3, 1, 32, 32, 3)).astype(np.float32))
    mask = torch.zeros((1, 32, 32, cfg.max_objs + 1))
    mask[..., 0] = 1.0
    mask[:, 8:20, 8:20] = torch.eye(cfg.max_objs + 1)[1]
    active = torch.zeros((1, cfg.max_objs), dtype=torch.bool)
    active[0, 0] = True
    mem = engine.init_memory(model, torch.Generator().manual_seed(0), frames[0], mask, active)
    assert isinstance(mem.mem_count, torch.Tensor)
    assert mem.mem_count.shape == () and mem.mem_count.dtype == torch.int32
    assert int(mem.mem_count) == 1
    for i in (1, 2):
        mem, _, _ = engine.run_chunk(model, mem, frames[i:i + 1], active, (32, 32))
    assert int(mem.mem_count) == 3
    _, _, valid = em.gather_memory(mem)
    assert valid[0, 0].all() and not valid[0, 1].any()
