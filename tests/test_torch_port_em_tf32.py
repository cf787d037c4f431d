"""The EM loop kernel's 3xTF32 design, emulated on the CPU.

``swem_tpu_torch/csrc/em_loop.cu`` runs both products of each round on the
tensor cores in 3xTF32 (``test_torch_port_read_tf32`` tests the split): the
affinity x . l2norm(kappa) of each 32-pixel tile, and the tile's M-step
partial x_tile^T z_tile. Every 8-deep product is taken from zero and added
in float32, in order; the partials are written per pixel tile and added over
the tiles in tile order, whatever CTA computed them. No kernel runs here, so
these tests hold that arithmetic against the plain loop in float64 at the
flagship shape, with the tolerances of the port's EM tests, show that a
single TF32 product is not enough, and show that the order in which tiles
are computed leaves the bits unchanged. ``chip_smoke.py`` holds the kernel
itself against the same float64 referee on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from swem_tpu.ops.em_pallas import em_loop_pallas
from swem_tpu_torch.ops import em_kernel
from swem_tpu_torch.ops.em_kernel import l2norm
from test_torch_port_em import TAU, em_tol
from test_torch_port_read_tf32 import round_tf32, split_tf32
from test_em import make_inputs

TILE = 32  # pixels per tile, as in the kernel


def product_3xtf32(a, b):
    """a (..., M, K) @ b (..., K, N), K a multiple of 8: each 8-deep slice
    as small*big + big*small + big*big, the slices added in order."""
    (ab, as_), (bb, bs) = split_tf32(a), split_tf32(b)
    acc = None
    for k in range(0, a.shape[-1], 8):
        s = slice(k, k + 8)
        part = (torch.matmul(as_[..., s], bb[..., s, :]) + torch.matmul(ab[..., s], bs[..., s, :])
                + torch.matmul(ab[..., s], bb[..., s, :]))
        acc = part if acc is None else acc + part
    return acc


def product_1xtf32(a, b):
    acc = None
    for k in range(0, a.shape[-1], 8):
        part = torch.matmul(round_tf32(a[..., k:k + 8]), round_tf32(b[..., k:k + 8, :]))
        acc = part if acc is None else acc + part
    return acc


def em_loop_emulated(x, masks, kappa0, zita0, *, n_iters, tau, product=product_3xtf32,
                     tile_order=None):
    """The kernel's loop on the CPU -> (z, kappa, zita), in em_loop's layouts.

    Per object the 2L columns j = (branch s, base l) share one affinity
    S = x . l2norm(kappa); the W step reads S / |x|, the E step S / tau.
    ``tile_order`` is the order in which the tiles' partials are computed
    (as CTAs would take them); they are always added in tile order."""
    B, P, C = x.shape
    N, L = masks.shape[1], kappa0.shape[-1]
    n_tiles = -(-P // TILE)
    xp = torch.zeros((B, n_tiles * TILE, C))
    xp[:, :P] = x
    xinv = 1.0 / (torch.linalg.vector_norm(x, dim=-1) + 1e-6)  # (B, P)
    k0 = kappa0.permute(0, 1, 3, 2, 4).reshape(B, N, C, 2 * L)
    z0 = zita0.reshape(B, N, 1, 2 * L)
    khat = l2norm(k0, -2)
    weights = masks  # (B, N, 2, P)
    order = list(range(n_tiles)) if tile_order is None else list(tile_order)
    for it in range(n_iters):
        S = product(xp[:, None], khat)[:, :, :P].reshape(B, N, P, 2, L)  # (B, N, P, 2, L)
        if it > 0:  # W step: branch probabilities of the normalized affinities
            wl = S * xinv[:, None, :, None, None]
            m = wl.amax(dim=(-2, -1), keepdim=True)
            e = torch.exp((wl - m) / tau).sum(dim=-1)  # (B, N, P, 2)
            weights = masks * (1.0 - e / e.sum(dim=-1, keepdim=True)).transpose(-1, -2)
        z = torch.softmax(S / tau, dim=-1) * weights.transpose(-1, -2)[..., None]
        zp = torch.zeros((B, N, n_tiles * TILE, 2 * L))
        zp[:, :, :P] = z.reshape(B, N, P, 2 * L)
        xt = xp.reshape(B, 1, n_tiles, TILE, C)
        zt = zp.reshape(B, N, n_tiles, TILE, 2 * L)
        parts = [None] * n_tiles
        for tile in order:
            parts[tile] = (product(xt[:, :, tile].transpose(-1, -2), zt[:, :, tile]),
                           zt[:, :, tile].sum(dim=-2, keepdim=True))
        xz, zs = parts[0]
        for tile in range(1, n_tiles):
            xz, zs = xz + parts[tile][0], zs + parts[tile][1]
        zita = z0 + zs
        kappa = (z0 * k0 + xz) / zita
        khat = l2norm(kappa, -2)
    z = z.permute(0, 1, 3, 2, 4)  # (B, N, 2, P, L)
    kappa = kappa.reshape(B, N, C, 2, L).permute(0, 1, 3, 2, 4)
    return z, kappa, zita.reshape(B, N, 2, 1, L)


def _flagship_inputs():
    """chip_smoke.py's first flagship K1 draw: std-0.3 x, random {bg, fg}
    masks, l2-normalized kappa0, zita0 = 1e-6."""
    rng = np.random.default_rng(0)
    B, N, P, Ck, L = 1, 2, 1620, 128, 128
    x = rng.standard_normal((B, P, Ck)).astype(np.float32) * np.float32(0.3)
    fg = (rng.random((B, N, P)) > 0.5).astype(np.float32)
    masks = np.stack([1.0 - fg, fg], axis=2)
    kappa0 = rng.standard_normal((B, N, 2, Ck, L)).astype(np.float32)
    kappa0 /= np.linalg.norm(kappa0, axis=-2, keepdims=True) + 1e-6
    zita0 = np.full((B, N, 2, 1, L), 1e-6, np.float32)
    return [torch.from_numpy(a) for a in (x, masks, kappa0, zita0)]


@pytest.fixture(scope="module")
def flagship():
    """The flagship draw and the plain loop of it in float64, at 1 and 4 rounds."""
    inputs = _flagship_inputs()
    refs = {n: em_kernel.em_loop_plain(*(a.double() for a in inputs), n_iters=n, tau=TAU)
            for n in (1, 4)}
    return inputs, refs


@pytest.mark.parametrize("n_iters", [1, 4])
@pytest.mark.parametrize("route", ["3xtf32", "fp32"])
def test_em_route_within_tolerance_of_float64(flagship, route, n_iters):
    """The kernel's route (3xTF32, tile partials) and the float32 plain loop
    each stay within the EM tolerance of the float64 plain loop."""
    inputs, refs = flagship
    if route == "3xtf32":
        got = em_loop_emulated(*inputs, n_iters=n_iters, tau=TAU)
    else:
        got = em_kernel.em_loop_plain(*inputs, n_iters=n_iters, tau=TAU)
    rtol, atol = em_tol(n_iters)
    for name, g, r in zip(("z", "kappa", "zita"), got, refs[n_iters]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.double().numpy(), r.numpy(), rtol=rtol, atol=atol,
                                   err_msg=name)


def test_1xtf32_em_leaves_the_one_round_tolerance(flagship):
    """One TF32 product per term misses the 1-round tolerance: at tau = 0.05
    the softmax multiplies each affinity's error by 20."""
    inputs, refs = flagship
    z, kappa, _ = em_loop_emulated(*inputs, n_iters=1, tau=TAU, product=product_1xtf32)
    rtol, atol = em_tol(1)
    for name, g, r in (("z", z, refs[1][0]), ("kappa", kappa, refs[1][1])):
        bad = (g.double() - r).abs() > atol + rtol * r.abs()
        assert float(bad.double().mean()) > 0.01, name


def test_tile_order_leaves_the_bits_unchanged(flagship):
    """Partials are indexed by pixel tile and added in tile order, so the
    order in which tiles are computed (the grid's size and schedule) does
    not change a bit."""
    x, masks, kappa0, zita0 = flagship[0]
    x, masks = x[:, :300], masks[..., :300]
    n_tiles = -(-300 // TILE)
    base = em_loop_emulated(x, masks, kappa0, zita0, n_iters=2, tau=TAU)
    for order in (range(n_tiles - 1, -1, -1), np.random.default_rng(3).permutation(n_tiles)):
        got = em_loop_emulated(x, masks, kappa0, zita0, n_iters=2, tau=TAU, tile_order=order)
        for g, b in zip(got, base):
            assert torch.equal(g, b)


@pytest.mark.parametrize("n_iters", [1, 4])
def test_emulated_kernel_matches_pallas(n_iters):
    """At a ragged test shape (P = 130, N = 8, Ck = 16, L = 8) the emulated
    kernel agrees with the JAX package's Pallas kernel in interpret mode."""
    x, _, masks, kappa0, _, zita0 = make_inputs(np.random.default_rng(21), B=2, N=8, P=130,
                                                 Ck=16, Cv=8, L=8)
    got = em_loop_emulated(*(torch.from_numpy(a) for a in (x, masks, kappa0, zita0)),
                           n_iters=n_iters, tau=TAU)
    ref = em_loop_pallas(*(jnp.asarray(a) for a in (x, masks, kappa0, zita0)),
                         n_iters=n_iters, tau=TAU, interpret=True)
    rtol, atol = em_tol(n_iters)
    for name, g, r in zip(("z", "kappa", "zita"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol, atol=atol, err_msg=name)


# widths are padded to the kernel's multiples; these fit no 16-pixel tile's shared memory
@pytest.mark.parametrize("Ck, L", [(1024, 8), (128, 2048), (512, 1024)])
def test_kernel_path_rejects_shapes_it_cannot_take(Ck, L):
    """A non-CPU tensor of a shape the kernel cannot take raises before any
    build or launch, and never takes the plain version."""
    x, _, masks, kappa0, _, zita0 = make_inputs(np.random.default_rng(22), B=1, N=1, P=20,
                                                 Ck=Ck, Cv=8, L=L)
    meta = [torch.from_numpy(a).to("meta") for a in (x, masks, kappa0, zita0)]
    with pytest.raises(ValueError, match="the kernel takes"):
        em_kernel.em_loop(*meta, n_iters=4, tau=TAU)
    assert em_kernel.launches == 0


def test_flagship_shapes_fit_one_block():
    """Shared memory of one CTA at the flagship L = 128 and the reference's
    default L = 256 (Ck = 128), as the kernel's source note states."""
    assert em_kernel.smem_bytes(128, 128) == 104576
    assert em_kernel.smem_bytes(128, 256) == 137344 <= em_kernel.MAX_SMEM
