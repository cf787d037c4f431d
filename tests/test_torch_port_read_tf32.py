"""The memory-read kernel's 3xTF32 arithmetic, emulated on the CPU.

``swem_tpu_torch/csrc/read_memory.cu`` runs both of its products on the
tensor cores in 3xTF32: each float32 operand x is split into
big = tf32(x) and small = tf32(x - big), rounded to nearest with ties away
from zero (``cvt.rna.tf32.f32``), and a product accumulates
small*big + big*small + big*big in float32. No kernel runs here, so these
tests hold that design against the plain read in float64 at the flagship
shape, with the tolerance of the port's read tests, and show that a single
TF32 product is not enough. ``chip_smoke.py`` holds the kernel itself
against the same float64 referee on the card.
"""

import numpy as np
import pytest
import torch

from swem_tpu_torch.ops import read_kernel
from swem_tpu_torch.ops.em_kernel import l2norm
from test_torch_port_em import READ_TOL, TAU, _read_inputs


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10-bit mantissa), ties away from
    zero, as ``cvt.rna.tf32.f32``: add half a TF32 ulp to the magnitude's
    bits and clear the 13 bits TF32 drops."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & -0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def split_tf32(x):
    big = round_tf32(x)
    return big, round_tf32(x - big)


def matmul_3xtf32(a, b):
    (ab, as_), (bb, bs) = split_tf32(a), split_tf32(b)
    return (torch.matmul(as_, bb) + torch.matmul(ab, bs)) + torch.matmul(ab, bb)


def matmul_1xtf32(a, b):
    return torch.matmul(round_tf32(a), round_tf32(b))


def read_emulated(qk, mk, mv, base_valid, *, tau, matmul):
    """The kernel's read with its two products taken by ``matmul``: affinity,
    masked joint softmax, then sum_j e_j v_j / (sum_j e_j + 1e-30)."""
    B, N, _, Cv, Lm = mv.shape
    aff = matmul(mk.transpose(-1, -2), qk.transpose(1, 2)[:, None, None])  # (B,N,2,Lm,P)
    valid = base_valid[..., None]
    aff = aff.masked_fill(~valid, float("-inf"))
    maxes = aff.amax(dim=(2, 3), keepdim=True)
    exp_aff = torch.where(valid, torch.exp((aff - maxes) / tau), 0.0)
    v = mv.permute(0, 1, 3, 2, 4).reshape(B, N, Cv, 2 * Lm)
    e = exp_aff.reshape(B, N, 2 * Lm, -1)
    mem_out = matmul(v, e) / (e.sum(dim=2, keepdim=True) + 1e-30)  # (B,N,Cv,P)
    return mem_out.transpose(-1, -2), exp_aff


@pytest.fixture(scope="module")
def flagship():
    """Std-normal inputs at the flagship read shape (P = 1620, Ck = 128,
    N = 2, Lm = 256, Cv = 512), keys normalized in float32, and the plain
    read of exactly those inputs in float64.

    The draw is ``chip_smoke.py``'s first flagship case. READ_TOL sits at
    float32's own floor here: on other draws the worst mem_out element of
    the float32 plain read, or of the 3xTF32 emulation, can land just past
    it (a near-zero mean of O(1) values, whose affinity error the softmax
    multiplies by 1/tau = 20)."""
    qk, mk, mv, valid = (torch.from_numpy(a) for a in _read_inputs(
        np.random.default_rng(1), 1620, "all valid", B=1, N=2, Ck=128, Cv=512, L=128))
    qn, mkn = l2norm(qk, -1), l2norm(mk, -2)
    ref = read_kernel.read_plain(qn.double(), mkn.double(), mv.double(), valid, tau=TAU)
    return (qn, mkn, mv, valid), ref


@pytest.mark.parametrize("bits, expect", [
    (0x3F800000, 0x3F800000),  # 1.0: exact
    (0xC0200000, 0xC0200000),  # -2.5: exact
    (0x3F802000, 0x3F802000),  # 1 + 2^-10: exact, the last TF32 mantissa bit
    (0x00000000, 0x00000000),  # +0
    (0x80000000, 0x80000000),  # -0 keeps its sign
    (0x3F801000, 0x3F802000),  # 1 + 2^-11: halfway, away from zero (even would give 1.0)
    (0xBF801000, 0xBF802000),  # -(1 + 2^-11): halfway, away from zero
    (0x3F800FFF, 0x3F800000),  # just below halfway: down
    (0x3F801001, 0x3F802000),  # just above halfway: up
    (0x3F803000, 0x3F804000),  # 1 + 3 * 2^-11: halfway, away from zero
    (0x3FFFF000, 0x40000000),  # 2 - 2^-11: halfway, carries into the exponent
    (0x3EAAAAAB, 0x3EAAA000),  # 1/3: down
])
def test_round_tf32_bits(bits, expect):
    x = torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(torch.float32)
    got = round_tf32(x).view(torch.int32).item() & 0xFFFFFFFF
    assert got == expect, f"{bits:#010x} -> {got:#010x}, expected {expect:#010x}"


@pytest.mark.parametrize("route", ["3xtf32", "fp32"])
def test_read_route_within_tolerance_of_float64(flagship, route):
    """The kernel's route (3xTF32) and the float32 plain read each stay
    within READ_TOL of the float64 plain read at the flagship shape."""
    (qn, mkn, mv, valid), ref = flagship
    if route == "3xtf32":
        got = read_emulated(qn, mkn, mv, valid, tau=TAU, matmul=matmul_3xtf32)
    else:
        got = read_kernel.read_plain(qn, mkn, mv, valid, tau=TAU)
    for name, g, r in zip(("mem_out", "exp_aff"), got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.double().numpy(), r.numpy(), **READ_TOL, err_msg=name)


def test_1xtf32_read_leaves_the_tolerance(flagship):
    """One TF32 product per term misses READ_TOL on most of exp_aff: at
    tau = 0.05 the softmax multiplies each affinity's error by 20."""
    (qn, mkn, mv, valid), ref = flagship
    got = read_emulated(qn, mkn, mv, valid, tau=TAU, matmul=matmul_1xtf32)
    for name, g, r in zip(("mem_out", "exp_aff"), got, ref):
        g, r = g.double(), r
        bad = (g - r).abs() > READ_TOL["atol"] + READ_TOL["rtol"] * r.abs()
        assert float(bad.double().mean()) > 0.25, name


def test_read_affinity_is_normalization_then_read_normalized():
    """On the CPU the wrapper's two halves give the plain version's bits."""
    qk, mk, mv, valid = (torch.from_numpy(a) for a in _read_inputs(
        np.random.default_rng(12), 130, "update bank invalid"))
    got = read_kernel.read_affinity(qk, mk, mv, valid, tau=TAU)
    normalized = read_kernel.read_normalized(l2norm(qk, -1), l2norm(mk, -2), mv, valid, tau=TAU)
    plain = read_kernel.read_plain(l2norm(qk, -1), l2norm(mk, -2), mv, valid, tau=TAU)
    for g, n, p in zip(got, normalized, plain):
        assert torch.equal(g, n) and torch.equal(g, p)
    assert read_kernel.launches == 0


# widths are padded and any Lm read in column blocks; these Ck fit no query tile
@pytest.mark.parametrize("Ck, L", [(756, 8), (1024, 7), (760, 257)])
def test_kernel_path_rejects_shapes_it_cannot_take(Ck, L):
    """A non-CPU tensor of a shape the kernel cannot take raises before any
    build or launch, and never takes the plain version."""
    qk, mk, mv, valid = (torch.from_numpy(a).to("meta") for a in _read_inputs(
        np.random.default_rng(13), 20, "all valid", B=1, N=1, Ck=Ck, Cv=8, L=L))
    with pytest.raises(ValueError, match="the kernel takes"):
        read_kernel.read_normalized(qk, mk, mv, valid, tau=TAU)
    assert read_kernel.launches == 0
