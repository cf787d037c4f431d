"""Sequential Weighted EM memory core, counterpart of ``swem_tpu/models/em.py``.

Shapes follow the JAX package: bases ``(B, N, 2, C, L)`` with ``N`` the
static object-slot count and branch axis 2 = [bg, fg]. Inactive slots carry
all-zero masks, which makes their EM update a no-op.

The W/E/M loop runs in ``ops/em_kernel.em_loop`` and the inference read in
``ops/read_kernel.read_affinity``: hand-written kernels on a CUDA tensor,
their plain versions on a CPU tensor. The training read (differentiable,
with the optional ``p_drop`` dropout) and the read with Gaussian locality
reweighting (``n_kernel > 0``) are one other function, ``_read_ops``, in
PyTorch ops on every device, as they are XLA code beside the TPU kernel in
the JAX package, which never routes a training read to its kernel. Of the
memorize, only the final ``nu`` update carries gradients, as in the
reference; neither kernel has a backward.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from swem_tpu_torch.config import no_grad
from swem_tpu_torch.ops.em_kernel import (  # noqa: F401  (E/M/W steps live with the kernel)
    e_step as _e_step,
    em_loop,
    l2norm,
    m_step as _m_step,
    w_step as _w_step,
)
from swem_tpu_torch.ops.read_kernel import read_affinity


@dataclass
class Bases:
    """EM statistics of one memory bank.

    kappa (B,N,2,Ck,L) key prototypes; nu (B,N,2,Cv,L) value prototypes;
    zita (B,N,2,1,L) accumulated responsibility mass.
    """

    kappa: torch.Tensor
    nu: torch.Tensor
    zita: torch.Tensor

    def expand(self, batch: int) -> "Bases":
        return Bases(*(t.expand((batch,) + t.shape[1:]) for t in (self.kappa, self.nu, self.zita)))

    def to(self, device) -> "Bases":
        return Bases(*(t.to(device) for t in (self.kappa, self.nu, self.zita)))


@dataclass
class VOSMemory:
    """Two-bank prototype memory.

    ``first`` holds each object's bases from its activation frame; ``update``
    the latest frame's. ``obj_seen`` (B,N) bool marks initialized slots.
    ``mem_count`` () int32 on the memory's device counts memorize calls: the
    update bank joins reads once it is >= 2. A tensor, as in the JAX
    package, so that a traced program (``io/export.py``) carries it as an
    input rather than baking in its value, and no read syncs on it.
    """

    first: Bases
    update: Bases
    obj_seen: torch.Tensor
    mem_count: torch.Tensor


def init_bases(generator: Optional[torch.Generator], batch: int, n_objs: int, key_dim: int,
               val_dim: int, n_bases: int, device="cpu") -> Bases:
    """Random prototypes: kappa ~ N(0, 2/L), l2-normalized over channels;
    nu = 0; zita = 1e-6. Drawn on the CPU, so a seed gives the same bases
    on every device."""
    kappa = torch.randn((batch, n_objs, 2, key_dim, n_bases), generator=generator)
    kappa = l2norm(kappa * math.sqrt(2.0 / n_bases), -2)
    nu = torch.zeros((batch, n_objs, 2, val_dim, n_bases))
    zita = torch.full((batch, n_objs, 2, 1, n_bases), 1e-6)
    return Bases(kappa, nu, zita).to(device)


def fresh_memory(bases: Bases) -> VOSMemory:
    """Empty memory: both banks at ``bases``, nothing seen."""
    B, N = bases.kappa.shape[:2]
    dev = bases.kappa.device
    return VOSMemory(first=bases, update=bases,
                     obj_seen=torch.zeros((B, N), dtype=torch.bool, device=dev),
                     mem_count=torch.zeros((), dtype=torch.int32, device=dev))


def em_update(x: torch.Tensor, v: torch.Tensor, masks: torch.Tensor, bases0: Bases, *,
              n_iters: int, tau: float) -> Bases:
    """One frame's Sequential Weighted EM update.

    x (B,P,Ck) query keys; v (B,N,P,Cv) value features; masks (B,N,2,P)
    [bg, fg] pixel weights; bases0: warm start. The loop runs without
    gradients; ``nu`` is differentiable through v and bases0.nu.
    """
    with no_grad():
        z, kappa, zita = em_loop(x.float(), masks, bases0.kappa, bases0.zita,
                                 n_iters=n_iters, tau=tau)
    zita0 = bases0.zita.detach()
    # sum_p v[b,n,p,:] z[b,n,s,p,:] -> (B,N,2,Cv,L)
    nu = (zita0 * bases0.nu + torch.matmul(v.transpose(-1, -2)[:, :, None], z)) / zita
    return Bases(kappa=kappa, nu=nu, zita=zita)


def memory_write(mem: VOSMemory, bases: Bases, active: torch.Tensor) -> VOSMemory:
    """Commit a frame's EM result: ``update`` is replaced; ``first`` takes
    the new bases only on newly-seen slots."""
    newly = (active & ~mem.obj_seen)[:, :, None, None, None]
    first = Bases(*(torch.where(newly, new, old) for new, old in (
        (bases.kappa, mem.first.kappa), (bases.nu, mem.first.nu), (bases.zita, mem.first.zita))))
    return VOSMemory(first=first, update=bases, obj_seen=mem.obj_seen | active,
                     mem_count=mem.mem_count + 1)


def memorize(mem: VOSMemory, x, v, masks, active, *, n_iters: int, tau: float) -> VOSMemory:
    """EM-update from the ``update`` bank and commit. Masks are gated by
    ``active`` so a slot keeps its random init until its object appears."""
    masks = masks * active[:, :, None, None].to(masks.dtype)
    bases = em_update(x, v, masks, mem.update, n_iters=n_iters, tau=tau)
    return memory_write(mem, bases, active)


def gather_memory(mem: VOSMemory) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both banks along L plus validity -> mk (B,N,2,Ck,2L), mv (B,N,2,Cv,2L),
    base_valid (B,N,2,2L). The update half is valid once mem_count >= 2 (a
    comparison on the device: no sync)."""
    mk = torch.cat([mem.first.kappa, mem.update.kappa], dim=-1)
    mv = torch.cat([mem.first.nu, mem.update.nu], dim=-1)
    L = mem.first.kappa.shape[-1]
    B, N = mem.obj_seen.shape
    first_valid = mem.obj_seen[:, :, None, None].expand(B, N, 2, L)
    upd_valid = first_valid & (mem.mem_count >= 2)
    return mk, mv, torch.cat([first_valid, upd_valid], dim=-1)


def _perm_inv_feat(exp_aff: torch.Tensor, topl: int) -> torch.Tensor:
    """Permutation-invariant top-l affinity feature.

    exp_aff (B,N,2,Lm,P) non-negative -> S (B,N,P,2*topl), channels
    [bg_ratio_0..k-1, (1-bg_ratio)_0..k-1]. The prefix sums of the sorted
    top-l values equal those of the JAX package's argmax-delete scan, and
    ``topk``'s backward, a scatter to the unique selected indices, is the
    gradient that the JAX package's ``_topk_vals`` builds by hand.
    """
    tops = torch.topk(exp_aff, topl, dim=3, sorted=True).values  # (B,N,2,topl,P)
    feat = torch.cumsum(tops, dim=3)
    bg, fg = feat[:, :, 0], feat[:, :, 1]  # branch 0 = bg
    ratio = (bg / (bg + fg + 1e-30)).transpose(-1, -2)  # (B,N,P,topl)
    return torch.cat([ratio, 1.0 - ratio], dim=-1)


def _gaussian_kernels(aff: torch.Tensor, hw: Tuple[int, int], n_kernel: int, sigma: float,
                      tau: float) -> torch.Tensor:
    """Gaussian locality weights: for each base, Gaussians at its top-``n_kernel``
    query pixels; each pixel is weighted by exp(max over them of
    -d^2 / (2 sigma^2), / tau). aff (B,N,2,Lm,P) raw affinities, -inf on
    invalid bases (their top-k picks arbitrary pixels; exp_aff zeroes those
    rows) -> (B,N,2,Lm,P)."""
    h, w = hw
    top_idx = torch.topk(aff, n_kernel, dim=-1).indices  # (B,N,2,Lm,k) over pixels
    x_idx, y_idx = (top_idx % w).float(), ((top_idx // w) % h).float()
    pix = torch.arange(aff.shape[-1], device=aff.device)
    xv, yv = (pix % w).float(), ((pix // w) % h).float()
    d2 = ((xv[:, None] - x_idx[..., None, :]) ** 2
          + (yv[:, None] - y_idx[..., None, :]) ** 2)  # (B,N,2,Lm,P,k)
    return torch.exp(torch.amax(-d2 / (2.0 * sigma ** 2), dim=-1) / tau)


def _read_ops(qk, mk, mv, base_valid, *, tau: float, n_kernel: int = 0, sigma: float = 7.0,
              hw: Optional[Tuple[int, int]] = None, keep: Optional[torch.Tensor] = None):
    """The memory read in PyTorch ops on every device, differentiable: the
    JAX package's XLA read beside its TPU kernel, with its two optional
    terms. ``n_kernel > 0`` weights the affinities by Gaussian locality on
    the query grid ``hw`` (inference); ``keep`` (B,N,1,Lm,1) bool drops
    whole bases from the value read's normalization (``p_drop``, training).
    Same arguments as ``read_memory``; returns (mem_out (B,N,P,Cv),
    exp_aff (B,N,2,Lm,P) unweighted and undropped)."""
    aff = torch.matmul(l2norm(mk, -2).transpose(-1, -2),
                       l2norm(qk, -1).transpose(1, 2)[:, None, None])  # (B,N,2,Lm,P)
    valid = base_valid[..., None]
    aff = aff.masked_fill(~valid, float("-inf"))
    maxes = aff.amax(dim=(2, 3), keepdim=True)  # joint over {bg,fg} x Lm
    # the where also guards an object with no valid base (max = -inf -> nan)
    exp_aff = torch.where(valid, torch.exp((aff - maxes) / tau), 0.0)
    if n_kernel > 0:
        weighted, eps = exp_aff * _gaussian_kernels(aff, hw, n_kernel, sigma, tau), 1e-8
    elif keep is not None:
        weighted, eps = exp_aff * keep.to(exp_aff.dtype), 1e-6
    else:
        weighted, eps = exp_aff, 1e-30
    p_aff = weighted / (weighted.sum(dim=(2, 3), keepdim=True) + eps)  # the reference's epsilons
    return torch.einsum("bnsvl,bnslp->bnpv", mv, p_aff), exp_aff


def draw_keep(generator: Optional[torch.Generator], batch: int, n_objs: int, n_bases: int,
              p_drop: float, device="cpu") -> torch.Tensor:
    """The ``p_drop`` keep mask (B,N,1,Lm,1) bool over both banks' Lm bases,
    drawn on the CPU like ``init_bases``."""
    u = torch.rand((batch, n_objs, 1, n_bases, 1), generator=generator)
    return (u > p_drop).to(device)


def read_memory(qk, mk, mv, base_valid, *, tau: float, topl: int, n_kernel: int = 0,
                sigma: float = 7.0, hw: Optional[Tuple[int, int]] = None, train: bool = False,
                keep: Optional[torch.Tensor] = None):
    """Attention-style memory read.

    qk (B,P,Ck) raw query keys; mk (B,N,2,Ck,Lm) raw prototypes;
    mv (B,N,2,Cv,Lm); base_valid (B,N,2,Lm) bool. The inference read is K2's
    (``read_affinity``, no gradients on the card). ``train`` takes the
    differentiable read in PyTorch ops, with ``keep`` (B,N,1,Lm,1) the
    optional ``p_drop`` keep mask; ``n_kernel > 0`` takes it too, with the
    Gaussian locality reweighting on the query grid ``hw`` = (h, w). The
    top-l feature always uses the undropped, unweighted affinities.
    Returns (mem_out (B,N,P,Cv), S (B,N,P,2*topl)).
    """
    if n_kernel > 0 and hw is None:
        raise ValueError("read_memory: n_kernel > 0 needs hw=(h, w) of the query grid")
    if train or n_kernel > 0:
        mem_out, exp_aff = _read_ops(qk, mk, mv, base_valid, tau=tau, n_kernel=n_kernel,
                                     sigma=sigma, hw=hw, keep=keep)
    else:
        mem_out, exp_aff = read_affinity(qk, mk, mv, base_valid, tau=tau)
    return mem_out, _perm_inv_feat(exp_aff, topl)
