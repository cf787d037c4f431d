"""Sequential Weighted EM memory core, counterpart of ``swem_tpu/models/em.py``.

Shapes follow the JAX package: bases ``(B, N, 2, C, L)`` with ``N`` the
static object-slot count and branch axis 2 = [bg, fg]. Inactive slots carry
all-zero masks, which makes their EM update a no-op.

The W/E/M loop runs in ``ops/em_kernel.em_loop`` and the affinity read in
``ops/read_kernel.read_affinity``: hand-written kernels on a CUDA tensor,
their plain versions on a CPU tensor. Only the final ``nu`` update carries
gradients, as in the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

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
    ``mem_count`` counts memorize calls on the host: the update bank joins
    reads once it is >= 2.
    """

    first: Bases
    update: Bases
    obj_seen: torch.Tensor
    mem_count: int


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
    return VOSMemory(first=bases, update=bases,
                     obj_seen=torch.zeros((B, N), dtype=torch.bool, device=bases.kappa.device),
                     mem_count=0)


def em_update(x: torch.Tensor, v: torch.Tensor, masks: torch.Tensor, bases0: Bases, *,
              n_iters: int, tau: float) -> Bases:
    """One frame's Sequential Weighted EM update.

    x (B,P,Ck) query keys; v (B,N,P,Cv) value features; masks (B,N,2,P)
    [bg, fg] pixel weights; bases0: warm start. The loop runs without
    gradients; ``nu`` is differentiable through v and bases0.nu.
    """
    with torch.no_grad():
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
    base_valid (B,N,2,2L). The update half is valid once mem_count >= 2."""
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
    top-l values equal those of the JAX package's argmax-delete scan.
    """
    tops = torch.topk(exp_aff, topl, dim=3, sorted=True).values  # (B,N,2,topl,P)
    feat = torch.cumsum(tops, dim=3)
    bg, fg = feat[:, :, 0], feat[:, :, 1]  # branch 0 = bg
    ratio = (bg / (bg + fg + 1e-30)).transpose(-1, -2)  # (B,N,P,topl)
    return torch.cat([ratio, 1.0 - ratio], dim=-1)


def read_memory(qk, mk, mv, base_valid, *, tau: float, topl: int):
    """Attention-style memory read (inference; no locality kernel, no drop).

    qk (B,P,Ck) raw query keys; mk (B,N,2,Ck,Lm) raw prototypes;
    mv (B,N,2,Cv,Lm); base_valid (B,N,2,Lm) bool.
    Returns (mem_out (B,N,P,Cv), S (B,N,P,2*topl)).
    """
    mem_out, exp_aff = read_affinity(qk, mk, mv, base_valid, tau=tau)
    return mem_out, _perm_inv_feat(exp_aff, topl)

