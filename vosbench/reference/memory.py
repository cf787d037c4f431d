"""The plain EM memory: bases, the W/E/M loop, memorize and the read.

A frozen copy of the port's plain versions of its two kernels (the EM loop
and the fused memory read) and of the memory around them, in float32
PyTorch. Shapes: bases (B, N, 2, C, L) with branch axis 2 = [bg, fg];
inactive slots carry all-zero masks, which makes their update a no-op.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass
class Bases:
    kappa: torch.Tensor  # (B,N,2,Ck,L)
    nu: torch.Tensor  # (B,N,2,Cv,L)
    zita: torch.Tensor  # (B,N,2,1,L)


@dataclass
class Memory:
    first: Bases
    update: Bases
    seen: torch.Tensor  # (B,N) bool
    count: int  # memorize calls so far


def l2norm(x, dim):
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + 1e-6)


def draw_bases(generator, batch, n_objs, key_dim, val_dim, n_bases, device) -> Bases:
    """kappa ~ N(0, 2/L) normalized over channels, nu = 0, zita = 1e-6."""
    kappa = torch.randn((batch, n_objs, 2, key_dim, n_bases), generator=generator, device=device)
    kappa = l2norm(kappa * math.sqrt(2.0 / n_bases), -2)
    nu = torch.zeros((batch, n_objs, 2, val_dim, n_bases), device=device)
    zita = torch.full((batch, n_objs, 2, 1, n_bases), 1e-6, device=device)
    return Bases(kappa, nu, zita)


def fresh(bases: Bases) -> Memory:
    B, N = bases.kappa.shape[:2]
    seen = torch.zeros((B, N), dtype=torch.bool, device=bases.kappa.device)
    return Memory(bases, bases, seen, 0)


def gather(m: Memory):
    """Both banks along L -> mk (B,N,2,Ck,2L), mv (B,N,2,Cv,2L), valid (B,N,2,2L)."""
    mk = torch.cat([m.first.kappa, m.update.kappa], dim=-1)
    mv = torch.cat([m.first.nu, m.update.nu], dim=-1)
    L = m.first.kappa.shape[-1]
    B, N = m.seen.shape
    first = m.seen[:, :, None, None].expand(B, N, 2, L)
    return mk, mv, torch.cat([first, first & (m.count >= 2)], dim=-1)


def read(qk, mk, mv, valid, *, tau):
    """qk (B,P,Ck) and mk (B,N,2,Ck,Lm) raw; mv (B,N,2,Cv,Lm) -> (mem_out
    (B,N,P,Cv), exp_aff (B,N,2,Lm,P)): affinity of the normalized keys, a
    joint softmax over both branches and all valid bases, the value read."""
    aff = torch.matmul(l2norm(mk, -2).transpose(-1, -2),
                       l2norm(qk, -1).transpose(1, 2)[:, None, None])
    v = valid[..., None]
    aff = aff.masked_fill(~v, float("-inf"))
    maxes = aff.amax(dim=(2, 3), keepdim=True)
    exp_aff = torch.where(v, torch.exp((aff - maxes) / tau), 0.0)
    p = exp_aff / (exp_aff.sum(dim=(2, 3), keepdim=True) + 1e-30)
    return torch.einsum("bnsvl,bnslp->bnpv", mv, p), exp_aff


def topl_feature(exp_aff, topl):
    """(B,N,2,Lm,P) -> (B,N,P,2 topl): the background share of the running
    sums of each branch's top-l affinities, and one minus it."""
    tops = torch.topk(exp_aff, topl, dim=3, sorted=True).values
    cum = torch.cumsum(tops, dim=3)
    bg, fg = cum[:, :, 0], cum[:, :, 1]
    ratio = (bg / (bg + fg + 1e-30)).transpose(-1, -2)
    return torch.cat([ratio, 1.0 - ratio], dim=-1)


def em_loop(x, masks, kappa0, zita0, *, n_iters, tau):
    """The weighted EM loop -> (z (B,N,2,P,L), kappa, zita)."""
    xn = l2norm(x, -1)
    weights, kappa, z, zita = masks, kappa0, None, zita0
    for i in range(n_iters):
        logits = torch.matmul(x[:, None, None], l2norm(kappa, -2))
        z = torch.softmax(logits / tau, dim=-1) * weights[..., None]
        zita = zita0 + z.sum(dim=-2)[..., None, :]
        kappa = (zita0 * kappa0 + torch.matmul(x.transpose(1, 2)[:, None, None], z)) / zita
        if i < n_iters - 1:
            s = torch.matmul(xn[:, None, None], l2norm(kappa, -2))
            maxes = s.amax(dim=-1, keepdim=True).amax(dim=2, keepdim=True)
            sum_exp = torch.exp((s - maxes) / tau).sum(dim=-1)
            weights = masks * (1.0 - sum_exp / sum_exp.sum(dim=2, keepdim=True))
    return z, kappa, zita


def memorize(m: Memory, x, v, masks, active, *, n_iters, tau) -> Memory:
    """x (B,P,Ck); v (B,N,P,Cv); masks (B,N,2,P); active (B,N). The loop
    runs without gradients; only ``nu`` carries them."""
    masks = masks * active[:, :, None, None].to(masks.dtype)
    b0 = m.update
    with torch.no_grad():
        z, kappa, zita = em_loop(x.detach(), masks.detach(), b0.kappa.detach(),
                                 b0.zita.detach(), n_iters=n_iters, tau=tau)
    nu = (b0.zita.detach() * b0.nu + torch.matmul(v.transpose(-1, -2)[:, :, None], z)) / zita
    new = Bases(kappa, nu, zita)
    newly = (active & ~m.seen)[:, :, None, None, None]
    first = Bases(*(torch.where(newly, a, b) for a, b in
                    ((new.kappa, m.first.kappa), (new.nu, m.first.nu),
                     (new.zita, m.first.zita))))
    return Memory(first, new, m.seen | active, m.count + 1)


def nearest(x, size):
    """Legacy nearest resize of the (H, W) axes -2, -1: source index
    floor(dst * in / out), the scale in float32."""
    for axis, out in ((-2, size[0]), (-1, size[1])):
        n = x.shape[axis]
        scale = torch.tensor(n / out, dtype=torch.float32)
        idx = torch.floor(torch.arange(out, dtype=torch.float32) * scale).long().clamp_(0, n - 1)
        x = x.index_select(axis, idx.to(x.device))
    return x


def bilinear(x, size):
    """(..., H, W) float32 -> (..., h, w), half-pixel centres."""
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape((-1, 1) + tuple(x.shape[-2:])), size=tuple(size),
                      mode="bilinear", align_corners=False)
    return y.reshape(lead + tuple(size))


def em_masks(hard, soft, size16):
    """hard/soft (B,N,H,W) object channels -> (B,N,2,P) [bg, fg] weights at
    1/16: fg = nearest(hard) * bilinear(soft), bg = (1 - hard)(1 - soft)."""
    h = nearest(hard.float(), size16)
    s = bilinear(soft.float(), size16)
    B, N = h.shape[:2]
    return torch.stack([(1.0 - h) * (1.0 - s), h * s], dim=2).reshape(B, N, 2, -1)
