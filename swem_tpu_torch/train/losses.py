"""VOS training losses, counterpart of ``swem_tpu/train/losses.py``.

Invalid object channels get -1e9 logits, which restricts the softmax and
the cross entropy to the valid channels exactly (targets never index an
invalid channel).

Layout: logits (B, T, H, W, C) channel-last, target (B, T, H, W) integer,
valid_obj (B, C) float {0,1} including the background channel (always 1).
The iteration ``it`` is a host integer, so the bootstrapped fraction and
its pixel count k are host numbers, computed in float32 as the JAX package
computes them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

_NEG_INF = -1e9


def _mask_logits(logits: torch.Tensor, valid_obj: Optional[torch.Tensor]) -> torch.Tensor:
    if valid_obj is None:
        return logits
    return torch.where(valid_obj[:, None, None, None, :] > 0.5, logits, _NEG_INF)


def _one_hot(target: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """Out-of-range targets get an all-zero row."""
    return (target[..., None] == torch.arange(n, device=target.device)).to(dtype)


def pixel_ce(logits: torch.Tensor, target: torch.Tensor,
             valid_obj: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-pixel cross entropy over the valid channels, (B,T,H,W). A target
    outside [0, C) contributes exactly 0."""
    logp = torch.log_softmax(_mask_logits(logits, valid_obj), dim=-1)
    return -(logp * _one_hot(target, logits.shape[-1], logp.dtype)).sum(dim=-1)


def bootstrap_fraction(it: int, start_warm: int, end_warm: int, top_p: float) -> float:
    """Annealed hardest-pixel fraction: 1.0 before ``start_warm``, then
    linear 1.0 -> ``top_p`` by ``end_warm`` (float32 arithmetic)."""
    if it < start_warm:
        return 1.0
    f32 = np.float32
    frac = f32(top_p) + f32(1.0 - top_p) * f32(end_warm - it) / f32(end_warm - start_warm)
    return float(np.clip(frac, f32(top_p), f32(1.0)))


def bootstrapped_ce(logits, target, it: int, valid_obj=None, *, start_warm=20000,
                    end_warm=70000, top_p=0.30):
    """Mean cross entropy over the top-p hardest pixels of each frame.

    k = floor(H*W*p) pixels per (b, t) at weight 1/k: every pixel above t,
    the exact k-th largest pixel loss, then the first k - count(> t) pixels
    equal to t in memory order. That tie rule matters at random init, where
    the aggregation's clamp saturates many pixels to one CE value.
    Returns (loss, p).
    """
    B, T, H, W = target.shape
    raw = pixel_ce(logits, target, valid_obj).reshape(B, T, H * W)
    p = bootstrap_fraction(it, start_warm, end_warm, top_p)
    k = int(np.floor(np.float32(H * W) * np.float32(p)))
    if k == 0:
        return raw.sum() * 0.0, p
    t = torch.topk(raw.detach(), k, dim=-1).values[..., -1:]  # (B,T,1)
    gt, eq = raw > t, raw == t
    cnt_gt = gt.sum(dim=-1, keepdim=True)
    eq_rank = torch.cumsum(eq.to(torch.int32), dim=-1)  # 1-based
    sel = gt | (eq & (eq_rank <= k - cnt_gt))
    return (raw * sel.to(raw.dtype)).sum() / (B * T * k), p


def plain_ce(logits, target, it: int, valid_obj=None, **_):
    """Mean cross entropy over all pixels. Returns (loss, 1.0)."""
    return pixel_ce(logits, target, valid_obj).mean(), 1.0


def mask_iou_loss(logits, target, valid_obj=None):
    """Soft mask-IoU loss: per (b, t, channel) soft IoU of the softmax with
    the one-hot target, averaged over valid channels and frames, 1 - iou
    averaged over the batch."""
    B, T, H, W = target.shape
    C = logits.shape[-1]
    pred = torch.softmax(_mask_logits(logits, valid_obj), dim=-1)
    tgt = _one_hot(target, C, pred.dtype)
    inter = torch.minimum(pred, tgt).sum(dim=(2, 3))  # (B,T,C)
    union = torch.maximum(pred, tgt).sum(dim=(2, 3)) + 1e-6
    iou = inter / union
    if valid_obj is None:
        valid = torch.ones((B, C), dtype=iou.dtype, device=iou.device)
    else:
        valid = (valid_obj > 0.5).to(iou.dtype)
    per_b = (iou * valid[:, None, :]).sum(dim=(1, 2)) / (T * valid.sum(dim=-1).clamp(min=1.0))
    return (1.0 - per_b).mean()


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension w.r.t. sorted errors, along the last axis."""
    gts = gt_sorted.sum(dim=-1, keepdim=True)
    intersection = gts - torch.cumsum(gt_sorted, dim=-1)
    union = gts + torch.cumsum(1.0 - gt_sorted, dim=-1)
    jaccard = 1.0 - intersection / union
    if gt_sorted.shape[-1] > 1:
        jaccard = torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], dim=-1)
    return jaccard


def lovasz_softmax_loss(logits, target, valid_obj=None):
    """Lovász-Softmax over the classes present in each image (all pixels of
    its frames flattened), over the valid channels' softmax. Errors sort
    descending with ties in memory order, as ``jnp.argsort`` orders them."""
    C = logits.shape[-1]
    B = logits.shape[0]
    probas = torch.softmax(_mask_logits(logits, valid_obj), dim=-1).reshape(B, -1, C)
    fg = _one_hot(target.reshape(B, -1), C, probas.dtype)  # (B,P,C)
    vmask = torch.ones((B, C), device=logits.device) if valid_obj is None else valid_obj
    present = (fg.sum(dim=1) > 0) & (vmask > 0.5)  # (B,C)
    errors = (fg - probas).abs()
    order = torch.argsort(-errors, dim=1, stable=True)
    err_sorted = torch.gather(errors, 1, order)
    grad = _lovasz_grad(torch.gather(fg, 1, order).transpose(1, 2)).transpose(1, 2)
    per_class = (err_sorted * grad).sum(dim=1)  # (B,C)
    denom = present.sum(dim=-1).clamp(min=1)
    return (torch.where(present, per_class, 0.0).sum(dim=-1) / denom).mean()


def lovasz_hinge_loss(logits, labels):
    """Binary Lovász hinge, flattened over the batch. logits real scores,
    labels {0,1}, any matching shape."""
    logits = logits.reshape(-1)
    labels = labels.reshape(-1).to(logits.dtype)
    signs = 2.0 * labels - 1.0
    errors = 1.0 - logits * signs
    order = torch.argsort(-errors.detach(), stable=True)
    grad = _lovasz_grad(labels[order])
    return torch.dot(torch.relu(errors[order]), grad)


MAIN_LOSSES = {"ce": plain_ce, "boots_ce": bootstrapped_ce}
AUX_LOSSES = {"iou": mask_iou_loss, "lovasz": lovasz_softmax_loss}


def make_criterion(loss_cfg):
    """The combined VOS loss: fn(logits, target, it, valid_obj) -> dict of
    ``total_loss``, ``main_loss``, ``aux_loss`` (tensors) and ``p`` (host float)."""
    main_fn = MAIN_LOSSES[loss_cfg.name]
    aux_fn = AUX_LOSSES[loss_cfg.aux] if loss_cfg.aux else None
    start_warm, end_warm = loss_cfg.bs_period

    def criterion(logits, target, it: int, valid_obj=None) -> Dict[str, torch.Tensor]:
        loss_main, p = main_fn(logits, target, it, valid_obj, start_warm=start_warm,
                               end_warm=end_warm, top_p=loss_cfg.bs_ratio)
        if aux_fn is not None:
            loss_aux = aux_fn(logits, target, valid_obj)
        else:
            loss_aux = torch.zeros((), device=logits.device)
        return {"total_loss": loss_main + loss_cfg.aux_ratio * loss_aux,
                "main_loss": loss_main, "aux_loss": loss_aux, "p": p}

    return criterion
