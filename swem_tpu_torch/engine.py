"""Frame-sequential inference engine, counterpart of ``swem_tpu/engine.py``.

The EM memory is an explicit ``VOSMemory`` carried through a Python loop
over frames. Frames are ``(T, B, H, W, 3)`` float in [0, 1], masks
``(B, Ho, Wo, N+1)`` one-hot at the output size, ``active`` ``(B, N)`` bool;
predictions are ``(T-1, B, Ho, Wo)`` uint8 slot indices. Every tensor lives
on ``model.device``.

Every entry point runs without gradients and under ``full_float32``: float32
convolutions and matrix products compute in full float32 whatever the
caller's TF32 flags, at both compute dtypes. The features enter the memory
as float32.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from swem_tpu_torch.config import full_float32
from swem_tpu_torch.models import em
from swem_tpu_torch.models.swem import SWEM, prepare_em_masks, prepare_em_masks_from_idx
from swem_tpu_torch.ops.resize import resize


def _entry_point(fn):
    """Run ``fn`` without gradients, under ``full_float32``."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with torch.no_grad(), full_float32():
            return fn(*args, **kwargs)
    return run


def _flat_qk(qk16):
    """(B,Ck,h,w) -> (B,P,Ck) float32."""
    return qk16.flatten(2).transpose(1, 2).float()


def _flat_mv(mv16):
    """(B,N,Cv,h,w) -> (B,N,P,Cv) float32."""
    return mv16.flatten(3).transpose(2, 3).float()


@_entry_point
def init_memory(model: SWEM, generator: Optional[torch.Generator], frame0, init_mask, active, *,
                bases: Optional[em.Bases] = None) -> em.VOSMemory:
    """Frame-0 memory: encode frame 0 and its mask, EM-memorize from fresh bases.

    frame0 (B,H,W,3); init_mask (B,Ho,Wo,N+1); active (B,N). The initial
    prototypes are one random draw from ``generator`` shared across the
    batch, or ``bases`` (batch 1 or B) when given.
    """
    cfg = model.cfg
    qk16, _, s16, _, _ = model.encode_key(frame0)
    init_mask_in = resize(init_mask.float(), tuple(frame0.shape[1:3]), "nearest")
    mv16 = model.encode_value(frame0, init_mask_in, s16)
    B, _, h, w = qk16.shape
    if bases is None:
        bases = em.init_bases(generator, 1, cfg.max_objs, cfg.keydim, cfg.valdim,
                              cfg.num_bases)
    mem = em.fresh_memory(bases.to(model.device).expand(B))
    em_masks = prepare_em_masks(init_mask, init_mask.float(), (h, w))
    return em.memorize(mem, _flat_qk(qk16), _flat_mv(mv16), em_masks, active,
                       n_iters=cfg.num_em_iters, tau=cfg.em_tau)


@_entry_point
def encode_keys_batched(model: SWEM, frames):
    """Key-encode a frame stack in one batched pass: (T,B,H,W,3) -> tuple of (T,B,...)."""
    T, B = frames.shape[:2]
    keys = model.encode_frame(frames.reshape((T * B,) + frames.shape[2:]))
    return tuple(k.reshape((T, B) + k.shape[1:]) for k in keys)


@_entry_point
def step(model: SWEM, mem: em.VOSMemory, frame, active, out_size: Tuple[int, int], *,
         do_memorize: bool = True, inject_mask=None, inject_new=None, keys=None):
    """One inference frame.

    frame (B,H,W,3); active (B,N) slots live before this frame;
    inject_mask (B,Ho,Wo,N+1) + inject_new (B,N): ground-truth masks of
    objects appearing at this frame. ``keys``: this frame's ``encode_frame``
    tuple, if already computed. Returns (mem, pred_idx (B,Ho,Wo) uint8,
    pred_mask (B,Ho,Wo,N+1)).
    """
    if keys is None:
        keys = model.encode_frame(frame)
    qk16, qv16, s16, skip8, skip4, vf = keys
    context = model.match(qk16, qv16, mem)
    _, pred_mask = model.decode(context, skip8, skip4, active.float(), out_size)

    if inject_mask is not None:
        # zero predictions under newly-injected objects, then overwrite the
        # new slots' channels with the provided ground truth
        new_any = inject_mask[..., 1:].sum(dim=-1, keepdim=True) > 0
        pred_mask = torch.where(new_any, 0.0, pred_mask)
        ch_sel = torch.cat([torch.zeros_like(inject_new[:, :1]), inject_new], dim=-1)
        pred_mask = torch.where(ch_sel[:, None, None, :], inject_mask.float(), pred_mask)
        active = active | inject_new

    pred_idx = pred_mask.argmax(dim=-1).to(torch.uint8)
    if do_memorize:
        mem = _memorize_from_pred(model, mem, frame, active, qk16, s16, vf, pred_idx, pred_mask)
    return mem, pred_idx, pred_mask


def _memorize_from_pred(model: SWEM, mem, frame, active, qk16, s16, vf, pred_idx, pred_mask):
    """Value-encode the predicted mask and EM-update the memory."""
    cfg = model.cfg
    soft_in = resize(pred_mask, tuple(frame.shape[1:3]), "bilinear")
    mv16 = model.encode_value(frame, soft_in, s16, vf)
    em_masks = prepare_em_masks_from_idx(pred_idx, soft_in, tuple(qk16.shape[-2:]))
    return em.memorize(mem, _flat_qk(qk16), _flat_mv(mv16), em_masks, active,
                       n_iters=cfg.num_em_iters, tau=cfg.em_tau)


@_entry_point
def run_chunk(model: SWEM, mem: em.VOSMemory, frames, active, out_size: Tuple[int, int], *,
              final: bool = False) -> Tuple[em.VOSMemory, torch.Tensor]:
    """Run a chunk of frames (C,B,H,W,3), carrying the memory -> (mem, preds
    (C,B,Ho,Wo) uint8). The chunk's keys are encoded in one batched pass.
    ``final``: the chunk ends the video, so its last frame is not memorized
    (the memory after the video is never read)."""
    keys = encode_keys_batched(model, frames)
    preds = []
    for t in range(frames.shape[0]):
        last = final and t == frames.shape[0] - 1
        mem, pred_idx, _ = step(model, mem, frames[t], active, out_size,
                                do_memorize=not last, keys=tuple(k[t] for k in keys))
        preds.append(pred_idx)
    return mem, torch.stack(preds)


@_entry_point
def run_video(model: SWEM, generator: Optional[torch.Generator], frames, init_mask, active,
              out_size: Tuple[int, int], *, bases: Optional[em.Bases] = None) -> torch.Tensor:
    """Whole-video inference: frames (T,B,H,W,3) -> (T-1,B,Ho,Wo) uint8 for
    frames 1..T-1. Frame 0 and its mask seed the memory; the last frame is
    not memorized."""
    mem = init_memory(model, generator, frames[0], init_mask, active, bases=bases)
    T, B = frames.shape[:2]
    if T == 1:
        return torch.zeros((0, B) + tuple(out_size), dtype=torch.uint8, device=frames.device)
    _, preds = run_chunk(model, mem, frames[1:], active, out_size, final=True)
    return preds
