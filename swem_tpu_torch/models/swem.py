"""SWEM network, counterpart of ``swem_tpu/models/swem.py``.

``SWEM`` is an ``nn.Module`` whose attribute names follow the reference
implementation's ``state_dict`` keys (``key_encoder.res2.*``,
``value_encoder.layer1.*``, ``swem_core.fusion_layer.*``, ...). The EM memory
is an explicit ``VOSMemory`` threaded by the caller (see ``engine.py``).

Layouts: frames ``(B, H, W, 3)`` and masks ``(B, H, W, N+1)`` (channel 0 =
background) are channel-last, as in the JAX package; feature maps between
the stages are NCHW, with the object axis after the batch axis.

Precision: the conv towers compute in ``cfg.dtype`` (``compute_dtype``);
the memory read's inputs, the decode from the last resize on and the EM
masks are float32, with the casts where the JAX package puts them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from swem_tpu_torch.config import ModelConfig, compute_dtype, resolve_device
from swem_tpu_torch.models import em
from swem_tpu_torch.models.decoder import Decoder
from swem_tpu_torch.models.encoders import KeyEncoder, KeyProjection, ValueEncoder
from swem_tpu_torch.models.layers import GLUFusion, conv3x3
from swem_tpu_torch.models.resnet import BACKBONE_FEATURES
from swem_tpu_torch.ops.resize import resize


class SwemCore(nn.Module):
    """Holds the GLU fusion of [memory read, query value, top-l feature]."""

    def __init__(self, cin: int, valdim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fusion_layer = GLUFusion(cin, valdim, dtype)


def _fold(t: torch.Tensor, n: int) -> torch.Tensor:
    """(B, ...) -> (B*n, ...), each batch row repeated for the n objects."""
    return t[:, None].expand((t.shape[0], n) + t.shape[1:]).reshape((-1,) + t.shape[1:])


class SWEM(nn.Module):
    """Encoders + EM fusion + decoder, placed on ``device`` (None = CUDA).

    The parameters are float32 at either compute dtype, so ``state_dict``
    is the same; each conv casts its kernel to ``cfg.dtype`` (round to
    nearest), as flax does, and keeps the cast across calls where no
    gradient or export trace needs it made per call (``layers.prepared``).
    """

    def __init__(self, cfg: ModelConfig = ModelConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype(cfg)
        f16, f8, f4 = BACKBONE_FEATURES[cfg.backbone]
        self.key_encoder = KeyEncoder(cfg.backbone, dt)
        self.key_proj = KeyProjection(f16, cfg.keydim, dt)
        self.key_comp = conv3x3(f16, cfg.valdim, dtype=dt)
        self.value_encoder = ValueEncoder(f16, cfg.valdim, cfg.single_object, dt)
        self.swem_core = SwemCore(2 * cfg.valdim + 2 * cfg.topl_eff, cfg.valdim, dt)
        self.decoder = Decoder(cfg.valdim, f8, f4, cfg.mdim, dt)
        self.device = resolve_device(device)
        self.to(self.device).eval()

    @torch.no_grad()
    def init_weights(self, seed: int) -> "SWEM":
        """Seeded random weights: He-uniform convs, LeCun-normal linears, zero
        biases, identity batch norms. Drawn on the CPU, so a seed gives the
        same weights on every device."""
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                if isinstance(m, nn.Conv2d):
                    lim = math.sqrt(6.0 / fan_in)
                    w = torch.empty(m.weight.shape).uniform_(-lim, lim, generator=g)
                else:
                    w = torch.empty(m.weight.shape).normal_(0.0, 1.0 / math.sqrt(fan_in), generator=g)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
        return self

    # ------------------------------------------------------------------ #
    def encode_key(self, frame):
        """frame (B,H,W,3) -> (qk16, qv16, s16, s8, s4), NCHW."""
        s16, s8, s4 = self.key_encoder(frame)
        return self.key_proj(s16), self.key_comp(s16), s16, s8, s4

    def encode_frame(self, frame):
        """All memory-independent features of a frame, computed once per frame:
        (qk16, qv16, s16, skip8, skip4, vf) with the decoder's skip convs and
        the value encoder's stem-conv frame slice."""
        qk16, qv16, s16, s8, s4 = self.encode_key(frame)
        skip8, skip4 = self.decoder.skip_feats(s8, s4)
        return qk16, qv16, s16, skip8, skip4, self.value_encoder.frame_stem(frame)

    def encode_value(self, frame, masks, s16, vf=None):
        """Per-object value features -> mv16 (B,N,Cv,h16,w16).

        frame (B,H,W,3); masks (B,H,W,N+1) soft; s16 (B,Cf,h16,w16); vf the
        optional ``frame_stem``. Objects are folded into the batch axis.
        """
        N = masks.shape[-1] - 1
        mask_fg = masks[..., 1:].movedim(-1, 1)[:, :, None]  # (B,N,1,H,W)
        mask_ot = 1.0 - mask_fg - masks[..., 0][:, None, None]
        fold_objs = lambda t: t.reshape((-1,) + t.shape[2:])  # noqa: E731
        mv = self.value_encoder(
            _fold(frame, N), _fold(s16, N), fold_objs(mask_fg),
            None if self.cfg.single_object else fold_objs(mask_ot),
            frame_stem=None if vf is None else _fold(vf, N),
        )
        return mv.reshape((frame.shape[0], N) + mv.shape[1:])

    def match(self, qk16, qv16, mem: em.VOSMemory, train: bool = False,
              keep: Optional[torch.Tensor] = None):
        """Memory read + GLU fusion -> object context (B,N,Cv,h,w).

        qk16 (B,Ck,h,w); qv16 (B,Cv,h,w). The read and the concat run in
        float32; the fusion's input is cast back to the compute dtype.
        ``train`` takes the differentiable read; with ``cfg.p_drop > 0`` it
        needs ``keep``, the (B,N,1,2L,1) keep mask (``em.draw_keep``), drawn
        by the caller so that a recomputed block drops the same bases.
        """
        B, _, h, w = qk16.shape
        mk, mv, base_valid = em.gather_memory(mem)
        N = mk.shape[1]
        if train and self.cfg.p_drop > 0 and keep is None:
            raise ValueError("SWEM.match: train with p_drop > 0 needs the keep mask")
        mem_out, S = em.read_memory(qk16.flatten(2).transpose(1, 2).float(), mk, mv, base_valid,
                                    tau=self.cfg.em_tau, topl=self.cfg.topl_eff,
                                    n_kernel=self.cfg.n_kernel, sigma=self.cfg.kernel_sigma,
                                    hw=(h, w), train=train,
                                    keep=keep if train and self.cfg.p_drop > 0 else None)
        qv = qv16.flatten(2).transpose(1, 2).float()[:, None].expand_as(mem_out)
        feats = torch.cat([mem_out, qv, S], dim=-1)  # (B,N,P,2Cv+2topl)
        feats = feats.reshape(B * N, h, w, feats.shape[-1]).permute(0, 3, 1, 2)
        context = self.swem_core.fusion_layer(feats.to(compute_dtype(self.cfg)))
        return context.reshape((B, N) + context.shape[1:])

    def decode(self, context, skip8, skip4, valid_obj: Optional[torch.Tensor],
               out_size: Tuple[int, int]):
        """Per-object logits -> soft-aggregated multi-object mask.

        context (B,N,Cv,h,w); skip8/skip4 from ``encode_frame`` at batch B;
        valid_obj (B,N) or None. Returns (logits, pred_mask), both
        (B,Ho,Wo,N+1).
        """
        logits = aggregate(self.decode_objects(context, skip8, skip4, valid_obj, out_size))
        return logits, torch.softmax(logits, dim=-1)

    def decode_objects(self, context, skip8, skip4, valid_obj: Optional[torch.Tensor],
                       out_size: Tuple[int, int]):
        """The per-object half of ``decode``: each object's sigmoid
        probability (B,Ho,Wo,N), times ``valid_obj``. Objects do not meet
        before ``aggregate``, so an object shard runs this for its slots."""
        B, N = context.shape[:2]
        logit = self.decoder.decode_with_skips(
            context.reshape((B * N,) + context.shape[2:]), _fold(skip8, N), _fold(skip4, N),
            out_size,
        )  # (BN,1,Ho,Wo)
        preds = torch.sigmoid(logit[:, 0]).reshape((B, N) + tuple(out_size)).movedim(1, -1)
        if valid_obj is not None:
            preds = preds * valid_obj[:, None, None, :]
        return preds


def aggregate(prob: torch.Tensor) -> torch.Tensor:
    """Soft aggregation: prob (B,H,W,N) -> logits (B,H,W,N+1), bg channel 0."""
    bg = torch.prod(1.0 - prob, dim=-1, keepdim=True)
    new_prob = torch.cat([bg, prob], dim=-1).clamp(1e-7, 1.0 - 1e-7)
    return torch.log(new_prob / (1.0 - new_prob))


def _stack_em_masks(hard, soft):
    """hard/soft (B,h,w,N) -> [bg, fg] pixel weights (B,N,2,h*w)."""
    stacked = torch.stack([(1.0 - hard) * (1.0 - soft), hard * soft], dim=1)  # (B,2,h,w,N)
    B, _, h, w, N = stacked.shape
    return stacked.movedim(-1, 1).reshape(B, N, 2, h * w)


def prepare_em_masks(masks_hard, masks_soft, size16: Tuple[int, int]) -> torch.Tensor:
    """EM pixel weights at 1/16: fg = nearest(hard) * bilinear(soft),
    bg = (1-hard)*(1-soft). masks (B,H,W,N+1) -> (B,N,2,P)."""
    hard = resize(masks_hard[..., 1:].float(), size16, "nearest")
    soft = resize(masks_soft[..., 1:].float(), size16, "bilinear")
    return _stack_em_masks(hard, soft)


def prepare_em_masks_from_idx(pred_idx, masks_soft, size16: Tuple[int, int],
                              slot0: int = 0) -> torch.Tensor:
    """``prepare_em_masks`` from the argmax index map (B,Ho,Wo): the nearest
    resize commutes with the one-hot, so no full-size one-hot is built.
    ``masks_soft``'s object channels are slots ``slot0 + 1, ...`` of the
    map (an object shard's)."""
    idx16 = resize(pred_idx[..., None], size16, "nearest")[..., 0].long()
    slots = torch.arange(slot0 + 1, slot0 + masks_soft.shape[-1], device=idx16.device)
    hard = (idx16[..., None] == slots).float()
    soft = resize(masks_soft[..., 1:].float(), size16, "bilinear")
    return _stack_em_masks(hard, soft)


def hard_mask_from_pred(pred_mask: torch.Tensor) -> torch.Tensor:
    """One-hot argmax over the object axis: (B,H,W,N+1) -> float one-hot."""
    idx = pred_mask.argmax(dim=-1)
    return (idx[..., None] == torch.arange(pred_mask.shape[-1], device=idx.device)).to(
        pred_mask.dtype)
