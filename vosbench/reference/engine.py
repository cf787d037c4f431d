"""The plain inference loop: frame 0 seeds the memory, each later frame is
read, decoded and memorized.

``Replay.step`` can follow served index maps: the reference then decodes
each frame from a memory built from its own soft masks and the served
labels, the way a language model's reference is run over the served
tokens, and the served map is judged against the reference's decode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vosbench.reference import memory as M
from vosbench.reference.model import Network, aggregate


def preprocess(frames_u8, in_size):
    """uint8 (..., H, W, 3) on the device -> float32 in [0, 1], bicubic to
    ``in_size`` where the sizes differ, each channel as its own image (the
    result is laid out channel-major, as the program's is: the layout
    decides which convolution algorithms the towers get)."""
    f = frames_u8.float() / 255.0
    if tuple(f.shape[-3:-1]) == tuple(in_size):
        return f
    x = f.movedim(-1, -3)
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape((-1, 1) + tuple(x.shape[-2:])), size=tuple(in_size),
                      mode="bicubic", align_corners=False)
    return y.reshape(lead + tuple(in_size)).movedim(-3, -1)


def one_hot(labels, n):
    """(..., H, W) integer labels -> (..., H, W, n) float32."""
    return (labels.long()[..., None] == torch.arange(n, device=labels.device)).float()


def _objects(masks):
    """(B,H,W,N+1) -> object channels (B,N,H,W)."""
    return masks[..., 1:].movedim(-1, 1)


class Replay:
    """Inference of one batch of videos with network ``net``."""

    def __init__(self, net: Network, out_size):
        self.net, self.cfg, self.out_size = net, net.cfg, tuple(out_size)

    def _memorize(self, mem, qk16, mv16, masks, active):
        x = qk16.flatten(2).transpose(1, 2).float()
        v = mv16.flatten(3).transpose(2, 3).float()
        return M.memorize(mem, x, v, masks, active, n_iters=self.cfg["num_em_iters"],
                          tau=self.cfg["em_tau"])

    def init(self, frame0, init_mask, active, bases: M.Bases) -> M.Memory:
        """frame0 (B,H,W,3); init_mask (B,Ho,Wo,N+1) one-hot; active (B,N)."""
        qk16, _, s16, _, _ = self.net.encode_key(frame0)
        mask_in = M.nearest(init_mask.movedim(-1, 1), frame0.shape[1:3]).movedim(1, -1)
        mv16 = self.net.encode_value(frame0, mask_in, s16)
        B = frame0.shape[0]
        mem = M.fresh(M.Bases(*(t.expand((B,) + t.shape[1:]) for t in
                                (bases.kappa, bases.nu, bases.zita))))
        obj = _objects(init_mask)
        masks = M.em_masks(obj, obj, qk16.shape[-2:])
        return self._memorize(mem, qk16, mv16, masks, active)

    def encode(self, frames):
        """The memory-independent features of frames (C,H,W,3), encoded in
        one batch: [(qk16, qv16, s16, skip8, skip4, vf)] per frame, each
        with a batch axis of 1."""
        net = self.net
        qk16, qv16, s16, s8, s4 = net.encode_key(frames)
        feats = (qk16, qv16, s16) + net.skips(s8, s4) + (net.frame_stem(frames),)
        return [tuple(f[i:i + 1] for f in feats) for i in range(frames.shape[0])]

    def step(self, mem, frame, active, served=None, memorize=True, keys=None):
        """One frame -> (memory, pred_mask (B,Ho,Wo,N+1)). The memorize takes
        the served labels (B,Ho,Wo) as its hard mask where given, else the
        argmax of the reference's own prediction. ``keys``: the frame's
        ``encode`` features, if already computed."""
        net = self.net
        qk16, qv16, s16, skip8, skip4, vf = keys or self.encode(frame)[0]
        ctx = net.match(qk16, qv16, mem)
        probs = net.decode_objects(ctx, skip8, skip4, active.float(), self.out_size)
        pred = torch.softmax(aggregate(probs), dim=-1)
        if memorize:
            labels = pred.argmax(dim=-1) if served is None else served
            soft_in = M.bilinear(pred.movedim(-1, 1), frame.shape[1:3]).movedim(1, -1)
            mv16 = net.encode_value(frame, soft_in, s16, vf)
            hard = _objects(one_hot(labels, pred.shape[-1]))
            masks = M.em_masks(hard, _objects(soft_in), qk16.shape[-2:])
            mem = self._memorize(mem, qk16, mv16, masks, active)
        return mem, pred


def judge(pred, served):
    """The reference's prediction (B,Ho,Wo,N+1) against served labels
    (B,Ho,Wo) -> pixels, and pixels whose served label's probability lies
    more than 0.5 below the reference's best."""
    gap = pred.max(dim=-1).values - pred.gather(-1, served.long()[..., None])[..., 0]
    return {"pixels": served.numel(), "confident": int((gap > 0.5).sum())}
