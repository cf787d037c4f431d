"""Objects that first appear mid-video (the YouTube-VOS protocol) in the
plain reference: the injection of their ground truth, and a replay that
follows served maps through it.

At a frame where objects appear, after the decode and before the memorize:
every channel of the prediction is zeroed where a new object lies, each
new slot's channel takes the new object's one-hot ground truth, and the
new slots join ``active``. The frame's map and its memorize then carry the
new objects. Injections are given as the runner takes them: {frame index:
(slot-index map (B,Ho,Wo) uint8, where object slot s is s + 1; new slots
(B,N) bool)}, host arrays.
"""

from __future__ import annotations

import torch

from vosbench.reference import memory as M
from vosbench.reference.engine import Replay, _objects, one_hot, preprocess
from vosbench.reference.model import aggregate


def injected_truth(idx_map, new):
    """(B,Ho,Wo) slot-index map and new slots (B,N) -> the new objects'
    one-hot ground truth (B,Ho,Wo,N+1) float32: channel s + 1 is 1 where
    slot s is new and the map holds s + 1; channel 0 and old slots are 0."""
    n = new.shape[1]
    hot = one_hot(idx_map, n + 1)[..., 1:] * new[:, None, None, :].float()
    return torch.cat([torch.zeros_like(hot[..., :1]), hot], dim=-1)


def inject(pred, active, truth, new):
    """pred (B,Ho,Wo,N+1) probabilities, active (B,N), the new objects'
    ``injected_truth`` and new (B,N) -> (pred, active) after the
    injection."""
    under = truth.amax(dim=-1, keepdim=True) > 0
    pred = pred * ~under
    for s in range(new.shape[1]):
        row = new[:, s][:, None, None]
        pred[..., s + 1] = torch.where(row, truth[..., s + 1], pred[..., s + 1])
    return pred, active | new


class InjectReplay(Replay):
    """``Replay`` over a batch of videos, whose step takes an injection
    between decode and memorize."""

    def encode_batch(self, frames):
        """The memory-independent features of frames (C,B,H,W,3), encoded in
        one batch of C x B as the program encodes a chunk: per frame, the
        features of its B videos."""
        C, B = frames.shape[:2]
        flat = frames.reshape((C * B,) + tuple(frames.shape[2:]))
        net = self.net
        qk16, qv16, s16, s8, s4 = net.encode_key(flat)
        feats = (qk16, qv16, s16) + net.skips(s8, s4) + (net.frame_stem(flat),)
        return [tuple(f[i * B:(i + 1) * B] for f in feats) for i in range(C)]

    def step_injected(self, mem, frame, active, keys, served=None, memorize=True,
                      injection=None):
        """One frame with its features ``keys`` -> (memory, pred (B,Ho,Wo,N+1),
        active). ``injection``: (truth, new) of objects appearing here. The
        memorize takes the served labels (B,Ho,Wo) as its hard mask where
        given, else the argmax of the prediction."""
        net = self.net
        qk16, qv16, s16, skip8, skip4, vf = keys
        ctx = net.match(qk16, qv16, mem)
        probs = net.decode_objects(ctx, skip8, skip4, active.float(), self.out_size)
        pred = torch.softmax(aggregate(probs), dim=-1)
        if injection is not None:
            pred, active = inject(pred, active, *injection)
        if memorize:
            labels = pred.argmax(dim=-1) if served is None else served
            soft_in = M.bilinear(pred.movedim(-1, 1), frame.shape[1:3]).movedim(1, -1)
            mv16 = net.encode_value(frame, soft_in, s16, vf)
            hard = _objects(one_hot(labels, pred.shape[-1]))
            masks = M.em_masks(hard, _objects(soft_in), qk16.shape[-2:])
            mem = self._memorize(mem, qk16, mv16, masks, active)
        return mem, pred, active


def holds(idx, new):
    """(B,Ho,Wo) label map, new slots (B,N) -> where the map holds a new
    slot's label (slot s is label s + 1)."""
    labels = torch.cat([torch.zeros_like(new[:, :1]), new], dim=1)
    return labels[torch.arange(idx.shape[0], device=idx.device)[:, None, None], idx.long()]


def judged_frames(injections):
    """The frames that ``inject_confident`` judges: each injection frame,
    whose map carries the new objects, and the next, the first answer from a
    memory that holds them."""
    return sorted({u for t in injections for u in (t, t + 1)})


def replay(net, out_hw, raw, in_hw, init_mask, active, bases, injections, served=None,
           chunks=None, first=None, arrivals=None, injected=None, every=None, after=None,
           stop=None):
    """Run the reference over a batch of videos whose objects may appear
    mid-video, as the runner runs them: raw (T,B,H,W,3) uint8 frames on the
    device, made the model's input (/255, bicubic to ``in_hw``) and
    key-encoded in the batches (``chunks`` of frames, each of all B videos)
    the program makes them; init_mask (B,Ho,Wo,N+1) and active (B,N), the
    frame-0 state; ``injections`` as the runner takes them. With ``served``
    (T-1 host uint8 maps, (B,Ho,Wo), or (Ho,Wo) at B = 1) each frame is
    decoded from a memory built with the served labels, and judged: frame 1
    into ``first``, each injection frame on the new objects' ground-truth
    pixels (where the map must hold their slots, in any precision) into
    ``arrivals``, the ``judged_frames`` into ``injected``, every frame into
    ``every`` (objects with an ``add(pred, served)``), and the frame after
    each injection, on the pixels where the served map or the reference's
    best gives an object injected there its label, into ``after``. Without,
    the reference runs free and returns its own maps
    (host uint8 (B,Ho,Wo)). ``stop``: frames 1..stop-1 only (the first
    chunk is still encoded whole); the last frame run is not memorized."""
    rep = InjectReplay(net, out_hw)
    dev = raw.device
    T = raw.shape[0]
    stop = stop or T
    chunks = list(chunks or [1] * (T - 1))
    judged = set(judged_frames(injections))
    out, keys, arrived = [], [], None
    with torch.no_grad():
        mem = rep.init(preprocess(raw[0], in_hw), init_mask, active, bases)
        for t in range(1, stop):
            if not keys:
                frames = preprocess(raw[t:t + chunks.pop(0)], in_hw)
                keys = list(zip(frames.unbind(0), rep.encode_batch(frames)))
            frame, k = keys.pop(0)
            injection = None
            if t in injections:
                idx_map, new = (torch.as_tensor(a).to(dev) for a in injections[t])
                injection = (injected_truth(idx_map, new), new)
            # the slots injected at the frame before, and at this one
            before, arrived = arrived, None if injection is None else injection[1]
            label = None
            if served is not None:
                label = torch.as_tensor(served[t - 1]).to(dev)
                label = label if label.dim() == 3 else label[None]
            mem, pred, active = rep.step_injected(mem, frame, active, k, served=label,
                                                  memorize=t < stop - 1, injection=injection)
            if served is None:
                out.append(pred.argmax(dim=-1).to(torch.uint8).cpu().numpy())
                continue
            for tally, judge in ((first, t == 1), (injected, t in judged), (every, True)):
                if tally is not None and judge:
                    tally.add(pred, label)
            hits = []
            if arrivals is not None and injection is not None:
                hits.append((arrivals, injection[0].amax(dim=-1) > 0))
            if after is not None and before is not None:
                hits.append((after, holds(pred.argmax(dim=-1), before) | holds(label, before)))
            for tally, hit in hits:
                if hit.any():
                    tally.add(pred[hit], label[hit])
    return out
