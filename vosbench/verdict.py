"""Served index maps judged against the plain reference.

The reference is run over a served video (or stream) with its served
maps: frame 0 and its mask seed the reference's memory, each later frame
is decoded from that memory, and memorized with the served labels as the
hard mask and the reference's own soft mask (``Replay.step(served=...)``).
Each served map is judged against the reference's decode of its frame:
the share of pixels whose served label lies more than 0.5 below the
reference's best (``Tally``), which precision noise near a tie between
labels does not reach and a wrong decode does.

- ``confident``: over every frame of the sampled videos (or streams);
- ``first_confident``: over the first predicted frame of every video (or
  stream) the window finished. At random weights and tau 0.05 a bf16
  runner's later frames can depart from any reference that does not
  repeat its rounding bit for bit (a recurrent memory amplifies one
  flipped bf16 rounding), as far as the fp8 control's: both bf16 cells
  are judged on their first answers.
"""

from __future__ import annotations

import torch

from vosbench.reference import engine as ref_engine
from vosbench.reference.lowp import Fp8Ops, precision
from vosbench.reference.model import DTYPES, Network


def network(cfg: dict, weights, arithmetic: str = "float32"):
    """(the reference network, a function giving its precision scope) for
    ``arithmetic``: "float32" (the reference), "tf32" or "fp8" (the
    controls)."""
    ops = Fp8Ops(DTYPES[cfg["dtype"]]) if arithmetic == "fp8" else None
    mode = "tf32" if arithmetic == "tf32" else "float32"
    return Network(cfg, weights, ops), lambda: precision(mode)


class Tally:
    """Pixels judged, and those whose served label lies more than 0.5
    below the reference's best."""

    def __init__(self):
        self.pixels = self.confident = 0
        self.frames = []  # each judged frame's share

    def add(self, pred, served) -> None:
        j = ref_engine.judge(pred, served)
        self.pixels += j["pixels"]
        self.confident += j["confident"]
        self.frames.append(j["confident"] / j["pixels"])

    def share(self) -> float:
        return self.confident / self.pixels


def replay(net, out_hw, raw, in_hw, init_mask, active, bases, served=None, memorize_last=False,
           tally: Tally = None, chunks=None, first: Tally = None, stop: int = None):
    """Run the reference over one video: raw (T,H,W,3) uint8 frames on the
    device, made the model's input (/255, bicubic to ``in_hw``) in the
    batches the program makes them, init_mask (1,Ho,Wo,N+1), active (1,N).
    With ``served`` (T-1 maps, host uint8 (Ho,Wo)) each frame is judged
    into ``tally`` and memorized with the served labels; without, the
    reference runs free and returns its own maps (T-1 host uint8 (Ho,Wo)).
    ``chunks``: the sizes of the batches in which frames 1.. are made
    ready and key-encoded (the program's chunks; default one frame each).
    ``first``: the first served map is judged into it as well. ``stop``:
    run frames 1..stop-1 only (all frames of the first chunk are still
    encoded together, as the program encodes them)."""
    rep = ref_engine.Replay(net, out_hw)
    dev = raw.device
    T = raw.shape[0]
    chunks = list(chunks or [1] * (T - 1))
    out, keys = [], []
    with torch.no_grad():
        mem = rep.init(ref_engine.preprocess(raw[:1], in_hw), init_mask, active, bases)
        for t in range(1, stop or T):
            if not keys:
                frames = ref_engine.preprocess(raw[t:t + chunks.pop(0)], in_hw)
                keys = list(zip(frames.split(1), rep.encode(frames)))
            frame, k = keys.pop(0)
            label = None if served is None else torch.from_numpy(served[t - 1]).to(dev)[None]
            last = t == (stop or T) - 1 and not (memorize_last and stop is None)
            mem, pred = rep.step(mem, frame, active, served=label, memorize=not last, keys=k)
            if served is None:
                out.append(pred.argmax(dim=-1)[0].to(torch.uint8).cpu().numpy())
            else:
                if tally is not None:
                    tally.add(pred, label)
                if t == 1 and first is not None:
                    first.add(pred, label)
    return out
