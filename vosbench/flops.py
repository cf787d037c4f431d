"""Operations and bytes of the work, from shapes alone.

- ``em_loop_work`` / ``read_work``: the EM loop (K1) and the fused memory
  read (K2), each product counted once (a multiply-add is two operations),
  each input byte read once and each output byte written once.
- ``roofline_s``: the least time of a piece of work on the chip.
- ``step_flops``: the model's operations per inference step, counted by
  running the plain reference on ``meta`` tensors with a counting arithmetic: every convolution and linear layer,
  plus K1's and K2's work and the ``nu`` product of each memorize.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def em_loop_work(B, N, P, Ck, L, n_iters):
    """K1: the E step's and the M step's products in every round; the W
    step's product is the next E step's scaled per pixel, so it adds none.
    Bytes: x, masks, kappa0, zita0 in; z, kappa, zita out (float32)."""
    flops = 2.0 * B * P * Ck * 2 * N * L * 2 * n_iters
    nbytes = 4.0 * (B * P * Ck + B * N * 2 * P + 2 * (B * N * 2 * Ck * L + B * N * 2 * L)
                    + B * N * 2 * P * L)
    return flops, nbytes


def read_work(B, N, P, Ck, Lm, Cv):
    """K2: the affinity and the value read. Bytes: qk, mk, mv (float32) and
    base_valid (one byte) in; mem_out and exp_aff out."""
    flops = B * (2.0 * P * Ck * (2 * N * Lm) + 2.0 * P * (2 * Lm) * Cv * N)
    nbytes = 4.0 * (B * P * Ck + B * N * 2 * Lm * (Ck + Cv) + B * N * P * Cv
                    + B * N * 2 * Lm * P) + B * N * 2 * Lm
    return flops, nbytes


def roofline_s(flops, nbytes, peaks=PEAKS["kernels"]):
    """max(operations / peak rate, bytes / peak bandwidth), in seconds."""
    return max(flops / (peaks["tflops"] * 1e12), nbytes / (peaks["hbm_tbps"] * 1e12))


def peak_flops(dtype: str) -> float:
    """The chip's peak operations per second for a tower dtype."""
    return PEAKS["towers"][dtype] * 1e12


def _count(fn) -> int:
    from vosbench.reference.lowp import CountOps

    ops = CountOps()
    with torch.no_grad():
        fn(ops)
    return ops.flops


def _weights(cfg):
    from vosbench.reference.model import param_shapes

    return {k: torch.empty(s, device="meta") for k, s in param_shapes(cfg).items()}


def step_flops(cfg, B, N, in_hw, out_hw):
    """Operations of the parts of one inference step at batch B, N objects:
    {"key": key encode, "value": value encode, "read": K2 + fusion +
    decode, "em": K1 + nu product, "em_loop": K1 alone}. A predicted frame costs key + read,
    a memorize value + em (frame 0: key + value + em)."""
    from vosbench.reference.model import BACKBONES, Network, topl_eff

    w = _weights(cfg)
    H, W = in_hw
    h, wd = -(-H // 16), -(-W // 16)
    P, Ck, Cv, L = h * wd, cfg["keydim"], cfg["valdim"], cfg["num_bases"]
    meta = dict(device="meta")
    frame = torch.empty((B, H, W, 3), **meta)

    def key(ops):
        net = Network(cfg, w, ops)
        _, _, _, s8, s4 = net.encode_key(frame)
        net.skips(s8, s4)

    def value(ops):
        f16 = BACKBONES[cfg["backbone"]][2][0]
        Network(cfg, w, ops).encode_value(frame, torch.empty((B, H, W, N + 1), **meta),
                                          torch.empty((B, f16, h, wd), **meta))

    def fuse_decode(ops):
        net = Network(cfg, w, ops)
        cin = 2 * Cv + 2 * topl_eff(cfg)
        feats = torch.empty((B * N, cin, h, wd), **meta)
        ctx = net.ops.conv(feats, w["swem_core.fusion_layer.layer_f.weight"], None, 1, 1)
        net.ops.conv(feats, w["swem_core.fusion_layer.layer_a.weight"], None, 1, 1)
        s8 = torch.empty((B, w["decoder.up_16_8.skip_conv.weight"].shape[0], 2 * h, 2 * wd),
                         **meta)
        s4 = torch.empty((B, w["decoder.up_8_4.skip_conv.weight"].shape[0], 4 * h, 4 * wd),
                         **meta)
        net.decode_objects(ctx.reshape((B, N) + ctx.shape[1:]), s8, s4,
                           torch.empty((B, N), **meta), out_hw)

    # the stem's frame channels run once per frame, not once per object
    stem = 2.0 * B * 64 * 3 * 49 * (-(-H // 2)) * (-(-W // 2)) * (N - 1)
    em_loop = em_loop_work(B, N, P, Ck, L, cfg["num_em_iters"])[0]
    return {"key": _count(key),
            "value": _count(value) - stem,
            "read": read_work(B, N, P, Ck, 2 * L, Cv)[0] + _count(fuse_decode),
            "em": em_loop + 2.0 * B * N * 2 * P * Cv * L,
            "em_loop": em_loop}


def video_flops(parts, T):
    """A video of T frames: frame 0 seeds the memory, frames 1..T-1 are
    predicted, frames 1..T-2 memorized."""
    return (parts["key"] + parts["value"] + parts["em"]) + (T - 1) * (parts["key"] + parts["read"]) \
        + max(T - 2, 0) * (parts["value"] + parts["em"])

