"""The arithmetic variants of the reference: the precision scope, the
lower-precision control and the FLOP counter.

- ``precision("float32")``: full float32, TF32 off (the reference itself);
  ``precision("tf32")``: the same code with TF32 on, the control of a
  configuration that states float32.
- ``Fp8Ops(dt)``: every convolution and linear layer takes float8 (e4m3)
  inputs and weights, each scaled per tensor to the format's range,
  accumulates in float32 and hands its result on in ``dt``: the control
  of a configuration whose conv towers are bfloat16.
- ``CountOps``: on ``meta`` tensors, counts the operations of every
  convolution and linear layer (a multiply-add is two).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from vosbench.reference.model import Ops

FP8_MAX = 448.0  # largest finite float8_e4m3fn


@contextlib.contextmanager
def precision(mode: str):
    """TF32 off ("float32") or on ("tf32") for the block, restored after."""
    if mode not in ("float32", "tf32"):
        raise ValueError(f"precision: {mode!r}")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    on = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def fp8(t):
    """Round ``t`` to float8 e4m3 under a per-tensor scale, back in float32."""
    s = FP8_MAX / t.abs().amax().clamp_min(1e-30)
    return (t * s).to(torch.float8_e4m3fn).float() / s


class Fp8Ops(Ops):
    """float8 operands, float32 products and bias, the result in ``dt``."""

    def conv(self, x, w, b=None, stride=1, padding=0):
        b = None if b is None else b.float()
        return F.conv2d(fp8(x.float()), fp8(w.float()), b, stride, padding).to(self.dt)

    def linear(self, x, w, b):
        return F.linear(fp8(x.float()), fp8(w.float()), b.float()).to(self.dt)


class CountOps(Ops):
    """Counts 2 x multiply-adds of convolutions and linear layers."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def conv(self, x, w, b=None, stride=1, padding=0):
        y = F.conv2d(x, w, b, stride, padding)
        self.flops += 2 * y.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return y

    def linear(self, x, w, b):
        y = F.linear(x, w, b)
        self.flops += 2 * y.numel() * w.shape[1]
        return y
