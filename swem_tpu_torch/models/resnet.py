"""ResNet trunks through layer3 (NCHW), counterparts of ``swem_tpu/models/resnet.py``.

Blocks follow torchvision's attribute names (``conv1``/``bn1``/...,
``downsample.0``/``downsample.1``). The key trunk has no conv biases; the
value trunk (mod_resnet) has a bias on every conv. Every conv computes in
the trunk's ``dtype``; the batch norms fold in float32 and cast to it. The
cast kernels and the folds are kept across calls (``layers.prepared``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from swem_tpu_torch.models.layers import FrozenBatchNorm, cast_params, conv1x1, conv3x3

BACKBONE_FEATURES = {
    # (f16, f8, f4) channel counts
    "resnet50": (1024, 512, 256),
    "resnet18": (256, 128, 64),
}
BACKBONE_LAYERS = {"resnet50": ("bottleneck", (3, 4, 6)), "resnet18": ("basic", (2, 2, 2))}


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 bias: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = conv3x3(inplanes, planes, stride, bias=bias, dtype=dtype)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = conv3x3(planes, planes, bias=bias, dtype=dtype)
        self.bn2 = FrozenBatchNorm(planes)
        self.downsample = (
            nn.Sequential(conv1x1(inplanes, planes, stride, bias=bias, dtype=dtype),
                          FrozenBatchNorm(planes))
            if downsample else None
        )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 bias: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = conv1x1(inplanes, planes, bias=bias, dtype=dtype)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = conv3x3(planes, planes, stride, bias=bias, dtype=dtype)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = conv1x1(planes, out_ch, bias=bias, dtype=dtype)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample = (
            nn.Sequential(conv1x1(inplanes, out_ch, stride, bias=bias, dtype=dtype),
                          FrozenBatchNorm(out_ch))
            if downsample else None
        )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class StemConv(nn.Conv2d):
    """7x7/2 stem conv that can also apply its input-channel slices apart.

    ``frame_part`` (first 3 channels + bias) depends only on the frame, so
    the engine computes it once per frame; ``mask_part`` (remaining
    channels, no bias) is the only stem work left per object. The split is
    exact up to one partial-sum reordering. Input, kernel and bias are cast
    to ``dtype``, and the bias is added after the product, as in the JAX
    package's ``StemConv._conv``. Each part keeps its cast kernel slice and
    bias across calls.
    """

    PARTS = {"whole": None, "frame": slice(None, 3), "mask": slice(3, None)}

    def __init__(self, in_channels: int, bias: bool, dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, 64, 7, stride=2, padding=3, bias=bias)
        self.compute_dtype = dtype
        self._prepared = {}

    def _conv(self, x, part: str, with_bias: bool):
        dt = self.compute_dtype
        weight, bias = cast_params(self._prepared, part, dt, self.weight,
                                   self.bias if with_bias else None, self.PARTS[part])
        y = F.conv2d(x.to(dt), weight, None, stride=2, padding=3)
        if bias is not None:
            y = y + bias[:, None, None]
        return y

    def forward(self, x):
        return self._conv(x, "whole", True)

    def frame_part(self, frame):
        return self._conv(frame, "frame", True)

    def mask_part(self, masks):
        return self._conv(masks, "mask", False)


def make_stages(backbone: str, bias: bool, dtype: torch.dtype = torch.float32
                ) -> List[nn.Sequential]:
    """The three residual stages (layer1..layer3) of a trunk."""
    kind, layers = BACKBONE_LAYERS[backbone]
    block = BasicBlock if kind == "basic" else Bottleneck
    stages = []
    inplanes, planes = 64, 64
    for i, n_blocks in enumerate(layers):
        stride = 1 if i == 0 else 2
        blocks = []
        for b in range(n_blocks):
            first = b == 0
            down = first and (stride != 1 or inplanes != planes * block.expansion)
            blocks.append(block(inplanes, planes, stride if first else 1, down, bias, dtype))
            inplanes = planes * block.expansion
        stages.append(nn.Sequential(*blocks))
        planes *= 2
    return stages


def stem_rest(bn1: FrozenBatchNorm, conv1_out: torch.Tensor) -> torch.Tensor:
    """bn -> relu -> 3x3/2 max pool (padding 1) on a conv1 output."""
    return F.max_pool2d(F.relu(bn1(conv1_out)), 3, stride=2, padding=1)


def run_stages(x: torch.Tensor, stages: Sequence[nn.Module]):
    """Residual stages -> (f16, f8, f4)."""
    f4 = stages[0](x)
    f8 = stages[1](f4)
    f16 = stages[2](f8)
    return f16, f8, f4
