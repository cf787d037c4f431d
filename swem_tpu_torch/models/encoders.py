"""Key / value encoders and the key projection, counterparts of
``swem_tpu/models/encoders.py``.

Frames enter channel-last ``(B, H, W, 3)`` as in the JAX package; every
feature map these modules return is NCHW, in the module's compute ``dtype``.
"""

from __future__ import annotations

import torch
from torch import nn

from swem_tpu_torch.models.layers import FeatureFusionBlock, FrozenBatchNorm, conv3x3
from swem_tpu_torch.models.resnet import (
    BACKBONE_FEATURES,
    StemConv,
    make_stages,
    run_stages,
    stem_rest,
)
from swem_tpu_torch.utils import kept

# ImageNet normalization; float32 constants, as the reference stores them
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_constants(device: torch.device, dtype: torch.dtype):
    """The normalization's (mean, std) on ``device``, rounded to ``dtype``."""
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device).to(dtype),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device).to(dtype))


def normalize_image(frame: torch.Tensor, dtype: torch.dtype, store: dict) -> torch.Tensor:
    """(..., H, W, 3) RGB in [0, 1] -> ImageNet-normalized (..., 3, H, W) in
    ``dtype``, the float32 constants rounded to it. The constants are made
    once per device and dtype and kept in ``store``, a dict of the caller's
    (``utils.kept``)."""
    mean, std = kept(store, (frame.device, dtype),
                     lambda: imagenet_constants(frame.device, dtype))
    return ((frame.to(dtype) - mean) / std).movedim(-1, -3)


class KeyEncoder(nn.Module):
    """ResNet-50/18 trunk producing (f16, f8, f4); no conv biases."""

    def __init__(self, backbone: str = "resnet50", dtype: torch.dtype = torch.float32):
        super().__init__()
        if backbone not in BACKBONE_FEATURES:
            raise KeyError(f"backbone {backbone} not supported")
        self.backbone = backbone
        self.compute_dtype = dtype
        self.conv1 = StemConv(3, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(64)
        self.res2, self.layer2, self.layer3 = make_stages(backbone, bias=False, dtype=dtype)
        self._imagenet = {}

    def forward(self, frame):
        x = stem_rest(self.bn1, self.conv1(normalize_image(frame, self.compute_dtype,
                                                           self._imagenet)))
        return run_stages(x, (self.res2, self.layer2, self.layer3))


class ValueEncoder(nn.Module):
    """Modified ResNet-18 value trunk + feature fusion with the key f16.

    conv1 takes the frame plus the object's fg mask and (unless
    ``single_object``) the "other objects" mask: 4 or 5 input channels.
    """

    def __init__(self, key_f16: int, valdim: int = 512, single_object: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.single_object = single_object
        self.compute_dtype = dtype
        self.conv1 = StemConv(4 if single_object else 5, bias=True, dtype=dtype)
        self.bn1 = FrozenBatchNorm(64)
        self.layer1, self.layer2, self.layer3 = make_stages("resnet18", bias=True, dtype=dtype)
        self.fuser = FeatureFusionBlock(BACKBONE_FEATURES["resnet18"][0] + key_f16, valdim, dtype)
        self._imagenet = {}

    def frame_stem(self, frame):
        """Frame slice of the stem conv: (B,H,W,3) -> (B,64,H/2,W/2)."""
        return self.conv1.frame_part(normalize_image(frame, self.compute_dtype, self._imagenet))

    def forward(self, frame, key_f16, mask_fg, mask_others=None, frame_stem=None):
        """frame (B,H,W,3); key_f16 (B,Cf,h16,w16); masks (B,1,H,W).

        ``frame_stem``: optionally the precomputed ``frame_stem(frame)``
        (``frame`` is then unused).
        """
        dt = self.compute_dtype
        masks = mask_fg.to(dt) if self.single_object else torch.cat(
            [mask_fg.to(dt), mask_others.to(dt)], dim=1)
        if frame_stem is None:
            conv1_out = self.conv1(torch.cat([normalize_image(frame, dt, self._imagenet), masks],
                                             dim=1))
        else:
            conv1_out = frame_stem + self.conv1.mask_part(masks)
        f16, _, _ = run_stages(stem_rest(self.bn1, conv1_out),
                               (self.layer1, self.layer2, self.layer3))
        return self.fuser(f16, key_f16.to(dt))


class KeyProjection(nn.Module):
    """3x3 conv f16 -> keydim."""

    def __init__(self, cin: int, keydim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.key_proj = conv3x3(cin, keydim, dtype=dtype)

    def forward(self, x):
        return self.key_proj(x)
