"""Mask decoder (NCHW), counterpart of ``swem_tpu/models/decoder.py``.

compress (ResBlock 512) -> up 1/16->1/8 (skip f8) -> up 1/8->1/4 (skip f4)
-> 3x3 conv to 1 logit -> bilinear resize to the output size. The convs
compute in ``dtype``; the logit is promoted to float32 before the resize.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from swem_tpu_torch.models.layers import ResBlock, UpsampleBlock, conv3x3
from swem_tpu_torch.ops.resize import resize_nchw


class Decoder(nn.Module):
    def __init__(self, cin: int, f8: int, f4: int, mdim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compress = ResBlock(cin, 512, dtype)
        self.up_16_8 = UpsampleBlock(f8, 512, mdim, dtype)
        self.up_8_4 = UpsampleBlock(f4, mdim, mdim, dtype)
        self.pred = conv3x3(mdim, 1, dtype=dtype)

    def skip_feats(self, f8, f4):
        """Frame-only skip convolutions, computed once per frame."""
        return self.up_16_8.skip(f8), self.up_8_4.skip(f4)

    def decode_with_skips(self, f16, skip8, skip4, out_size: Tuple[int, int]):
        """f16: context (B,Cv,h16,w16); skips from ``skip_feats`` -> (B,1,Ho,Wo)."""
        x = self.compress(f16)
        x = self.up_16_8.merge(skip8, x)
        x = self.up_8_4.merge(skip4, x)
        x = self.pred(F.relu(x))
        # the last resize, sigmoid and aggregation run in float32
        return resize_nchw(x.float(), out_size, "bilinear")

    def forward(self, f16, f8, f4, out_size: Tuple[int, int]):
        skip8, skip4 = self.skip_feats(f8, f4)
        return self.decode_with_skips(f16, skip8, skip4, out_size)
