"""Image resizing with ``F.interpolate(align_corners=False)`` semantics.

Counterpart of ``swem_tpu/ops/resize.py``, which reproduces these torch
conventions in JAX:

* ``nearest``  — legacy torch: src = floor(dst * in/out), computed in float32
* ``bilinear`` — half-pixel centers, negative source coordinates clamped to 0
* ``bicubic``  — cubic convolution A=-0.75 with border replication

``resize`` keeps the JAX package's channel-last ``(..., H, W, C)`` signature;
``resize_nchw`` is the form the conv towers use. Nearest is an index gather
(it works for integer index maps too); the others call ``F.interpolate``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _nearest_indices(in_size: int, out_size: int, device) -> torch.Tensor:
    scale = torch.tensor(in_size / out_size, dtype=torch.float32)
    idx = torch.floor(torch.arange(out_size, dtype=torch.float32) * scale).long()
    return idx.clamp_(0, in_size - 1).to(device)


def resize_nchw(x: torch.Tensor, size: Tuple[int, int], method: str = "bilinear") -> torch.Tensor:
    """Resize the last two (H, W) axes of ``x`` (..., H, W) to ``size``."""
    h, w = size
    if method == "nearest":
        x = x.index_select(-2, _nearest_indices(x.shape[-2], h, x.device))
        return x.index_select(-1, _nearest_indices(x.shape[-1], w, x.device))
    if method not in ("bilinear", "bicubic"):
        raise ValueError(f"unknown resize method: {method}")
    if tuple(x.shape[-2:]) == (h, w):
        return x
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape((-1, 1) + tuple(x.shape[-2:])), size=(h, w),
                      mode=method, align_corners=False)
    return y.reshape(lead + (h, w))


def resize(x: torch.Tensor, size: Tuple[int, int], method: str = "bilinear") -> torch.Tensor:
    """Resize the (-3, -2) spatial axes of channel-last ``x`` (..., H, W, C)."""
    y = resize_nchw(x.movedim(-1, -3), size, method)
    return y.movedim(-3, -1)
