"""Image resizing with ``F.interpolate(align_corners=False)`` semantics.

Counterpart of ``swem_tpu/ops/resize.py``, which reproduces these torch
conventions in JAX:

* ``nearest``  — legacy torch: src = floor(dst * in/out), computed in float32
* ``bilinear`` — half-pixel centers, negative source coordinates clamped to 0
* ``bicubic``  — cubic convolution A=-0.75 with border replication

``resize`` keeps the JAX package's channel-last ``(..., H, W, C)`` signature;
``resize_nchw`` is the form the conv towers use. Nearest is an index gather
(it works for integer index maps too). A float32 input takes
``F.interpolate``, whose float32 arithmetic is the JAX package's formula; a
bfloat16 input is interpolated one axis at a time with its weights rounded
to bfloat16, as the JAX package does (``w.astype(x.dtype)``), where
``F.interpolate`` would compute in float32 and round once.

The index and weight taps are computed on the host once per shape, device
and dtype and kept on the device (``_taps``), so a resize copies nothing
from the host and runs inside a CUDA graph's capture (``serve.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from swem_tpu_torch.utils import kept

# the module's store of taps, by (method, in, out, dtype, device): they depend
# on shapes alone, so every caller shares them for the process's life
_kept: Dict[tuple, tuple] = {}


def _taps(key: tuple, device, make: Callable[[], tuple]) -> tuple:
    """``make()``'s host tensors moved to ``device``, kept per ``key`` and
    device (``utils.kept``)."""
    return kept(_kept, key + (device,), lambda: tuple(t.to(device) for t in make()))


def _nearest_indices(in_size: int, out_size: int, device) -> torch.Tensor:
    def make():
        scale = torch.tensor(in_size / out_size, dtype=torch.float32)
        idx = torch.floor(torch.arange(out_size, dtype=torch.float32) * scale).long()
        return (idx.clamp_(0, in_size - 1),)

    return _taps(("nearest", in_size, out_size), device, make)[0]


def _source_coords(in_size: int, out_size: int) -> torch.Tensor:
    """Half-pixel source coordinates, in float32 as torch computes them."""
    scale = torch.tensor(in_size, dtype=torch.float32) / torch.tensor(out_size,
                                                                      dtype=torch.float32)
    return (torch.arange(out_size, dtype=torch.float32) + 0.5) * scale - 0.5


def _linear_taps(in_size: int, out_size: int, dtype: torch.dtype):
    """Bilinear taps: indices i0, i1 and the weight w1 of i1, computed in
    float32 and rounded to ``dtype``, each (out,)."""
    src = _source_coords(in_size, out_size).clamp_min(0.0)
    i0 = src.floor().long().clamp_max(in_size - 1)
    return i0, (i0 + 1).clamp_max(in_size - 1), (src - i0.float()).to(dtype)


def _cubic_taps(in_size: int, out_size: int, dtype: torch.dtype, A: float = -0.75):
    """Bicubic taps: the four indices, then the four weights (computed in
    float32, rounded to ``dtype``), each (out,)."""
    src = _source_coords(in_size, out_size)
    i0 = src.floor()
    t = src - i0
    idx = (i0.long()[:, None] + torch.arange(-1, 3)).clamp(0, in_size - 1)
    ax = torch.stack([1.0 + t, t, 1.0 - t, 2.0 - t], -1)
    ax2, ax3 = ax * ax, ax * ax * ax
    w = torch.where(ax <= 1.0, (A + 2.0) * ax3 - (A + 3.0) * ax2 + 1.0,
                    torch.where(ax < 2.0, A * ax3 - 5.0 * A * ax2 + 8.0 * A * ax - 4.0 * A, 0.0))
    return tuple(idx.T) + tuple(w.to(dtype).T)


def _resize_axis(x: torch.Tensor, axis: int, out_size: int, method: str) -> torch.Tensor:
    """Interpolate one axis in x's dtype, weights rounded to it
    (``swem_tpu/ops/resize.py::_resize_axis_linear`` / ``_resize_axis_cubic``)."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    shape = [1] * x.ndim
    shape[axis] = out_size

    def take(i):
        return x.index_select(axis, i)

    key = (method, in_size, out_size, x.dtype)
    if method == "bilinear":
        i0, i1, w1 = _taps(key, x.device, lambda: _linear_taps(in_size, out_size, x.dtype))
        w = w1.reshape(shape)
        return take(i0) * (1.0 - w) + take(i1) * w
    taps = _taps(key, x.device, lambda: _cubic_taps(in_size, out_size, x.dtype))
    out = take(taps[0]) * taps[4].reshape(shape)
    for tap in range(1, 4):
        out = out + take(taps[tap]) * taps[4 + tap].reshape(shape)
    return out


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
    if x.dtype != torch.float32:
        return _resize_axis(_resize_axis(x, x.ndim - 2, h, method), x.ndim - 1, w, method)
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape((-1, 1) + tuple(x.shape[-2:])), size=(h, w),
                      mode=method, align_corners=False)
    return y.reshape(lead + (h, w))


def resize(x: torch.Tensor, size: Tuple[int, int], method: str = "bilinear") -> torch.Tensor:
    """Resize the (-3, -2) spatial axes of channel-last ``x`` (..., H, W, C)."""
    y = resize_nchw(x.movedim(-1, -3), size, method)
    return y.movedim(-3, -1)
