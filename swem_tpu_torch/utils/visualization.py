"""Mask overlays for ``--visualize`` (the port's copy of
``swem_tpu/utils/visualization.py::save_overlay``). OpenCV is imported
where an image is drawn or written."""

from __future__ import annotations

import numpy as np


def _to_uint8_bgr(img: np.ndarray) -> np.ndarray:
    import cv2

    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return cv2.cvtColor(img, cv2.COLOR_RGB2BGR)


def binary_dilation3(mask: np.ndarray) -> np.ndarray:
    """4-connected binary dilation (a 3x3 cross)."""
    import cv2

    k = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], np.uint8)
    return cv2.dilate(mask.astype(np.uint8), k).astype(bool)


def add_overlay(img_bgr: np.ndarray, mask: np.ndarray, palette, alpha: float = 0.4
                ) -> np.ndarray:
    """Colour overlay and a black contour per object id."""
    colors = np.reshape(np.asarray(palette), (-1, 3)).astype(np.float32)
    out = img_bgr.copy()
    ones = np.ones(img_bgr.shape, np.float32) * (1 - alpha)
    for i in np.unique(mask)[1:]:
        canvas = img_bgr * alpha + ones * colors[i][::-1]
        sel = mask == i
        out[sel] = canvas[sel]
        out[binary_dilation3(sel) ^ sel] = 0
    return out


def save_overlay(img_rgb: np.ndarray, mask: np.ndarray, path: str, palette,
                 alpha: float = 0.4) -> None:
    import cv2

    cv2.imwrite(path, add_overlay(_to_uint8_bgr(img_rgb), mask, palette, alpha))
