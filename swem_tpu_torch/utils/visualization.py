"""Visualization on host numpy arrays (the port's copy of
``swem_tpu/utils/visualization.py``): mask overlays for ``--visualize``,
JET heatmaps and the top-2 ratio uncertainty map. Images are HWC RGB in
[0, 1] or uint8. OpenCV is imported where an image is drawn or written."""

from __future__ import annotations

import numpy as np


def calc_uncertainty(score: np.ndarray) -> np.ndarray:
    """Top-2 score-ratio uncertainty: (B, H, W, C) softmax scores ->
    (B, H, W, 1), larger where less certain."""
    top2 = -np.sort(-score, axis=-1)[..., :2]
    ratio = top2[..., 0] / (top2[..., 1] + 1e-8)
    return np.exp(1.0 - ratio)[..., None]


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


def save_heatmap(path: str, img_rgb: np.ndarray, heat: np.ndarray, alpha: float = 0.3,
                 invert: bool = True) -> None:
    """A JET-colormap heat overlay written to ``path``: the heat (inverted
    by default, as the reference draws it) min-max normalized, resized
    bilinearly to the image and blended at ``alpha``."""
    import cv2

    img = _to_uint8_bgr(img_rgb)
    h, w = img.shape[:2]
    heat = heat.astype(np.float32)
    if invert:
        heat = 1.0 - heat
    heat = (heat - heat.min()) / (heat.max() - heat.min() + 1e-8)
    heat = cv2.resize((heat * 255).astype(np.uint8), (w, h), interpolation=cv2.INTER_LINEAR)
    heat_img = cv2.applyColorMap(heat, cv2.COLORMAP_JET)
    cv2.imwrite(path, cv2.addWeighted(heat_img, alpha, img, 1 - alpha, 0))
