"""DAVIS J&F metrics in numpy (the port's copy of ``swem_tpu/eval/metrics.py``).

The math of the official davis2017 evaluation package:

* ``jaccard``    region similarity J with void handling (J = 1 on an empty union)
* ``boundary_f`` contour F-measure: 1-pixel boundary maps dilated by a disk
                 of radius ceil(0.008 * image diagonal)
* ``statistics`` (mean, recall@0.5, decay over 4 temporal bins)

OpenCV is imported where a boundary is dilated.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np


def disk(radius: int) -> np.ndarray:
    """Circular structuring element (``skimage.morphology.disk``)."""
    r = int(radius)
    y, x = np.mgrid[-r: r + 1, -r: r + 1]
    return (x * x + y * y <= r * r).astype(np.uint8)


def jaccard(annotation: np.ndarray, segmentation: np.ndarray,
            void_pixels: Optional[np.ndarray] = None) -> np.ndarray:
    """Region similarity J over the trailing two axes."""
    if annotation.shape != segmentation.shape:
        raise ValueError(f"jaccard: shapes {annotation.shape} and {segmentation.shape} differ")
    ann = annotation.astype(bool)
    seg = segmentation.astype(bool)
    valid = np.ones_like(seg) if void_pixels is None else ~void_pixels.astype(bool)
    inters = np.sum(seg & ann & valid, axis=(-2, -1))
    union = np.sum((seg | ann) & valid, axis=(-2, -1))
    with np.errstate(divide="ignore", invalid="ignore"):
        j = inters / union
    empty = np.isclose(union, 0)
    if j.ndim == 0:
        return np.asarray(1.0) if empty else j
    j[empty] = 1.0
    return j


def _boundary_map(seg: np.ndarray) -> np.ndarray:
    """1-pixel-wide boundary map, offset half a pixel toward the origin."""
    seg = seg.astype(bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def boundary_f(foreground: np.ndarray, gt: np.ndarray,
               void_pixels: Optional[np.ndarray] = None, bound_th: float = 0.008) -> float:
    """Contour F-measure of one frame."""
    import cv2

    if void_pixels is not None:
        keep = ~void_pixels.astype(bool)
        foreground = foreground * keep
        gt = gt * keep
    radius = bound_th if bound_th >= 1 else math.ceil(bound_th * np.linalg.norm(foreground.shape))
    fg_b = _boundary_map(foreground)
    gt_b = _boundary_map(gt)
    kernel = disk(radius)
    fg_dil = cv2.dilate(fg_b.astype(np.uint8), kernel)
    gt_dil = cv2.dilate(gt_b.astype(np.uint8), kernel)

    n_fg = fg_b.sum()
    n_gt = gt_b.sum()
    if n_fg == 0 and n_gt > 0:
        return 0.0  # precision 1, recall 0
    if n_fg > 0 and n_gt == 0:
        return 0.0  # precision 0, recall 1
    if n_fg == 0 and n_gt == 0:
        return 1.0
    precision = float((fg_b & (gt_dil > 0)).sum()) / n_fg
    recall = float((gt_b & (fg_dil > 0)).sum()) / n_gt
    if precision + recall == 0:
        return 0.0
    return 2.0 * precision * recall / (precision + recall)


def boundary_f_frames(annotation: np.ndarray, segmentation: np.ndarray,
                      void_pixels: Optional[np.ndarray] = None,
                      bound_th: float = 0.008) -> np.ndarray:
    """Per-frame F over a (T, H, W) stack."""
    if annotation.ndim == 2:
        return np.asarray(boundary_f(segmentation, annotation, void_pixels, bound_th))
    out = np.zeros(annotation.shape[0])
    for t in range(annotation.shape[0]):
        void_t = None if void_pixels is None else void_pixels[t]
        out[t] = boundary_f(segmentation[t], annotation[t], void_t, bound_th)
    return out


def statistics(per_frame: np.ndarray) -> Tuple[float, float, float]:
    """(mean, recall@0.5, decay) of a per-frame metric series."""
    with np.errstate(invalid="ignore"):
        M = np.nanmean(per_frame)
        O = np.nanmean(per_frame > 0.5)  # noqa: E741
    n = len(per_frame)
    ids = (np.round(np.linspace(1, n, 5) + 1e-10) - 1).astype(int)
    bins = [per_frame[ids[i]: ids[i + 1] + 1] for i in range(4)]
    with np.errstate(invalid="ignore"):
        D = np.nanmean(bins[0]) - np.nanmean(bins[3])
    return float(M), float(O), float(D)
