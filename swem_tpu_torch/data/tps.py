"""Thin-plate-spline warp augmentation (numpy + cv2): the port's copy of
``swem_tpu/data/tps.py``.

Re-design of the reference implementation's
datasets/data_transform/thinplatespline/
(batch.py:8-133, utils.py:13-33) and the JointRandomTPS wrapper
(vos_transforms.py:13-74): a 4x4 control grid in [-1, 1]^2 whose interior
points are jittered by +-margin_rate/2, a (k+3)x(k+3) linear solve for the
spline coefficients, and a dense H x W sampling grid applied with bilinear
(image) / nearest (mask) interpolation — cv2.remap standing in for
torch grid_sample (align_corners=False, zero padding).

Fixes the reference's removed ``torch.solve`` call (batch.py:86 — modern
torch breaks) by construction.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import cv2
import numpy as np


def _grid_points_2d(nx: int, ny: int) -> np.ndarray:
    """(nx*ny, 2) control points (x, y) in [-1, 1] (utils.py:13-22)."""
    ys = np.linspace(-1.0, 1.0, ny)
    xs = np.linspace(-1.0, 1.0, nx)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    return np.stack([xx, yy], axis=-1).reshape(-1, 2)


def _noisy_grid(rng: np.random.Generator, nx: int, ny: int, noise: float) -> np.ndarray:
    """Uniform grid with jittered interior points (utils.py:25-33)."""
    grid = _grid_points_2d(nx, ny).reshape(ny, nx, 2)
    out = grid.copy()
    out[1 : ny - 1, 1 : nx - 1] += (rng.random((ny - 2, nx - 2, 2)) - 0.5) * noise
    return out.reshape(-1, 2)


def _k_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """U(r) = r^2 log(r^2 + eps) radial kernel (batch.py:8-26)."""
    d2 = np.sum((a[:, None, :] - b[None, :, :]) ** 2, axis=-1)
    return d2 * np.log(d2 + 1e-9)


@lru_cache(maxsize=8)
def _eval_basis(size: Tuple[int, int], anchors: Tuple[int, int]):
    """Per-(size, anchors) dense evaluation basis [P_eval | K(pts, X)].

    The control grid X is fixed; only the jittered targets Y vary per
    sample, so the expensive dense radial kernel is a constant — caching it
    cuts the per-sample TPS cost from ~450ms to a couple of matmuls.
    """
    h, w = size
    ny, nx = anchors
    X = _grid_points_2d(nx, ny)
    gx = np.linspace(-1.0, 1.0, w)
    gy = np.linspace(-1.0, 1.0, h)
    gyy, gxx = np.meshgrid(gy, gx, indexing="ij")
    pts = np.stack([gxx, gyy], axis=-1).reshape(-1, 2)
    P_eval = np.concatenate([np.ones((pts.shape[0], 1)), pts], axis=1)
    basis = np.concatenate([P_eval, _k_matrix(pts, X)], axis=1)  # (HW, 3+k)
    return basis.astype(np.float32)


def _tps_coeffs(
    rng: np.random.Generator,
    margin_rate: float,
    anchors: Tuple[int, int],
) -> np.ndarray:
    """Solve one sampled warp's spline coefficients, (3+k, 2) float32.

    The spline interpolates the uniform control grid X to the jittered grid
    Y (batch.py:69-89)."""
    ny, nx = anchors
    X = _grid_points_2d(nx, ny)  # (k, 2)
    Y = _noisy_grid(rng, nx, ny, margin_rate)
    k = X.shape[0]
    P = np.concatenate([np.ones((k, 1)), X], axis=1)  # (k, 3)
    L = np.zeros((k + 3, k + 3))
    L[:k, :k] = _k_matrix(X, X)
    L[:k, k:] = P
    L[k:, :k] = P.T
    Z = np.zeros((k + 3, 2))
    Z[:k] = Y
    Q = np.linalg.solve(L, Z)
    W_, A = Q[:k], Q[k:]
    return np.concatenate([A, W_], axis=0).astype(np.float32)  # (3+k, 2)


def tps_sample_grid(
    rng: np.random.Generator,
    size: Tuple[int, int],
    margin_rate: float = 0.25,
    anchors: Tuple[int, int] = (4, 4),
) -> np.ndarray:
    """Sample a TPS warp and return the (H, W, 2) source grid in [-1, 1].

    Evaluating the spline on the dense output lattice yields per-output-
    pixel source coordinates (grid_sample convention); the dense basis is
    cached per (size, anchors) (batch.py:115-133).
    """
    h, w = size
    grid = _eval_basis((h, w), anchors) @ _tps_coeffs(rng, margin_rate, anchors)
    return grid.reshape(h, w, 2)


def tps_sample_maps(
    rng: np.random.Generator,
    size: Tuple[int, int],
    margin_rate: float = 0.25,
    anchors: Tuple[int, int] = (4, 4),
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample a warp and return cv2.remap pixel maps directly.

    The [-1,1] -> pixel affine of grid_to_maps folds into the spline
    coefficients (the basis carries a ones column, so the offset lands on
    the constant term) — same maps as grid_to_maps(tps_sample_grid(...))
    without two extra full-frame passes.
    """
    h, w = size
    coeffs = _tps_coeffs(rng, margin_rate, anchors).copy()
    scale = np.array([w / 2.0, h / 2.0], np.float32)
    coeffs *= scale
    coeffs[0] += scale - 0.5
    maps = _eval_basis((h, w), anchors) @ coeffs
    return maps[:, 0].reshape(h, w), maps[:, 1].reshape(h, w)


def grid_to_maps(grid: np.ndarray, size: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """[-1,1] sampling grid -> cv2.remap pixel maps (align_corners=False)."""
    h, w = size
    map_x = ((grid[..., 0] + 1.0) * w - 1.0) / 2.0
    map_y = ((grid[..., 1] + 1.0) * h - 1.0) / 2.0
    return map_x.astype(np.float32), map_y.astype(np.float32)


def warp_image(img: np.ndarray, grid: np.ndarray, mode: str = "bilinear") -> np.ndarray:
    """Warp (H, W, C) or (H, W) array by a [-1,1] source grid, zero padding."""
    map_x, map_y = grid_to_maps(grid, img.shape[:2])
    interp = cv2.INTER_LINEAR if mode == "bilinear" else cv2.INTER_NEAREST
    return cv2.remap(img, map_x, map_y, interp,
                     borderMode=cv2.BORDER_CONSTANT, borderValue=0)


class JointRandomTPS:
    """Per-frame TPS applied jointly to image and mask (vos_transforms.py:13-74).

    ``p`` is the per-frame application probability (1.0 in both training
    datasets: video_dataset.py:191, static_dataset.py:239).
    """

    def __init__(self, margin_rate: float = 0.25,
                 anchors: Tuple[int, int] = (4, 4), p: float = 1.0):
        self.margin_rate = margin_rate
        self.anchors = anchors
        self.p = p

    def __call__(self, rng: np.random.Generator, img: np.ndarray, mask: np.ndarray):
        """img: (H, W, 3) float; mask: (H, W) int/float. Returns warped pair."""
        if rng.random() >= self.p:
            return img, mask
        map_x, map_y = tps_sample_maps(rng, img.shape[:2],
                                       self.margin_rate, self.anchors)
        wimg = cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        wmask = cv2.remap(mask, map_x, map_y, cv2.INTER_NEAREST,
                          borderMode=cv2.BORDER_CONSTANT, borderValue=0)
        return wimg, wmask
