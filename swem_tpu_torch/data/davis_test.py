"""Label maps to one-hot masks (the port's copy of the part of
``swem_tpu/data/davis_test.py`` that the streaming session needs)."""

from __future__ import annotations

import numpy as np


def to_onehot(label: np.ndarray, n_channels: int) -> np.ndarray:
    """(H, W) int -> (H, W, C) float one-hot; ids >= C are dropped to bg."""
    clipped = np.where(label < n_channels, label, 0)
    oh = np.eye(n_channels, dtype=np.float32)[clipped]
    return oh
