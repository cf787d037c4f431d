"""Palette-indexed PNG masks (the port's copy of ``swem_tpu/data/palette.py``).

Both palettes are generated: DAVIS's is the PASCAL-VOC bit-reversal
colormap; YouTube-VOS's is the benchmark's 11 colours followed by the
grayscale ramp. Pillow is imported where a PNG is read or written.
"""

from __future__ import annotations

from typing import List

import numpy as np

# YouTube-VOS benchmark colours (indices 0..10); the rest of the 256-entry
# palette is the grayscale ramp i -> (i, i, i)
_YTVOS_HEAD = [
    (0, 0, 0), (236, 95, 103), (249, 145, 87), (250, 200, 99), (153, 199, 148),
    (98, 179, 178), (102, 153, 204), (197, 148, 197), (171, 121, 103), (255, 255, 255),
    (101, 115, 126),
]


def voc_colormap() -> np.ndarray:
    """256x3 PASCAL-VOC colormap (bit-reversal construction)."""
    cmap = np.zeros((256, 3), np.uint8)
    for i in range(256):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def davis_palette() -> List[int]:
    return voc_colormap().flatten().tolist()


def ytvos_palette() -> List[int]:
    cmap = np.arange(256, dtype=np.uint8)[:, None].repeat(3, axis=1)
    cmap[: len(_YTVOS_HEAD)] = np.asarray(_YTVOS_HEAD, np.uint8)
    return cmap.flatten().tolist()


def save_seg_mask(mask: np.ndarray, path: str, palette: List[int]) -> None:
    """Save an integer label map as a palette-indexed PNG."""
    from PIL import Image

    img = Image.fromarray(mask.astype(np.uint8), mode="P")
    img.putpalette(palette)
    img.save(path)


def load_label_mask(path: str) -> np.ndarray:
    """Read a palette PNG back to its integer label map."""
    from PIL import Image

    with Image.open(path) as img:
        return np.array(img, dtype=np.uint8)
