"""DAVIS evaluation videos (the port's copy of ``swem_tpu/data/davis_test.py``).

Host-side numpy: whole videos as uint8 frames (T, H, W, 3) at the original
resolution plus the frame-0 one-hot mask padded to a static slot budget.
OpenCV and Pillow are imported where a file is decoded.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from glob import glob
from typing import List

import numpy as np

from swem_tpu_torch.data.palette import load_label_mask


def load_image(path: str) -> np.ndarray:
    """A JPEG frame as uint8 RGB (H, W, 3): the /255 and any resize run on
    the device."""
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"image {path} not found or not decodable")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def to_onehot(label: np.ndarray, n_channels: int) -> np.ndarray:
    """(H, W) int -> (H, W, C) float one-hot; ids >= C are dropped to bg."""
    clipped = np.where(label < n_channels, label, 0)
    oh = np.eye(n_channels, dtype=np.float32)[clipped]
    return oh


@dataclass
class DavisVideo:
    name: str
    frames: np.ndarray  # (T, H, W, 3) uint8 at the original resolution
    init_mask: np.ndarray  # (Ho, Wo, n_slots+1) one-hot float32
    n_objs: int
    frame_names: List[str]


class DavisTestSet:
    """DAVIS val/test-dev videos listed in ``ImageSets/<img_set>``.

    ``single_obj`` collapses all ids to 1 (DAVIS-2016); ``n_slots`` is the
    static object budget the masks are padded to.
    """

    def __init__(self, root: str, img_set: str = "2017/val.txt", single_obj: bool = False,
                 n_slots: int = 8):
        self.root = root
        self.single_obj = single_obj
        self.n_slots = n_slots
        with open(os.path.join(root, "ImageSets", img_set)) as f:
            self.videos = [ln.strip() for ln in f if ln.strip()]

    def __len__(self) -> int:
        return len(self.videos)

    def _first_label(self, name: str) -> np.ndarray:
        mask0 = sorted(glob(os.path.join(self.root, "Annotations", "480p", name, "*.png")))[0]
        label0 = load_label_mask(mask0)
        return (label0 > 0).astype(np.uint8) if self.single_obj else label0

    def _frame_paths(self, name: str) -> List[str]:
        return sorted(glob(os.path.join(self.root, "JPEGImages", "480p", name, "*.jpg")))

    def __getitem__(self, idx: int) -> DavisVideo:
        name = self.videos[idx]
        img_list = self._frame_paths(name)
        label0 = self._first_label(name)
        return DavisVideo(
            name=name, frames=np.stack([load_image(p) for p in img_list]),
            init_mask=to_onehot(label0, self.n_slots + 1), n_objs=int(label0.max()),
            frame_names=[os.path.splitext(os.path.basename(p))[0] for p in img_list],
        )

    def peek(self, idx: int):
        """(name, out_size, n_objs, n_frames) without decoding any frame: the
        first annotation PNG and the frame listing only, enough for the
        batched mode to group videos and sort them by length."""
        name = self.videos[idx]
        label0 = self._first_label(name)
        return name, label0.shape, int(label0.max()), len(self._frame_paths(name))
