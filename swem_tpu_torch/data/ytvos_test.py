"""YouTube-VOS evaluation videos (the port's copy of ``swem_tpu/data/ytvos_test.py``).

Parses the set's ``meta.json`` (or the ``dataset_file`` given), drops the
frames before the first object appears, derives the /16-divisible
short-side inference size and builds the
*injection* masks of objects that appear mid-video. Each object gets a
fixed slot, in order of first appearance, in a static (n_slots+1)-channel
layout; ``slot_to_orig`` maps the slots back to the annotation ids when the
PNGs are saved. Frames stay uint8 at their native resolution: the /255 and
the bicubic resize to ``in_size`` run on the device.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from glob import glob
from typing import Dict, List

import numpy as np

from swem_tpu_torch.data.davis_test import load_image
from swem_tpu_torch.data.palette import load_label_mask


def suit_size(size: int, ratio: int = 16) -> int:
    """Nearest /16-divisible size."""
    r = size % ratio
    size -= r
    if r > 7:
        size += 16
    return size


@dataclass
class YTVOSVideo:
    name: str
    frames: np.ndarray  # (T, H, W, 3) uint8 at the native resolution
    in_size: tuple  # (h, w) /16-divisible inference size (resized on the device)
    init_mask: np.ndarray  # (Ho, Wo, n_slots+1) frame-0 one-hot at the original size
    init_slots: list  # slots annotated at frame 0 (even if their mask is empty)
    first_label: np.ndarray  # (Ho, Wo) original-id label of frame 0
    # frame index -> dict(mask=(Ho,Wo,n_slots+1) one-hot, fg only in the new
    # slots, new_slots=list[int])
    injections: Dict[int, dict] = field(default_factory=dict)
    slot_to_orig: List[int] = field(default_factory=list)  # slot n -> original id
    frame_names: List[str] = field(default_factory=list)
    names_to_save: List[str] = field(default_factory=list)
    original_size: tuple = (0, 0)
    n_objs: int = 0


class YTVOSTestSet:
    def __init__(self, root: str, dataset_file: str = "meta.json", short_size: int = 480,
                 n_slots: int = 12):
        self.root = root
        self.n_slots = n_slots
        self.ssize = suit_size(short_size)
        with open(os.path.join(root, dataset_file)) as f:
            self.meta = json.load(f)["videos"]
        self.videos = list(self.meta)

    def __len__(self) -> int:
        return len(self.videos)

    def _infer_size(self, h: int, w: int):
        """Short side -> ssize, both sides /16-divisible."""
        if h < w:
            if h < self.ssize:
                return suit_size(h), suit_size(w)
            out_h = self.ssize
            return out_h, suit_size(suit_size(int(w * out_h / h)))
        if w < self.ssize:
            return suit_size(h), suit_size(w)
        out_w = self.ssize
        return suit_size(int(h * out_w / w)), out_w

    def _listing(self, name: str):
        """(frame paths, frame names) from the first object's appearance on."""
        img_list = sorted(glob(os.path.join(self.root, "JPEGImages", name, "*.jpg")))
        frame_names = [os.path.splitext(os.path.basename(p))[0] for p in img_list]
        first = min(frame_names.index(g["frames"][0]) for g in self.meta[name]["objects"].values())
        return img_list[first:], frame_names[first:]

    def __getitem__(self, idx: int) -> YTVOSVideo:
        name = self.videos[idx]
        mask_dir = os.path.join(self.root, "Annotations", name)
        img_list, frame_names = self._listing(name)
        objs = self.meta[name]["objects"]

        # objects grouped by appearance frame; slots assigned in that order
        ann_frames: Dict[int, dict] = {}
        for obj_id_str, g in objs.items():
            fidx = frame_names.index(g["frames"][0])
            entry = ann_frames.setdefault(
                fidx, {"ids": [], "path": os.path.join(mask_dir, g["frames"][0] + ".png")})
            entry["ids"].append(int(obj_id_str))
        ann_frames = dict(sorted(ann_frames.items()))

        slot_to_orig: List[int] = []
        injections: Dict[int, dict] = {}
        h0 = w0 = None
        for fidx, entry in ann_frames.items():
            label = load_label_mask(entry["path"])
            h0, w0 = label.shape
            mask = np.zeros((h0, w0, self.n_slots + 1), np.float32)
            mask[..., 0] = (label == 0).astype(np.float32)
            new_slots = []
            for obj_id in entry["ids"]:
                slot = len(slot_to_orig)
                if slot >= self.n_slots:
                    print(f"WARNING: {name}: object {obj_id} exceeds the "
                          f"{self.n_slots}-slot budget and is skipped")
                    continue
                slot_to_orig.append(obj_id)
                mask[..., slot + 1] = (label == obj_id).astype(np.float32)
                new_slots.append(slot)
            injections[fidx] = {"mask": mask, "new_slots": new_slots}

        first_label = load_label_mask(ann_frames[0]["path"])
        names_to_save = sorted({fn for g in objs.values() for fn in g["frames"]})
        init = injections.pop(0)
        return YTVOSVideo(
            name=name, frames=np.stack([load_image(p) for p in img_list]),
            in_size=self._infer_size(h0, w0), init_mask=init["mask"],
            init_slots=init["new_slots"], first_label=first_label, injections=injections,
            slot_to_orig=slot_to_orig, frame_names=frame_names, names_to_save=names_to_save,
            original_size=(h0, w0), n_objs=len(slot_to_orig),
        )

    def peek(self, idx: int):
        """(name, raw_hw, in_size, out_size, n_objs, n_frames) from meta.json
        and image headers only, without decoding a frame."""
        from PIL import Image

        name = self.videos[idx]
        img_list, _ = self._listing(name)
        objs = self.meta[name]["objects"]
        with Image.open(img_list[0]) as im:
            w, h = im.size  # the header only
        first_ann = min(g["frames"][0] for g in objs.values())
        with Image.open(os.path.join(self.root, "Annotations", name, first_ann + ".png")) as im:
            w0, h0 = im.size
        return (name, (h, w), self._infer_size(h0, w0), (h0, w0), min(len(objs), self.n_slots),
                len(img_list))
