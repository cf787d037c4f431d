"""Static-image pretraining dataset (the port's copy of
``swem_tpu/data/static_dataset.py``, a re-design of the reference
implementation's datasets/static_dataset.py:19-314).

Synthesizes pseudo 3-frame videos from single images: foreground objects are
cropped by bbox, randomly resized (area 0.16-0.81) and pasted at random
positions over the frame-0 background (foreground mean-filled), then the
two-level augmentation pipeline + TPS runs per frame.
"""

from __future__ import annotations

import math
import os
from glob import glob
from typing import List, Optional, Sequence, Tuple

import cv2
import numpy as np
from PIL import Image

from swem_tpu_torch.data import transforms as T
from swem_tpu_torch.data.tps import JointRandomTPS
from swem_tpu_torch.data.video_dataset import finalize_sample, load_ann_pil, load_image_pil


def get_bbox(msk: np.ndarray) -> Optional[Tuple[int, int, int, int]]:
    """Tight bbox of a binary mask (static_dataset.py:19-34)."""
    ys, xs = np.nonzero(msk)
    if len(ys) == 0:
        return None
    return int(ys.min()), int(xs.min()), int(ys.max()) + 1, int(xs.max()) + 1


def random_resize(rng, img: np.ndarray, msk: np.ndarray,
                  scale=(0.16, 0.81), ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """Random-area resize of a cropped object (static_dataset.py:43-55)."""
    h, w = img.shape[:2]
    target_area = rng.uniform(*scale) * (h * w)
    aspect = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
    nh = max(1, int(round(math.sqrt(target_area / aspect))))
    nw = max(1, int(round(math.sqrt(target_area * aspect))))
    rimg = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_CUBIC)
    rmsk = cv2.resize(msk, (nw, nh), interpolation=cv2.INTER_NEAREST)
    return rimg, rmsk


def sample_place(rng, src_hw: Tuple[int, int], tar_hw: Tuple[int, int]):
    """Random paste placement (static_dataset.py:58-70): returns the target
    rectangle [tly:dry, tlx:drx] and the source offset (miny, minx)."""
    src_h, src_w = src_hw
    h, w = tar_hw
    cx = int(rng.integers(src_w // 2, max(w - src_w // 2, src_w // 2) + 1))
    cy = int(rng.integers(src_h // 2, max(h - src_h // 2, src_h // 2) + 1))
    tlx, tly = cx - src_w // 2, cy - src_h // 2
    minx, miny = max(0, -tlx), max(0, -tly)
    drx, dry = min(w, tlx + src_w), min(h, tly + src_h)
    tlx, tly = max(0, tlx), max(0, tly)
    return (tly, tlx, dry, drx), (miny, minx)


def synthesis_frames(rng, imgs: List[Image.Image], msks: List[Image.Image],
                     nframe: int = 3):
    """Composite pseudo-video synthesis (static_dataset.py:85-150)."""
    if len(imgs) == 1:
        return [imgs[0]] * nframe, [msks[0]] * nframe
    imgs_np = [np.asarray(im, np.float32) for im in imgs]
    msks_np = [(np.asarray(mk) > 0).astype(np.float32)[:, :, None] for mk in msks]
    h, w, c = imgs_np[0].shape
    crops = []
    for img, msk in zip(imgs_np, msks_np):
        bbox = get_bbox(msk[..., 0])
        if bbox is not None:
            y0, x0, y1, x1 = bbox
            crops.append((img[y0:y1, x0:x1], msk[y0:y1, x0:x1, 0]))
    ids = list(range(1, len(crops) + 2))
    rng.shuffle(ids)
    # the fg0-inpainted background is frame-invariant: build it once.
    # Boolean-mask composites replace the reference's float blends exactly
    # (p_msk is binary, so x*(1-p)+y*p == where(p, y, x) bit-for-bit).
    fg0 = msks_np[0]
    mean_fg = np.sum(imgs_np[0] * fg0, axis=(0, 1), keepdims=True) / (
        np.sum(fg0, axis=(0, 1), keepdims=True) + 1e-8
    )
    bg = imgs_np[0] * (1 - fg0) + mean_fg * fg0  # fg0-inpainted background
    syn_imgs, syn_msks = [], []
    for _ in range(nframe):
        # paste regions only: the reference composites via full-canvas
        # zero-padded intermediates (place_object, static_dataset.py:58-82)
        # costing 2 full-res float arrays per object per frame; writing the
        # subrectangle directly is bit-identical (masked pixels take the
        # object's values, others keep the canvas) and ~2x faster. RNG draw
        # order is preserved: resize (2 uniforms) then placement (2
        # integers) per object, then the z-order shuffle.
        placed = []
        for img, msk in crops:
            rimg, rmsk = random_resize(rng, img, msk)
            placed.append((rimg, rmsk, sample_place(rng, rimg.shape[:2], (h, w))))
        syn_img = bg.copy()
        syn_msk = np.zeros((h, w), np.uint8)
        order = list(range(len(placed)))
        rng.shuffle(order)
        for i in order:
            rimg, rmsk, ((tly, tlx, dry, drx), (miny, minx)) = placed[i]
            th, tw = dry - tly, drx - tlx
            sel = rmsk[miny:miny + th, minx:minx + tw] > 0
            syn_img[tly:dry, tlx:drx][sel] = rimg[miny:miny + th,
                                                  minx:minx + tw][sel]
            syn_msk[tly:dry, tlx:drx][sel] = ids[i]
        syn_imgs.append(Image.fromarray(np.clip(syn_img, 0, 255).astype(np.uint8)))
        syn_msks.append(Image.fromarray(syn_msk, "P"))
    return syn_imgs, syn_msks


class StaticAugPipeline:
    """Static-pretrain aug pipeline (static_dataset.py:196-240).

    Sequence level: RandomAffine(scale 0.8-1.5) + hflip +
    ColorJitter(0.1,0.05,0.05,0.05) + RandomGrayscale(0.05).
    Pair level: RandomAffine(20 deg, scale 0.9-1.1, shear 10) +
    Resize(short 384) + RandomCrop(384, pad_if_needed) +
    ColorJitter(0.1,0.05,0.05). Then TPS (margin 0.3, p=1).
    """

    def __init__(self, crop_size: Tuple[int, int] = (384, 384)):
        self.crop_size = crop_size
        self.tps = JointRandomTPS(margin_rate=0.3, p=1.0)

    def __call__(self, rng, images, masks):
        seq_aff = T.sample_affine(rng, degrees=0.0, scale_range=(0.8, 1.5))
        flip = rng.random() < 0.5
        seq_jitter = T.sample_color_jitter(rng, 0.1, 0.05, 0.05, 0.05)
        gray = rng.random() < 0.05
        out_imgs, out_masks = [], []
        for im, gt in zip(images, masks):
            im = T.apply_affine(im, seq_aff, Image.BICUBIC, T.IM_MEAN)
            gt = T.apply_affine(gt, seq_aff, Image.NEAREST, 0)
            if flip:
                im, gt = T.hflip(im), T.hflip(gt)
            im = T.apply_color_jitter(im, seq_jitter)
            if gray:
                im = T.to_grayscale(im)
            # pair level
            aff = T.sample_affine(rng, degrees=20.0, scale_range=(0.9, 1.1), shear=10.0)
            im = T.apply_affine(im, aff, Image.BICUBIC, T.IM_MEAN)
            gt = T.apply_affine(gt, aff, Image.NEAREST, 0)
            im = T.resize_short_side(im, self.crop_size[0], Image.BICUBIC)
            gt = T.resize_short_side(gt, self.crop_size[0], Image.NEAREST)
            crop = T.sample_crop(rng, im.size, self.crop_size)
            im = T.apply_crop_padded(im, crop, self.crop_size, T.IM_MEAN)
            gt = T.apply_crop_padded(gt, crop, self.crop_size, 0)
            im = T.apply_color_jitter(im, T.sample_color_jitter(rng, 0.1, 0.05, 0.05, 0.0))
            # TPS in uint8 (2x faster remap); frames stay uint8 all the way
            # to the device, which normalizes to [0,1] in-graph
            im_np, gt_np = self.tps(rng, np.asarray(im, np.uint8),
                                    np.asarray(gt, np.uint8))
            out_imgs.append(im_np)
            out_masks.append(gt_np)
        return out_imgs, out_masks


class StaticTrainDataset:
    """Pseudo-video pretraining over 5 image datasets with ratio oversampling
    (static_dataset.py:152-316, config.py:13-14)."""

    def __init__(self, data_root: str, *,
                 datasets: Sequence[str] = ("BIG_small", "HRSOD_small", "FSS", "ECSSD", "DUTS"),
                 ratios: Sequence[int] = (5, 5, 1, 1, 1),
                 num_frames: int = 3, max_objs: int = 2, crop_size=(384, 384)):
        self.num_frames = num_frames
        self.max_objs = max_objs
        self.img_list: List[str] = []
        self.msk_list: List[str] = []
        self.real_img_list: List[str] = []
        self.real_msk_list: List[str] = []
        for name, ratio in zip(datasets, ratios):
            img_dir = os.path.join(data_root, "JPEGImages", name)
            msk_dir = os.path.join(data_root, "Annotations", name)
            imgs = sorted(glob(os.path.join(img_dir, "*.jpg"))) + sorted(
                glob(os.path.join(img_dir, "*.png")))
            msks = sorted(glob(os.path.join(msk_dir, "*.png")))
            assert len(imgs) == len(msks), f"{name}: {len(imgs)} imgs vs {len(msks)} masks"
            self.img_list += imgs * ratio
            self.msk_list += msks * ratio
            self.real_img_list += imgs
            self.real_msk_list += msks
        self.real_len = len(self.real_img_list)
        self.index_map = {p: i for i, p in enumerate(self.real_img_list)}
        self.aug = StaticAugPipeline(tuple(crop_size))

    def __len__(self) -> int:
        return len(self.img_list)

    def sample(self, rng: np.random.Generator, idx: int, cur_iter: int = 0) -> dict:
        idx = idx % len(self.img_list)
        ims = [load_image_pil(self.img_list[idx])]
        gts = [load_ann_pil(self.msk_list[idx])]
        if self.max_objs > 1:
            cur = self.index_map[self.img_list[idx]]
            extra = rng.choice(self.real_len - 1, size=self.max_objs - 1, replace=False)
            for off in extra:
                rid = int((off + cur) % self.real_len)
                ims.append(load_image_pil(self.real_img_list[rid]))
                gts.append(load_ann_pil(self.real_msk_list[rid]))
        ims, gts = synthesis_frames(rng, ims, gts, self.num_frames)
        aimgs, agts = self.aug(rng, ims, gts)
        out = finalize_sample(rng, aimgs, agts, self.max_objs)
        if out is not None:
            out["skips"] = np.float32(0.0)
        if out is None:  # all-background (static_dataset.py:283-289 analogue)
            T_, H, W = len(aimgs), *aimgs[0].shape[:2]
            # one empty fg channel stays valid (reference selector=[1,1,0])
            valid = np.zeros(self.max_objs + 1, np.float32)
            valid[:2] = 1.0
            out = {
                "frames": np.stack(aimgs),
                "valid_obj": valid,
                "label": np.zeros((T_, H, W), np.uint8),
                "skips": np.float32(0.0),
            }
        return out
