"""Video training dataset (the port's copy of ``swem_tpu/data/video_dataset.py``,
a re-design of the reference implementation's datasets/video_dataset.py:14-362).

Per sample: pick a video, recursively sample ``num_frames`` indices with
gaps bounded by the curriculum skip, 50% time reversal, sequence-level +
pair-level augmentations, TPS warp, select up to ``max_objs`` labels
(retrying up to 5x when frame 0 is empty), one-hot masks padded to the
static slot budget with a validity selector.

The curriculum (FrameSkipper) is a pure function of the iteration index —
the caller passes ``cur_skip`` per sample instead of rebuilding loaders at
skip boundaries (basic_trainer.py:227-231 made unnecessary).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from swem_tpu_torch.data import transforms as T
from swem_tpu_torch.data.tps import JointRandomTPS


class FrameSkipper:
    """Curriculum max-gap schedule (video_dataset.py:14-45).

    Ramps 0 -> max_skip over the first 10% of iterations, holds, then anneals
    to 2/5 * max_skip between 80% and 90%.
    """

    def __init__(self, max_skip: int = 25, max_iter: int = 60000):
        self.max_skip = max_skip
        self.final_skip = max(1, max_skip * 2 // 5)
        self.stages = [max(1, int(max_iter * 0.1)), int(max_iter * 0.8),
                       max(int(max_iter * 0.8) + 1, int(max_iter * 0.9))]

    def __call__(self, cur_iter: int) -> int:
        if cur_iter <= self.stages[1]:
            return int(min((self.max_skip * cur_iter) // self.stages[0], self.max_skip))
        span = self.stages[2] - self.stages[1]
        dec = ((self.max_skip - self.final_skip) * (cur_iter - self.stages[1])) // span
        return int(max(self.max_skip - dec, self.final_skip))


def select_frames(rng: np.random.Generator, n_total: int, n_frames: int,
                  cur_skip: int) -> List[int]:
    """Recursive bounded-gap frame sampling (video_dataset.py:198-229)."""
    ids = list(range(n_total))
    if n_frames > n_total:
        return list(rng.choice(ids, size=n_frames, replace=True))
    idx = int(rng.integers(0, n_total))
    selected = [ids[idx]]
    left, right = ids[:idx], ids[idx + 1:]
    remaining = n_frames - 1
    while remaining > 0:
        mean_inter = (len(left) + len(right) - remaining) // remaining
        nl = min(len(left), cur_skip + 1, mean_inter + 1)
        nr = min(len(right), cur_skip + 1, mean_inter + 1)
        j = int(rng.integers(-nl, nr))
        if j >= 0:
            selected.append(right[j])
            right = right[j + 1:]
        else:
            selected.append(left[j])
            left = left[:j]
        remaining -= 1
    return selected


def load_image_pil(path: str, short_size: Optional[int] = None) -> Image.Image:
    img = Image.open(path)
    img.load()
    img = img.convert("RGB")
    if short_size is not None:
        img = T.resize_short_side(img, short_size, Image.BICUBIC)
    return img


def load_ann_pil(path: str, short_size: Optional[int] = None) -> Image.Image:
    ann = Image.open(path)
    ann.load()
    ann = ann.convert("P")
    if short_size is not None:
        ann = T.resize_short_side(ann, short_size, Image.NEAREST)
    return ann


class VideoAugPipeline:
    """Two-level seed-synchronized augs (video_dataset.py:139-192).

    Sequence level (same params for all frames): hflip + RandomResizedCrop
    (scale 0.36-1) + ColorJitter(0.1,0.03,0.03) + RandomGrayscale(0.05).
    Pair level (per frame): RandomAffine(15 deg, shear 10) +
    ColorJitter(0.01,0.01,0.01). Then per-frame TPS (margin 0.25, p=1).
    """

    def __init__(self, crop_size: Tuple[int, int] = (384, 384)):
        self.crop_size = crop_size
        self.tps = JointRandomTPS(margin_rate=0.25, p=1.0)

    def __call__(self, rng, images: List[Image.Image], masks: List[Image.Image]):
        flip = rng.random() < 0.5
        crop = T.sample_resized_crop(rng, images[0].size, scale=(0.36, 1.0))
        seq_jitter = T.sample_color_jitter(rng, 0.1, 0.03, 0.03, 0.0)
        gray = rng.random() < 0.05

        out_imgs, out_masks = [], []
        for im, gt in zip(images, masks):
            if flip:
                im, gt = T.hflip(im), T.hflip(gt)
            im = T.apply_resized_crop(im, crop, self.crop_size, Image.BICUBIC)
            gt = T.apply_resized_crop(gt, crop, self.crop_size, Image.NEAREST)
            im = T.apply_color_jitter(im, seq_jitter)
            if gray:
                im = T.to_grayscale(im)
            # pair level
            aff = T.sample_affine(rng, degrees=15.0, shear=10.0)
            pair_jitter = T.sample_color_jitter(rng, 0.01, 0.01, 0.01, 0.0)
            im = T.apply_affine(im, aff, Image.BICUBIC, T.IM_MEAN)
            gt = T.apply_affine(gt, aff, Image.NEAREST, 0)
            im = T.apply_color_jitter(im, pair_jitter)
            # TPS: warp in uint8 (2x faster remap); frames stay uint8 all
            # the way to the device, which normalizes to [0,1] in-graph
            im_np, gt_np = self.tps(rng, np.asarray(im, np.uint8),
                                    np.asarray(gt, np.uint8))
            out_imgs.append(im_np)
            out_masks.append(gt_np)
        return out_imgs, out_masks


def finalize_sample(
    rng, images: List[np.ndarray], masks: List[np.ndarray], max_objs: int
) -> Optional[dict]:
    """Label selection + one-hot packing (video_dataset.py:301-356).

    Returns None when frame 0 contains no objects (caller retries).
    """
    labels = np.unique(masks[0])
    labels = labels[(labels != 0) & (labels != 255)]
    if len(labels) == 0:
        return None
    nobj = min(max_objs, len(labels))
    selected = rng.choice(labels, nobj, replace=False)
    mstack = np.stack(masks)  # (T, H, W)
    # build the slot-index label map once; unselected and void (255) pixels
    # stay slot 0 = background, matching video_dataset.py:338-339. The batch
    # ships compact (uint8 frames + uint8 labels, 8x fewer H2D bytes than
    # f32 frames + f32 one-hot); the train step derives the frame-0 one-hot
    # and the [0,1] normalization in-graph (trainer._model_inputs).
    lab = np.zeros(mstack.shape, np.uint8)
    for i, l in enumerate(selected):
        lab[mstack == l] = i + 1
    valid = np.zeros(max_objs + 1, np.float32)
    valid[: nobj + 1] = 1.0
    return {
        "frames": np.stack(images),  # (T, H, W, 3) uint8
        "valid_obj": valid,
        "label": lab,  # (T, H, W) uint8
    }


class VideoTrainDataset:
    """DAVIS17 / YTVOS19 training videos (video_dataset.py:48-362)."""

    def __init__(self, data_name: str, data_root: str, *, num_frames: int = 3,
                 max_objs: int = 2, crop_size=(384, 384), max_skip: int = 25,
                 samples_per_video: int = 5, max_iter: int = 150000,
                 subset_file: Optional[str] = None, load_size: Optional[int] = None):
        self.data_name = data_name
        self.num_frames = num_frames
        self.max_objs = max_objs
        self.samples_per_video = samples_per_video
        self.skipper = FrameSkipper(max_skip, max_iter)
        self.load_size = load_size
        if "DAVIS" in data_name:
            self.im_root = os.path.join(data_root, "JPEGImages", "480p")
            self.gt_root = os.path.join(data_root, "Annotations", "480p")
        else:  # YTVOS: expects a 480p-preprocessed train split
            sub = "train_480p" if os.path.isdir(os.path.join(data_root, "train_480p")) else "train"
            self.im_root = os.path.join(data_root, sub, "JPEGImages")
            self.gt_root = os.path.join(data_root, sub, "Annotations")

        subset = None
        if subset_file is not None and os.path.exists(subset_file):
            with open(subset_file) as f:
                subset = set(f.read().splitlines())
        self.videos = []
        self.frames = {}
        for vid in sorted(os.listdir(self.im_root)):
            if subset is not None and vid not in subset:
                continue
            fr = sorted(os.listdir(os.path.join(self.im_root, vid)))
            if len(fr) < 3:
                continue
            self.videos.append(vid)
            self.frames[vid] = fr
        self.aug = VideoAugPipeline(tuple(crop_size))

    def __len__(self) -> int:
        return len(self.videos) * self.samples_per_video

    def sample(self, rng: np.random.Generator, idx: int, cur_iter: int) -> dict:
        vid = self.videos[(idx // self.samples_per_video) % len(self.videos)]
        frames = self.frames[vid]
        cur_skip = self.skipper(cur_iter)
        for _ in range(5):
            sel = sorted(select_frames(rng, len(frames), self.num_frames, cur_skip))
            gaps = [sel[i + 1] - sel[i] for i in range(len(sel) - 1)]
            skips = float(np.mean(gaps) - 1.0) if gaps else 0.0
            if rng.random() < 0.5:
                sel = sel[::-1]  # time reversal (video_dataset.py:262-264)
            imgs, gts = [], []
            for f_idx in sel:
                base = frames[f_idx][:-4]
                imgs.append(load_image_pil(
                    os.path.join(self.im_root, vid, base + ".jpg"), self.load_size))
                gts.append(load_ann_pil(
                    os.path.join(self.gt_root, vid, base + ".png"), self.load_size))
            aimgs, agts = self.aug(rng, imgs, gts)
            out = finalize_sample(rng, aimgs, agts, self.max_objs)
            if out is not None:
                # mean sampled frame gap - 1 (TB skip stat, video_dataset.py:347)
                out["skips"] = np.float32(skips)
                return out
        # all-background fallback (video_dataset.py:320-323)
        T_, H, W = len(aimgs), *aimgs[0].shape[:2]
        # the reference marks one (empty) fg channel valid so the sample
        # still trains the decoder toward all-background (selector=[1,1,0])
        valid = np.zeros(self.max_objs + 1, np.float32)
        valid[:2] = 1.0
        return {
            "frames": np.stack(aimgs),
            "valid_obj": valid,
            "label": np.zeros((T_, H, W), np.uint8),
            "skips": np.float32(skips),
        }
