"""Host-side image/mask augmentations (numpy + PIL + cv2, torch-free): the
port's copy of ``swem_tpu/data/transforms.py``.

Re-design of the reference implementation's torchvision pipelines
(datasets/video_dataset.py:139-192 and static_dataset.py:196-240). The reference keeps image and mask transforms in
sync by re-seeding global RNGs before each call (data_utils.py:11-13); here
every transform samples an explicit parameter object once and applies it to
image and mask with their respective interpolations — same distribution,
deterministic, no global state.

Interpolation policy: bicubic for images, nearest for masks (the reference
uses bicubic for static-dataset mask affines, a quirk we do not reproduce).
``im_mean`` fill matches data_utils.py:8.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import cv2
import numpy as np
from PIL import Image, ImageStat

IM_MEAN = (124, 116, 104)  # data_utils.py:8

# PIL resample constant -> cv2 interpolation flag (for the raster ops that
# run on cv2 for speed; the parametrization stays torchvision's)
_CV2_INTERP = {
    Image.NEAREST: cv2.INTER_NEAREST,
    Image.BILINEAR: cv2.INTER_LINEAR,
    Image.BICUBIC: cv2.INTER_CUBIC,
}


# --------------------------------------------------------------------- #
# Color jitter (torchvision semantics: random factor per enabled op,
# random op order)
# --------------------------------------------------------------------- #
@dataclass
class ColorJitterParams:
    ops: List[Tuple[str, float]]  # ordered (name, factor)


def sample_color_jitter(
    rng: np.random.Generator,
    brightness: float = 0.0,
    contrast: float = 0.0,
    saturation: float = 0.0,
    hue: float = 0.0,
) -> ColorJitterParams:
    ops = []
    if brightness > 0:
        ops.append(("brightness", rng.uniform(max(0.0, 1 - brightness), 1 + brightness)))
    if contrast > 0:
        ops.append(("contrast", rng.uniform(max(0.0, 1 - contrast), 1 + contrast)))
    if saturation > 0:
        ops.append(("saturation", rng.uniform(max(0.0, 1 - saturation), 1 + saturation)))
    if hue > 0:
        ops.append(("hue", rng.uniform(-hue, hue)))
    order = rng.permutation(len(ops))
    return ColorJitterParams([ops[i] for i in order])


def apply_color_jitter(img: Image.Image, params: ColorJitterParams) -> Image.Image:
    """torchvision ColorJitter semantics (sequential ImageEnhance
    Brightness/Contrast/Color blends in sampled order), BIT-EXACT vs the
    PIL enhancer chain (fuzz-tested) but ~2x faster at 384^2: the per-value
    blends become cv2.LUT passes, saturation one in-place float pass.
    Image.blend truncates ((int) cast in Blend.c — verified on a full uint8
    ramp), which np.clip + uint8-astype reproduces; the grayscale degenerate
    stays PIL's own convert("L") C path so its L24 fixed-point rounding is
    exact by construction. Hue keeps the PIL HSV round-trip (hot only in
    the static pretrain's sequence jitter, static_dataset.py:208; both
    video-pipeline jitters run hue=0, video_dataset.py:152).
    """
    arr = np.asarray(img)
    ramp = np.arange(256, dtype=np.float32)
    for name, factor in params.ops:
        if name == "brightness":
            # blend(black, img, f) = trunc(f * img)
            lut = np.clip(ramp * factor, 0, 255).astype(np.uint8)
            arr = cv2.LUT(arr, lut)
        elif name == "contrast":
            # blend(mean-gray, img, f); mean = int(L-mean + 0.5)
            l_img = Image.fromarray(arr).convert("L")
            mean = int(ImageStat.Stat(l_img).mean[0] + 0.5)
            lut = np.clip(mean + factor * (ramp - mean), 0, 255).astype(np.uint8)
            arr = cv2.LUT(arr, lut)
        elif name == "saturation":
            # blend(grayscale, img, f) — per-pixel, in-place float math
            g = np.asarray(Image.fromarray(arr).convert("L"), np.float32)
            a = arr.astype(np.float32)
            a -= g[..., None]
            a *= factor
            a += g[..., None]
            np.clip(a, 0, 255, out=a)
            arr = a.astype(np.uint8)  # trunc, matching Blend.c
        elif name == "hue":
            # PIL HSV round-trip kept verbatim (hue shift is only hot in
            # the static pretrain's sequence jitter, static_dataset.py:208)
            hsv = np.array(Image.fromarray(arr).convert("HSV"), np.uint8)
            hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(factor * 255)) % 256
            arr = np.asarray(Image.fromarray(hsv, "HSV").convert("RGB"))
    return Image.fromarray(arr)


# --------------------------------------------------------------------- #
# Random affine (torchvision RandomAffine parametrization)
# --------------------------------------------------------------------- #
@dataclass
class AffineParams:
    angle: float
    translate: Tuple[float, float]
    scale: float
    shear_x: float


def sample_affine(
    rng: np.random.Generator,
    degrees: float = 0.0,
    scale_range: Optional[Tuple[float, float]] = None,
    shear: float = 0.0,
) -> AffineParams:
    angle = rng.uniform(-degrees, degrees) if degrees else 0.0
    scale = rng.uniform(*scale_range) if scale_range else 1.0
    shear_x = rng.uniform(-shear, shear) if shear else 0.0
    return AffineParams(angle, (0.0, 0.0), scale, shear_x)


def _inverse_affine_matrix(params: AffineParams, center: Tuple[float, float]):
    """torchvision's inverse affine coefficients for PIL.Image.transform."""
    rot = math.radians(params.angle)
    sx = math.radians(params.shear_x)
    cx, cy = center
    tx, ty = params.translate
    a = math.cos(rot)
    b = -math.cos(rot) * math.tan(sx) - math.sin(rot)
    c = math.sin(rot)
    d = -math.sin(rot) * math.tan(sx) + math.cos(rot)
    m = [d, -b, 0.0, -c, a, 0.0]
    m = [x / params.scale for x in m]
    m[2] += m[0] * (-cx - tx) + m[1] * (-cy - ty)
    m[5] += m[3] * (-cx - tx) + m[4] * (-cy - ty)
    m[2] += cx
    m[5] += cy
    return m


def apply_affine(img: Image.Image, params: AffineParams, interp, fill) -> Image.Image:
    """torchvision RandomAffine's PIL.transform(AFFINE) semantics on
    cv2.warpAffine (~20x faster at 384^2; PIL's affine rasterizer is
    single-pass scalar C). PIL samples the input at M @ (out + 0.5) - 0.5
    (Geometry.c adds the half-pixel on the output side and drops it before
    interpolating), so the inverse matrix is rebased by that offset —
    nearest-mask and bicubic-image warps then land on the same geometry
    PIL produces.
    """
    w, h = img.size
    a, b, c, d, e, f = _inverse_affine_matrix(params, (w * 0.5, h * 0.5))
    m = np.array([[a, b, c + 0.5 * (a + b) - 0.5],
                  [d, e, f + 0.5 * (d + e) - 0.5]], np.float64)
    arr = np.asarray(img)
    fillcolor = tuple(fill) if isinstance(fill, (tuple, list)) and arr.ndim == 3 else (
        fill if not isinstance(fill, (tuple, list)) else fill[0]
    )
    out = cv2.warpAffine(
        arr, m, (w, h), flags=_CV2_INTERP[interp] | cv2.WARP_INVERSE_MAP,
        borderMode=cv2.BORDER_CONSTANT, borderValue=fillcolor)
    return Image.fromarray(out)


# --------------------------------------------------------------------- #
# Random resized crop (torchvision sampling incl. fallback)
# --------------------------------------------------------------------- #
@dataclass
class ResizedCropParams:
    top: int
    left: int
    height: int
    width: int


def sample_resized_crop(
    rng: np.random.Generator,
    img_size: Tuple[int, int],  # (w, h) PIL order
    scale: Tuple[float, float],
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> ResizedCropParams:
    w, h = img_size
    area = h * w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return ResizedCropParams(top, left, ch, cw)
    # fallback: center crop at clipped aspect ratio
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw = w
        ch = int(round(cw / ratio[0]))
    elif in_ratio > ratio[1]:
        ch = h
        cw = int(round(ch * ratio[1]))
    else:
        cw, ch = w, h
    top = (h - ch) // 2
    left = (w - cw) // 2
    return ResizedCropParams(top, left, ch, cw)


def apply_resized_crop(img: Image.Image, params: ResizedCropParams,
                       out_size: Tuple[int, int], interp) -> Image.Image:
    box = (params.left, params.top, params.left + params.width, params.top + params.height)
    return img.resize((out_size[1], out_size[0]), interp, box=box)


# --------------------------------------------------------------------- #
# Simple crops / resizes
# --------------------------------------------------------------------- #
@dataclass
class CropParams:
    top: int
    left: int


def resize_short_side(img: Image.Image, size: int, interp) -> Image.Image:
    w, h = img.size
    if h < w:
        nh, nw = size, size * w // h
    else:
        nw, nh = size, size * h // w
    return img.resize((nw, nh), interp)


def sample_crop(rng: np.random.Generator, img_size: Tuple[int, int],
                out_size: Tuple[int, int]) -> CropParams:
    w, h = img_size
    oh, ow = out_size
    top = int(rng.integers(0, max(h - oh, 0) + 1))
    left = int(rng.integers(0, max(w - ow, 0) + 1))
    return CropParams(top, left)


def apply_crop_padded(img: Image.Image, params: CropParams,
                      out_size: Tuple[int, int], fill) -> Image.Image:
    """Crop to out_size, padding with fill if the image is smaller
    (torchvision RandomCrop(pad_if_needed=True))."""
    oh, ow = out_size
    w, h = img.size
    if w < ow or h < oh:
        fillcolor = tuple(fill) if img.mode == "RGB" else (
            fill if not isinstance(fill, (tuple, list)) else fill[0]
        )
        padded = Image.new(img.mode, (max(w, ow), max(h, oh)), fillcolor)
        padded.paste(img, (0, 0))
        img = padded
        w, h = img.size
    left = min(params.left, w - ow)
    top = min(params.top, h - oh)
    return img.crop((left, top, left + ow, top + oh))


def hflip(img: Image.Image) -> Image.Image:
    return img.transpose(Image.FLIP_LEFT_RIGHT)


def to_grayscale(img: Image.Image) -> Image.Image:
    return img.convert("L").convert("RGB")
