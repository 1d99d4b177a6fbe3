"""Host-side decode + augmentation pipeline (a copy of
:mod:`bvc_tpu.data.transforms`).

Replaces the reference's torchvision transform stacks
(``generative/homeview.py:218-231`` default stack;
``predictive/homeview.py:157-184`` aug-flag variant; the 'o' flag only in
``contrastive/homeview.py:157-187``) with numpy/PIL/cv2 implementations that
run in the loader's worker threads.  Output is channels-last float32 —
the TPU-canonical layout — normalized with mean 0.5 / std 0.25.

Aug flags (same letters as the reference CLI ``--augs``):

- ``c``: RandomResizedCrop(crop_size, scale=crop_scale, ratio 3/4..4/3)
- ``j``: color distortion — ColorJitter(0.8s, 0.8s, 0.8s, 0.2s) applied
  w.p. 0.8 (s=0.5) then grayscale w.p. 0.2 (``get_color_distortion``,
  ``generative/homeview.py:195-203``)
- ``b``: GaussianBlur w.p. 0.5, radius U(0.1, 2) (``:205-216``)
- ``g``: RandomGrayscale p=0.5
- ``o``: HFlip p=0.5 + rotation U(-90, 90)
- default (no 'c'): Resize(shorter side) + CenterCrop

Exact resampling parity with torchvision is impossible (different kernels);
what is preserved is the *distributional* contract — crop geometry, jitter
ranges and application order, normalization constants (SURVEY.md §7
"RNG semantics").

Unlike the JAX package's module, this one imports PIL and cv2 inside the
functions that decode or augment, so the plain and packed paths import on a
machine that has neither.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np


@functools.cache
def _cv2():
    """The cv2 module, or None where it does not import (asked once)."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2

MEAN = 0.5
STD = 0.25


def decode_jpeg(path: str) -> np.ndarray:
    """``[H, W, 3]`` uint8 RGB."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"failed to decode {path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def resize_shorter(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    if min(h, w) == size:
        return img
    if h < w:
        nh, nw = size, max(1, round(w * size / h))
    else:
        nh, nw = max(1, round(h * size / w)), size
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top = max(0, (h - size) // 2)
    left = max(0, (w - size) // 2)
    out = img[top : top + size, left : left + size]
    if out.shape[0] != size or out.shape[1] != size:  # pad small images
        pad = np.zeros((size, size) + img.shape[2:], img.dtype)
        pad[: out.shape[0], : out.shape[1]] = out
        out = pad
    return out


def random_resized_crop(
    img: np.ndarray, rng: np.random.Generator, size: int,
    scale: tuple[float, float], ratio: tuple[float, float] = (3 / 4, 4 / 3),
) -> np.ndarray:
    """torchvision RandomResizedCrop geometry: 10 tries of (area, log-ratio)
    sampling; fallback = the largest centered window whose aspect ratio is
    clamped into ``ratio`` (torchvision's exact fallback — with
    crop_scale=(1,1) the loop almost always fails, so the fallback IS the
    hot path for the JEPA/predictive config)."""
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            crop = img[top : top + ch, left : left + cw]
            break
    else:
        in_ratio = w / h
        if in_ratio < ratio[0]:
            cw, ch = w, int(round(w / ratio[0]))
        elif in_ratio > ratio[1]:
            ch, cw = h, int(round(h * ratio[1]))
        else:  # whole image
            cw, ch = w, h
        top = (h - ch) // 2
        left = (w - cw) // 2
        crop = img[top : top + ch, left : left + cw]
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(crop, (size, size), interpolation=cv2.INTER_LINEAR)
    from PIL import Image

    return np.asarray(Image.fromarray(crop).resize((size, size), Image.BILINEAR))


def _blend(a: np.ndarray, b: np.ndarray, alpha: float) -> np.ndarray:
    return np.clip(alpha * a + (1 - alpha) * b, 0, 255)


def color_jitter(
    img: np.ndarray, rng: np.random.Generator,
    brightness: float, contrast: float, saturation: float, hue: float,
) -> np.ndarray:
    """torchvision ColorJitter semantics: each op applied in random order
    with factors drawn from [max(0, 1-x), 1+x] (hue from [-h, h])."""
    img = img.astype(np.float32)
    ops = list(rng.permutation(4))
    for op in ops:
        if op == 0 and brightness:
            f = rng.uniform(max(0, 1 - brightness), 1 + brightness)
            img = np.clip(img * f, 0, 255)
        elif op == 1 and contrast:
            f = rng.uniform(max(0, 1 - contrast), 1 + contrast)
            gray_mean = _grayscale(img).mean()
            img = _blend(img, np.full_like(img, gray_mean), f)
        elif op == 2 and saturation:
            f = rng.uniform(max(0, 1 - saturation), 1 + saturation)
            img = _blend(img, _grayscale(img)[..., None].repeat(3, -1), f)
        elif op == 3 and hue:
            f = rng.uniform(-hue, hue)
            img = _hue_shift(img, f)
    return img.astype(np.uint8)


def _grayscale(img: np.ndarray) -> np.ndarray:
    # ITU-R 601 luma, as PIL convert('L') uses
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def _hue_shift(img: np.ndarray, factor: float) -> np.ndarray:
    cv2 = _cv2()
    if cv2 is not None:
        hsv = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_RGB2HSV)
        hsv = hsv.astype(np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(factor * 180)) % 180
        return cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB).astype(np.float32)
    return img  # PIL fallback: skip hue (hue=0.1 max; minor)


def grayscale3(img: np.ndarray) -> np.ndarray:
    g = _grayscale(img.astype(np.float32))
    return np.clip(g, 0, 255).astype(np.uint8)[..., None].repeat(3, -1)


def gaussian_blur(img: np.ndarray, radius: float) -> np.ndarray:
    from PIL import Image, ImageFilter

    return np.asarray(
        Image.fromarray(img).filter(ImageFilter.GaussianBlur(radius=radius))
    )


def rotate(img: np.ndarray, degrees: float) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.fromarray(img).rotate(degrees, resample=Image.BILINEAR))


def normalize(img: np.ndarray) -> np.ndarray:
    """uint8 → float32 normalized (x/255 - mean)/std, channels-last."""
    return (img.astype(np.float32) / 255.0 - MEAN) / STD


def denormalize(arr: np.ndarray) -> np.ndarray:
    return np.clip(np.round((arr * STD + MEAN) * 255.0), 0, 255).astype(np.uint8)


@dataclass
class FrameTransform:
    """Configured per-frame transform, seeded per call for reproducibility.

    ``__call__(img_u8, rng) → float32 [size, size, 3]``.
    """

    image_size: int = 224
    augs: str = "n"
    crop_size: int = 0
    crop_scale: tuple[float, float] = (1.0, 1.0)
    jitter_strength: float = 0.5  # 's' in get_color_distortion; trainers use 0.5
    # ship uint8 to the device and normalize inside the jitted step
    # (4x less H2D traffic; see videomae.normalize_on_device)
    output_uint8: bool = False
    # native fast path: decode at reduced DCT scale when downscaling
    # (False = strict pixel parity with the cv2 decode-then-resize path)
    dct_scale: bool = True

    @property
    def is_plain(self) -> bool:
        """True when the transform is the deterministic
        resize→center-crop→normalize stack (no aug flags) — the condition
        for taking the fused native decode path."""
        return not any(f in self.augs for f in "cjbgo")

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        size = self.crop_size or self.image_size
        if "c" in self.augs:
            img = random_resized_crop(img, rng, size, self.crop_scale)
        else:
            img = center_crop(resize_shorter(img, self.image_size), self.image_size)
        if "j" in self.augs:
            s = self.jitter_strength
            if rng.random() < 0.8:
                img = color_jitter(img, rng, 0.8 * s, 0.8 * s, 0.8 * s, 0.2 * s)
            if rng.random() < 0.2:
                img = grayscale3(img)
        if "b" in self.augs and rng.random() < 0.5:
            img = gaussian_blur(img, rng.uniform(0.1, 2.0))
        if "g" in self.augs and rng.random() < 0.5:
            img = grayscale3(img)
        if "o" in self.augs:
            if rng.random() < 0.5:
                img = img[:, ::-1]
            img = rotate(np.ascontiguousarray(img), rng.uniform(-90, 90))
        if self.output_uint8:
            return np.ascontiguousarray(img)
        return normalize(img)
