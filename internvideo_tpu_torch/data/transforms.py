"""Host-side video augmentation (numpy/PIL, per-clip).

Port of internvideo_tpu/data/transforms.py, a copy: the JAX module is
numpy, PIL and cv2 already, and the port imports nothing of the JAX
package. cv2 is imported inside the two resize functions only (and PIL
inside the RandAugment op), so code that never resizes (or augments) never
needs either.

Covers the reference's augmentation stack (SURVEY S13):
  * spatial: short-side resize, center/random crop, horizontal flip,
    multi-scale crop (video_transforms.py, transforms.py GroupMultiScaleCrop)
  * RandAugment core ops applied consistently across frames
    (rand_augment.py — same op+magnitude for all frames of a clip)
  * RandomErasing (random_erasing.py) — per-clip cube erasing
  * normalize to float32 with mean/std

All transforms take and return (T, H, W, 3) uint8 (normalize returns f32).
Randomness is explicit via numpy Generators — no global seeds.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def resize_short_side(clip: np.ndarray, size: int) -> np.ndarray:
    import cv2

    t, h, w, _ = clip.shape
    if min(h, w) == size:
        return clip
    if h < w:
        nh, nw = size, int(round(w * size / h))
    else:
        nh, nw = int(round(h * size / w)), size
    return np.stack([
        cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LINEAR) for f in clip
    ])


def resize(clip: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    import cv2

    return np.stack([
        cv2.resize(f, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)
        for f in clip
    ])


def center_crop(clip: np.ndarray, size: int) -> np.ndarray:
    _, h, w, _ = clip.shape
    top, left = (h - size) // 2, (w - size) // 2
    return clip[:, top:top + size, left:left + size]


def random_crop(clip: np.ndarray, size: int, rng: np.random.Generator):
    _, h, w, _ = clip.shape
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return clip[:, top:top + size, left:left + size]


def random_resized_crop(
    clip: np.ndarray, size: int, rng: np.random.Generator,
    scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
) -> np.ndarray:
    _, h, w, _ = clip.shape
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if cw <= w and ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return resize(clip[:, top:top + ch, left:left + cw], (size, size))
    return resize(center_crop(resize_short_side(clip, size), size), (size, size))


def horizontal_flip(clip: np.ndarray, rng: np.random.Generator, p=0.5):
    if rng.uniform() < p:
        return clip[:, :, ::-1]
    return clip


def multi_scale_crop(
    clip: np.ndarray, size: int, rng: np.random.Generator,
    scales: Sequence[float] = (1.0, 0.875, 0.75, 0.66),
) -> np.ndarray:
    """GroupMultiScaleCrop: pick a scale pair and one of 13 fixed offsets."""
    _, h, w, _ = clip.shape
    base = min(h, w)
    cw = int(base * scales[int(rng.integers(len(scales)))])
    ch = int(base * scales[int(rng.integers(len(scales)))])
    # 13 canonical offsets (4 corners, center, + 8 intermediates)
    w_step, h_step = (w - cw) // 4, (h - ch) // 4
    offsets = [
        (0, 0), (4 * w_step, 0), (0, 4 * h_step), (4 * w_step, 4 * h_step),
        (2 * w_step, 2 * h_step), (0, 2 * h_step), (4 * w_step, 2 * h_step),
        (2 * w_step, 4 * h_step), (2 * w_step, 0), (1 * w_step, 1 * h_step),
        (3 * w_step, 1 * h_step), (1 * w_step, 3 * h_step),
        (3 * w_step, 3 * h_step),
    ]
    left, top = offsets[int(rng.integers(len(offsets)))]
    return resize(clip[:, top:top + ch, left:left + cw], (size, size))


def normalize(clip: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    x = clip.astype(np.float32) / 255.0
    return (x - mean) / std


def random_erasing(
    clip: np.ndarray, rng: np.random.Generator,
    p=0.25, area=(0.02, 0.33), ratio=(0.3, 3.3),
) -> np.ndarray:
    """Per-clip cube erasing with random noise fill (random_erasing.py)."""
    if rng.uniform() >= p:
        return clip
    t, h, w, c = clip.shape
    for _ in range(10):
        target = h * w * rng.uniform(*area)
        ar = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        eh = int(round(np.sqrt(target * ar)))
        ew = int(round(np.sqrt(target / ar)))
        if eh < h and ew < w:
            top = int(rng.integers(0, h - eh))
            left = int(rng.integers(0, w - ew))
            out = clip.copy()
            noise = rng.integers(
                0, 256, size=(t, eh, ew, c), dtype=np.uint8
            ) if clip.dtype == np.uint8 else rng.normal(size=(t, eh, ew, c))
            out[:, top:top + eh, left:left + ew] = noise
            return out
    return clip


# ---------------------------------------------------------------------------
# RandAugment (clip-consistent)
# ---------------------------------------------------------------------------


def _pil_op(frame, op: str, mag: float):
    from PIL import Image, ImageEnhance, ImageOps

    img = Image.fromarray(frame)
    if op == "autocontrast":
        img = ImageOps.autocontrast(img)
    elif op == "equalize":
        img = ImageOps.equalize(img)
    elif op == "invert":
        img = ImageOps.invert(img)
    elif op == "rotate":
        img = img.rotate(mag * 30)
    elif op == "posterize":
        img = ImageOps.posterize(img, max(1, int(8 - mag * 4)))
    elif op == "solarize":
        img = ImageOps.solarize(img, int(256 - mag * 256))
    elif op == "color":
        img = ImageEnhance.Color(img).enhance(1 + mag * 0.9)
    elif op == "contrast":
        img = ImageEnhance.Contrast(img).enhance(1 + mag * 0.9)
    elif op == "brightness":
        img = ImageEnhance.Brightness(img).enhance(1 + mag * 0.9)
    elif op == "sharpness":
        img = ImageEnhance.Sharpness(img).enhance(1 + mag * 0.9)
    elif op == "shear_x":
        img = img.transform(
            img.size, Image.AFFINE, (1, mag * 0.3, 0, 0, 1, 0)
        )
    elif op == "shear_y":
        img = img.transform(
            img.size, Image.AFFINE, (1, 0, 0, mag * 0.3, 1, 0)
        )
    elif op == "translate_x":
        img = img.transform(
            img.size, Image.AFFINE, (1, 0, mag * 0.3 * img.size[0], 0, 1, 0)
        )
    elif op == "translate_y":
        img = img.transform(
            img.size, Image.AFFINE, (1, 0, 0, 0, 1, mag * 0.3 * img.size[1])
        )
    else:
        raise ValueError(op)
    return np.asarray(img)


RAND_AUGMENT_OPS = (
    "autocontrast", "equalize", "rotate", "posterize", "solarize",
    "color", "contrast", "brightness", "sharpness",
    "shear_x", "shear_y", "translate_x", "translate_y",
)


def rand_augment(
    clip: np.ndarray, rng: np.random.Generator,
    num_ops: int = 2, magnitude: int = 9,
) -> np.ndarray:
    """N ops at magnitude M, SAME op/mag/sign for all frames of the clip
    (rand_augment.py applies one transform group to the frame list)."""
    out = clip
    for _ in range(num_ops):
        op = RAND_AUGMENT_OPS[int(rng.integers(len(RAND_AUGMENT_OPS)))]
        mag = (magnitude / 10.0) * (1 if rng.uniform() < 0.5 else -1)
        out = np.stack([_pil_op(f, op, mag) for f in out])
    return out
