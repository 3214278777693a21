"""Mixup / CutMix for video batches with soft-label targets.

Port of internvideo_tpu/data/mixup.py: per-batch mixup or cutmix (switch
probability), the partner of each clip is the batch rolled by one, one
cutmix box is shared by the whole batch, the label weight of cutmix is the
effective (clipped) box area, and label smoothing is folded into the soft
targets. The JAX function draws inside jit; here the three draws
(use_cutmix, lambda, box) are made on the host by `mixup_cutmix` from a
numpy Generator, and `mixup_cutmix_apply` is the deterministic core that
runs on the video's device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MixupConfig:
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    switch_prob: float = 0.5
    label_smoothing: float = 0.1
    num_classes: int = 400


def smoothed_one_hot(labels: torch.Tensor, n: int, smoothing: float) -> torch.Tensor:
    """(B,) int -> (B, n) float32 with `smoothing` spread over all classes."""
    off = smoothing / n
    on = 1.0 - smoothing + off
    return F.one_hot(labels.long(), n).float() * (on - off) + off


def mixup_cutmix_apply(video: torch.Tensor, labels: torch.Tensor, cfg: MixupConfig, *,
                       use_cutmix: bool, lam: float, box: tuple[int, int, int, int]):
    """(mixed_video, soft_labels) for given draws.

    `lam` weighs each clip against its partner for mixup; `box` =
    (y0, y1, x0, x1), already clipped to the frame, is pasted from the
    partner for cutmix, whose label weight is 1 - box area / frame area.
    """
    partner = torch.roll(video, 1, dims=0)
    y1 = smoothed_one_hot(labels, cfg.num_classes, cfg.label_smoothing)
    y2 = torch.roll(y1, 1, dims=0)
    if use_cutmix:
        h, w = video.shape[2], video.shape[3]
        top, bottom, left, right = box
        out = video.clone()
        out[:, :, top:bottom, left:right] = partner[:, :, top:bottom, left:right]
        lam = 1.0 - ((bottom - top) * (right - left)) / (h * w)
    else:
        out = lam * video + (1 - lam) * partner
    return out, lam * y1 + (1 - lam) * y2


def mixup_cutmix(rng: np.random.Generator, video: torch.Tensor, labels: torch.Tensor,
                 cfg: MixupConfig):
    """Returns (mixed_video, soft_labels); video is (B, T, H, W, C) float.

    Draws as the JAX function does: cutmix with probability `switch_prob`;
    lam ~ Beta(alpha, alpha) of the chosen branch; for cutmix a box of
    sides int(side * sqrt(1 - lam)) centred on a uniform pixel, clipped to
    the frame.
    """
    h, w = video.shape[2], video.shape[3]
    use_cutmix = bool(rng.random() < cfg.switch_prob)
    alpha = cfg.cutmix_alpha if use_cutmix else cfg.mixup_alpha
    lam = float(rng.beta(alpha, alpha))
    cut = math.sqrt(1.0 - lam)
    ch, cw = int(h * cut), int(w * cut)
    cy, cx = int(rng.integers(0, h)), int(rng.integers(0, w))
    box = (min(max(cy - ch // 2, 0), h), min(max(cy + ch // 2, 0), h),
           min(max(cx - cw // 2, 0), w), min(max(cx + cw // 2, 0), w))
    return mixup_cutmix_apply(video, labels, cfg, use_cutmix=use_cutmix, lam=lam, box=box)
