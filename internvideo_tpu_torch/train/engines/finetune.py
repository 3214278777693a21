"""Finetune engine: mixup/cutmix + soft-target CE classification.

Port of internvideo_tpu/train/engines/finetune.py (:22-55): mixup on the
device inside the step, label smoothing when mixup is off, soft-target CE
on fp32 logits, accuracy against the integer labels, DropPath on in
training. Each micro-batch's random draws come from one seed: mixup's from
a numpy Generator, DropPath's from a torch.Generator on the video's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from internvideo_tpu_torch.data.mixup import MixupConfig, mixup_cutmix, smoothed_one_hot
from internvideo_tpu_torch.train.step import make_accum_step


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    mixup: Optional[MixupConfig] = None
    label_smoothing: float = 0.1  # used when mixup is off
    num_classes: int = 400


def soft_target_ce(logits: torch.Tensor, soft: torch.Tensor) -> torch.Tensor:
    """-mean(sum(soft * log_softmax(logits))) in fp32."""
    return -(soft * torch.log_softmax(logits.float(), dim=-1)).sum(-1).mean()


def make_finetune_step(cfg: FinetuneConfig, *, grad_accum: int = 1):
    def loss_fn(model, batch, seed: int):
        video, labels = batch["video"], batch["label"]
        if cfg.mixup is not None:
            video, soft = mixup_cutmix(np.random.default_rng(seed), video, labels, cfg.mixup)
        else:
            soft = smoothed_one_hot(labels, cfg.num_classes, cfg.label_smoothing)
        gen = torch.Generator(device=video.device).manual_seed(seed)
        out = model(video, deterministic=False, generator=gen)
        logits = out.logits.float()
        loss = soft_target_ce(logits, soft)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"acc": acc}

    return make_accum_step(loss_fn, grad_accum=grad_accum)
