"""UMT / MAE masked-pretraining engine.

Port of internvideo_tpu/train/engines/pretrain.py: one step of
engine_for_pretraining.train_one_epoch:

  1. the frozen CLIP teacher on the temporally downsampled clip
     `video[:, ::td_ratio]` (targets + pooling attention) and the frozen MAE
     teacher on the full-rate clip, under torch.no_grad() (the JAX
     `stop_gradient`);
  2. masking: tube / random / attention-guided (Gumbel-top-k), drawn from a
     torch.Generator on the video's device seeded per micro-batch;
  3. the student on the visible tokens only (DropPath masks from the same
     generator);
  4. align losses 2 - 2 cos between the l2-normed student decoders and the
     teacher targets gathered at the same visible positions: CLS + keep + 1
     in the CLIP teacher's token space, keep in the MAE teacher's;
  5. the AdamW step (train/step.py).

The loss is clip_middle * r0 + clip_final * r1 + mae * r_mae; the aux
metrics are the three terms. The teachers are arguments, never attributes
of the student: they are in no optimizer group, no global norm and no
checkpoint of the student.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from internvideo_tpu_torch.data.masking import (
    attention_guided_keep_indices,
    random_keep_indices,
    tube_keep_indices,
)
from internvideo_tpu_torch.train.step import make_accum_step


@dataclasses.dataclass(frozen=True)
class UMTPretrainConfig:
    """Same fields and defaults as internvideo_tpu's UMTPretrainConfig."""

    mask_type: str = "tube"  # tube | random | attention
    mask_ratio: float = 0.8
    td_ratio: int = 2  # temporal downsample for student / CLIP teacher vs MAE teacher
    clip_loss_ratio: tuple[float, float] = (1.0, 1.0)  # (middle, final)
    mae_loss_ratio: float = 1.0
    distill_final_features: bool = True


def _align_loss(student: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """mean(2 - 2 cos) for l2-normalised features, in fp32 (engine :130-147)."""
    return (2.0 - 2.0 * (student.float() * target.float()).sum(-1)).mean()


def draw_keep_indices(cfg: UMTPretrainConfig, generator: torch.Generator, attn: torch.Tensor,
                      batch: int, t_student: int) -> torch.Tensor:
    """keep_indices (B, n_vis) of `cfg.mask_type` over t_student temporal
    token positions of attn.shape[-1] spatial tokens each."""
    n_spatial = attn.shape[-1]
    if cfg.mask_type == "attention":
        return attention_guided_keep_indices(generator, attn, cfg.mask_ratio, batch=batch)
    if cfg.mask_type == "tube":
        return tube_keep_indices(generator, batch, t_student, n_spatial, cfg.mask_ratio)
    if cfg.mask_type == "random":
        return random_keep_indices(generator, batch, t_student * n_spatial, cfg.mask_ratio)
    raise ValueError(f"unknown mask_type {cfg.mask_type!r}")


def pretrain_loss(model, clip_teacher, mae_teacher, cfg: UMTPretrainConfig,
                  video: torch.Tensor, *, keep: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  deterministic: bool = False):
    """(loss, aux metrics, keep) for one full-rate clip batch (B, T, H, W, 3).

    `keep`: visible positions to use instead of a draw (the route and
    parity checks pass them, so that both sides see the same tokens);
    otherwise `generator` draws them, and the DropPath masks after them."""
    b = video.shape[0]
    student_video = video[:, ::cfg.td_ratio]
    # temporal TOKEN count: a tubelet-2 student has half as many positions
    t_s = student_video.shape[1] // model.config.encoder.tubelet_size
    with torch.no_grad():
        z_clip, clip_final_t, attn = clip_teacher(student_video)
        z_mae = mae_teacher(video)
    if keep is None:
        keep = draw_keep_indices(cfg, generator, attn, b, t_s)
    keep = keep.long()
    out = model(student_video, keep, deterministic=deterministic, generator=generator)

    # cls + visible patches in the CLIP teacher's token space
    gather_clip = torch.cat([torch.zeros_like(keep[:, :1]), keep + 1], dim=1)
    tgt_clip = torch.gather(
        z_clip, 2, gather_clip[None, :, :, None].expand(z_clip.shape[0], -1, -1, z_clip.shape[-1]))
    tgt_mae = torch.gather(
        z_mae, 2, keep[None, :, :, None].expand(z_mae.shape[0], -1, -1, z_mae.shape[-1]))

    loss_clip_middle = _align_loss(out.clip_middle, tgt_clip)
    if cfg.distill_final_features and cfg.clip_loss_ratio[1] > 0:
        loss_clip_final = _align_loss(out.clip_final, clip_final_t)
    else:
        loss_clip_final = torch.zeros((), device=video.device)
    loss_mae = _align_loss(out.mae, tgt_mae)
    loss = (loss_clip_middle * cfg.clip_loss_ratio[0]
            + loss_clip_final * cfg.clip_loss_ratio[1]
            + loss_mae * cfg.mae_loss_ratio)
    aux = {"loss_clip_middle": loss_clip_middle, "loss_clip_final": loss_clip_final,
           "loss_mae": loss_mae}
    return loss, aux, keep


def make_pretrain_step(cfg: UMTPretrainConfig, clip_teacher, mae_teacher, *,
                       grad_accum: int = 1):
    """step(state, batch) -> metrics; batch {"video": (B, T, H, W, 3)} is the
    full-rate clip. The teachers are frozen modules (train/state.py
    `frozen_teacher`) on the student's device."""

    def loss_fn(model, batch, seed: int):
        video = batch["video"]
        gen = torch.Generator(device=video.device).manual_seed(seed)
        loss, aux, _ = pretrain_loss(model, clip_teacher, mae_teacher, cfg, video,
                                     generator=gen)
        return loss, aux

    return make_accum_step(loss_fn, grad_accum=grad_accum)
