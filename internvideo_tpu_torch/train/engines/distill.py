"""Distillation engine: a small student aligned to a big frozen encoder.

Port of internvideo_tpu/train/engines/distill.py (`DistillConfig`,
`make_distill_step`): the student is the pretrain skeleton with CLIP-align
decoders only (`PretrainInternVideo2` with mae_return_layers=0); the
teacher is an InternVideo2 encoder whose hidden states at
`teacher_layer_indices` (l2-normed, gathered at the student's visible
positions with the CLS slot in front) and whose l2-normed pooled output
are the targets; the loss is the 2 - 2 cos alignment of the pretrain
engine. The teacher runs under torch.no_grad() (the JAX `stop_gradient`).

As in JAX, the teacher's layers stack in the order `teacher_layer_indices`
gives them and the student's decoders in ascending layer order, so the
j-th index pairs with the student's j-th lowest aligned layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from internvideo_tpu_torch.data.masking import random_keep_indices, tube_keep_indices
from internvideo_tpu_torch.models.teachers import _l2
from internvideo_tpu_torch.train.engines.pretrain import _align_loss
from internvideo_tpu_torch.train.step import make_accum_step


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """Same fields and defaults as internvideo_tpu's DistillConfig."""

    teacher_layer_indices: tuple[int, ...] = ()  # teacher layers to align
    mask_type: str = "tube"  # tube | random | none
    mask_ratio: float = 0.0
    loss_ratio: tuple[float, float] = (1.0, 1.0)  # (middle, final)


def draw_keep_indices(cfg: DistillConfig, enc, generator: torch.Generator,
                      batch: int, num_frames: int) -> torch.Tensor:
    """keep_indices (B, n_vis) for the student's config `enc`: tube or
    random masking at cfg.mask_ratio, or every position (JAX :58-73)."""
    n_spatial = (enc.img_size // enc.patch_size) ** 2
    if cfg.mask_type == "tube" and cfg.mask_ratio > 0:
        return tube_keep_indices(generator, batch, num_frames // enc.tubelet_size, n_spatial,
                                 cfg.mask_ratio)
    if cfg.mask_type == "random" and cfg.mask_ratio > 0:
        return random_keep_indices(generator, batch, enc.num_patches, cfg.mask_ratio)
    return torch.arange(enc.num_patches, device=generator.device).expand(batch, -1)


@torch.no_grad()
def teacher_targets(teacher, cfg: DistillConfig, video: torch.Tensor,
                    keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(layers (K, B, 1+n_vis, C), pooled (B, C')): the teacher's hidden
    states at cfg.teacher_layer_indices gathered at CLS + keep + 1, and its
    pooled output, each l2-normed (the norm in fp32, as JAX :33-55)."""
    want = sorted(set(cfg.teacher_layer_indices))
    out = teacher(video, return_hidden_layers=want)
    hidden = dict(zip(want, out.hidden_states))
    gather = torch.cat([torch.zeros_like(keep[:, :1]), keep + 1], dim=1)
    # gather, then norm each token: the same rows as norm, then gather
    layers = torch.stack([
        torch.gather(hidden[i], 1, gather[..., None].expand(-1, -1, hidden[i].shape[-1]))
        for i in cfg.teacher_layer_indices])
    return _l2(layers), _l2(out.pooled)


def distill_loss(student, teacher, cfg: DistillConfig, video: torch.Tensor, *,
                 keep: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 deterministic: bool = False):
    """(loss, aux metrics, keep) for a clip batch (B, T, H, W, 3).

    `keep`: visible positions to use instead of a draw (the parity and
    route checks pass them, so that both sides see the same tokens);
    otherwise `generator` draws them, and the DropPath masks after them."""
    b, t = video.shape[:2]
    if keep is None:
        keep = draw_keep_indices(cfg, student.config.encoder, generator, b, t)
    keep = keep.long()
    tgt_mid, tgt_final = teacher_targets(teacher, cfg, video, keep)
    out = student(video, keep, deterministic=deterministic, generator=generator)
    loss_mid = _align_loss(out.clip_middle, tgt_mid)
    loss_final = (_align_loss(out.clip_final, tgt_final) if out.clip_final is not None
                  else torch.zeros((), device=video.device))
    loss = cfg.loss_ratio[0] * loss_mid + cfg.loss_ratio[1] * loss_final
    return loss, {"loss_middle": loss_mid, "loss_final": loss_final}, keep


def make_distill_step(teacher, cfg: DistillConfig, *, grad_accum: int = 1):
    """step(state, batch) -> metrics; batch {"video": (B, T, H, W, 3)}. The
    teacher is a frozen module (train/state.py `frozen_teacher`) on the
    student's device."""

    def loss_fn(model, batch, seed: int):
        video = batch["video"]
        gen = torch.Generator(device=video.device).manual_seed(seed)
        loss, aux, _ = distill_loss(model, teacher, cfg, video, generator=gen)
        return loss, aux

    return make_accum_step(loss_fn, grad_accum=grad_accum)
