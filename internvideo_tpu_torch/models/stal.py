"""Spatio-temporal action localization: the trainable ROI action head.

Port of internvideo_tpu/models/stal.py (the reference's STAL training
suite, InternVideo1/Downstream/Spatial-Temporal-Action-Localization/
alphaction/modeling/roi_heads/action_head/):

  * ROIAlign3D person crops from the backbone feature volume
    (ops/roi_align3d.py), temporal mean + spatial max pooling, a 2-layer
    MLP feature extractor and an FC predictor with std 0.01 init
    (roi_action_predictors.py:5-32);
  * the AVA three-group loss (loss.py:6-78): softmax focal over the
    pose-movement classes + sigmoid focal over the object-manipulation and
    person-interaction groups, normalised by the average box count;
  * `random_box_aug`, the proposal jitter random_aug(0.2, 0.1, 0.1, 0.05)
    (loss.py:24-38), drawn from an explicit torch.Generator;
  * fixed shapes: boxes arrive padded (B, N, 4) with a validity mask, and
    invalid boxes are masked out of every loss term.

Inference scores feed eval/spatiotemporal.py (frame mAP). The JAX head's
params map onto this module's state_dict with models/convert.py's
`params_from_jax`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from internvideo_tpu_torch.nn.dense import Dense, lecun_normal_std
from internvideo_tpu_torch.ops.roi_align3d import roi_align_3d


@dataclasses.dataclass(frozen=True)
class STALConfig:
    in_dim: int = 2304          # SlowFast / encoder feature channels
    hidden_dim: int = 512
    num_pose: int = 14          # AVA person-movement classes (softmax)
    num_object: int = 49        # object-manipulation classes (sigmoid)
    num_person: int = 17        # person-interaction classes (sigmoid)
    roi_size: tuple = (7, 7)
    spatial_scale: float = 1.0  # feature-grid units per box unit
    dropout: float = 0.0
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25

    @property
    def num_classes(self) -> int:
        return self.num_pose + self.num_object + self.num_person


class ROIActionHead(nn.Module):
    def __init__(self, config: STALConfig, *, device, generator: torch.Generator):
        super().__init__()
        self.config = cfg = config
        self.fc1 = Dense(cfg.in_dim, cfg.hidden_dim, init_std=lecun_normal_std(cfg.in_dim),
                         device=device)
        self.fc2 = Dense(cfg.hidden_dim, cfg.hidden_dim,
                         init_std=lecun_normal_std(cfg.hidden_dim), device=device)
        self.cls_score = Dense(cfg.hidden_dim, cfg.num_classes, device=device)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's lecun-normal for fc1 / fc2, normal(0.01) for cls_score
        (its kernel_init), zero biases."""
        self.fc1.init_weights(generator)
        self.fc2.init_weights(generator)
        w = self.cls_score.weight
        w.copy_(torch.randn(w.shape, generator=generator, device=w.device) * 0.01)
        self.cls_score.bias.zero_()

    def forward(self, features: torch.Tensor, boxes: torch.Tensor, box_mask: torch.Tensor, *,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """features (B, T, H, W, C); boxes (B, N, 4) xyxy in feature-grid
        units / spatial_scale; box_mask (B, N) -> logits (B, N, classes).
        With dropout on and `deterministic=False`, the dropout mask is drawn
        from `generator`."""
        cfg = self.config
        b, n = boxes.shape[:2]
        bidx = torch.arange(b, dtype=boxes.dtype, device=boxes.device).repeat_interleave(n)
        flat = torch.cat([bidx[:, None], boxes.reshape(b * n, 4)], dim=1)
        roi = roi_align_3d(features, flat, output_size=cfg.roi_size,
                           spatial_scale=cfg.spatial_scale)  # (B*N, T, h, w, C)
        # temporal average + spatial max pooling (the reference's 3D head
        # pools the same way before the FC layers)
        x = roi.mean(dim=1).amax(dim=(1, 2))  # (B*N, C)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        if cfg.dropout > 0 and not deterministic:
            if generator is None:
                raise ValueError("dropout in training needs a generator")
            keep = torch.rand(x.shape, generator=generator, device=x.device) >= cfg.dropout
            x = torch.where(keep, x / (1.0 - cfg.dropout), 0.0)
        return self.cls_score(x).reshape(b, n, cfg.num_classes)


def random_box_aug(boxes: torch.Tensor, generator: torch.Generator, *, ratio=0.2, shift_x=0.1,
                   shift_y=0.1, scale=0.05) -> torch.Tensor:
    """The reference's proposal jitter random_aug(0.2, 0.1, 0.1, 0.05):
    per-box width and height jitter drawn independently (the reference
    jitters each edge, bounding_box.py:238-241), a center shift and a scale
    jitter; five uniform draws from `generator`, on its device."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    w, h = x2 - x1, y2 - y1
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)

    def u(s):
        r = torch.rand(w.shape, generator=generator, device=generator.device)
        return (2.0 * r - 1.0).to(boxes.device) * s

    w = w * (1.0 + u(ratio))
    h = h * (1.0 + u(ratio))
    cx = cx + w * u(shift_x)
    cy = cy + h * u(shift_y)
    s = 1.0 + u(scale)
    w, h = w * s, h * s
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def _sigmoid_focal(logits, targets, gamma, alpha):
    p = torch.sigmoid(logits.float())
    ce = -(targets * F.logsigmoid(logits) + (1 - targets) * F.logsigmoid(-logits))
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return a_t * ce * (1 - p_t) ** gamma


def _softmax_focal(logits, labels, gamma, alpha):
    logp = F.log_softmax(logits.float(), dim=-1)
    lp = logp.gather(-1, labels[..., None])[..., 0]
    return -alpha * (1 - torch.exp(lp)) ** gamma * lp


def stal_loss(logits, labels, box_mask, cfg: STALConfig, *,
              pose_weight=1.2, object_weight=0.5, person_weight=0.5):
    """AVA three-group loss (loss.py:41-78): softmax focal over the pose
    block (argmax of the multi-hot slice, as the reference does) +
    per-group sigmoid focal means, each summed over boxes and divided by
    the average per-clip box count. Padded boxes contribute nothing."""
    np_, no, nper = cfg.num_pose, cfg.num_object, cfg.num_person
    valid = box_mask.float()
    avg_box_num = torch.clamp(valid.sum() / logits.shape[0], min=1.0)

    out = {}
    total = 0.0
    if np_ > 0:
        pose_label = torch.argmax(labels[..., :np_], dim=-1)
        pose = _softmax_focal(logits[..., :np_], pose_label, cfg.focal_gamma, cfg.focal_alpha)
        out["loss_pose_action"] = (pose * valid).sum() / avg_box_num
        total = total + pose_weight * out["loss_pose_action"]
    if no > 0:
        obj = _sigmoid_focal(logits[..., np_:np_ + no], labels[..., np_:np_ + no].float(),
                             cfg.focal_gamma, cfg.focal_alpha).mean(dim=-1)
        out["loss_object_interaction"] = (obj * valid).sum() / avg_box_num
        total = total + object_weight * out["loss_object_interaction"]
    if nper > 0:
        per = _sigmoid_focal(logits[..., np_ + no:], labels[..., np_ + no:].float(),
                             cfg.focal_gamma, cfg.focal_alpha).mean(dim=-1)
        out["loss_person_interaction"] = (per * valid).sum() / avg_box_num
        total = total + person_weight * out["loss_person_interaction"]
    return total, out
