"""Focal losses (sigmoid + softmax) in fp32, elementwise torch.

Port of internvideo_tpu/ops/losses.py, which replaces the alphaction CUDA
focal-loss kernels (SigmoidFocalLoss_cuda.cu, SoftmaxFocalLoss_cuda.cu) by
elementwise math; there is no Pallas kernel, so this is plain torch too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(
    logits: torch.Tensor,  # (N, C)
    targets: torch.Tensor,  # (N,) int class ids in [1, C]; 0 = background
    *,
    gamma: float = 2.0,
    alpha: float = 0.25,
) -> torch.Tensor:
    """Per-element focal loss summed over classes, mean over N (the CUDA
    kernel's class-id convention: class c at column c-1; a negative target
    is ignored)."""
    n, c = logits.shape
    cls = torch.arange(1, c + 1, device=logits.device)[None]
    pos = cls == targets[:, None]
    neg = (~pos) & (targets[:, None] >= 0)
    x = logits.float()
    p = torch.sigmoid(x)
    loss_pos = -((1 - p) ** gamma) * F.logsigmoid(x) * alpha
    loss_neg = -(p ** gamma) * F.logsigmoid(-x) * (1 - alpha)
    loss = torch.where(pos, loss_pos, 0.0) + torch.where(neg, loss_neg, 0.0)
    return loss.sum() / n


def softmax_focal_loss(
    logits: torch.Tensor,  # (N, C): column 0 is background
    targets: torch.Tensor,  # (N,) int in [0, C)
    *,
    gamma: float = 2.0,
    alpha: float = 0.25,
) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    logpt = logp.gather(-1, targets[:, None].long())[:, 0]
    pt = torch.exp(logp).gather(-1, targets[:, None].long())[:, 0]
    a = torch.where(targets > 0, alpha, 1 - alpha)
    return (-a * ((1 - pt) ** gamma) * logpt).mean()
