"""Rotary position embeddings: 1D RoPE (with YaRN) and 3D mRoPE.

Port of internvideo_tpu/nn/rope.py. mRoPE follows the Qwen3-VL scheme: the
head_dim/2 frequency slots are split into (temporal, height, width)
sections, each driven by its own position stream; text tokens use the same
position on all three streams, which reduces to 1D RoPE.

Convention: rotate-half (HF/LLaMA style): cos/sin hold the half-frequencies
repeated twice, x is split in halves. Angles, cos and sin are fp32;
`apply_rope` rotates in fp32 and casts back to x's dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class YarnConfig:
    """YaRN long-context frequency rescaling (the DeepSeek-V3 recipe)."""

    factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 1.0


def _yarn_mscale(scale: float, mscale: float) -> float:
    if scale <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def rope_freqs(dim: int, theta: float = 10000.0, yarn: Optional[YarnConfig] = None,
               device=None) -> torch.Tensor:
    """(dim/2,) fp32 inverse frequencies; with `yarn`, NTK-by-parts rescaled
    (high-frequency slots extrapolate, low-frequency slots interpolate by
    `factor`, a linear ramp between)."""
    exponents = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    inv = 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device) ** exponents)
    if yarn is None:
        return inv

    def correction_dim(num_rotations: float) -> float:
        return (dim * math.log(yarn.original_max_position_embeddings
                               / (num_rotations * 2 * math.pi)) / (2 * math.log(theta)))

    low = max(math.floor(correction_dim(yarn.beta_fast)), 0)
    high = min(math.ceil(correction_dim(yarn.beta_slow)), dim // 2 - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / max(high - low, 1e-3)).clamp(0.0, 1.0)
    extrapolation_factor = 1.0 - ramp  # 1 at high-freq slots, 0 at low-freq
    return inv / yarn.factor * (1.0 - extrapolation_factor) + inv * extrapolation_factor


def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float = 10000.0,
                 yarn: Optional[YarnConfig] = None):
    """cos/sin of shape (..., S, dim): half-frequencies tiled twice."""
    inv = rope_freqs(dim, theta, yarn, device=positions.device)
    angles = positions[..., None].float() * inv  # (..., S, dim/2)
    angles = torch.cat([angles, angles], dim=-1)
    cos, sin = torch.cos(angles), torch.sin(angles)
    if yarn is not None:
        m = _yarn_mscale(yarn.factor, yarn.mscale) / _yarn_mscale(yarn.factor,
                                                                   yarn.mscale_all_dim)
        cos, sin = cos * m, sin * m
    return cos, sin


def mrope_cos_sin(positions: torch.Tensor, dim: int, sections: Sequence[int],
                  theta: float = 10000.0):
    """Multi-axis RoPE over (3, ..., S) (t, h, w) position streams:
    frequency slots are partitioned among the 3 axes by `sections` (sum
    dim/2)."""
    if sum(sections) != dim // 2:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to dim/2 = {dim // 2}")
    inv = rope_freqs(dim, theta, device=positions.device)  # (dim/2,)
    angles = positions[..., None].float() * inv  # (3, ..., S, dim/2)
    slot_axis = torch.repeat_interleave(torch.arange(3, device=positions.device),
                                        torch.tensor(list(sections), device=positions.device))
    picked = torch.gather(angles, 0, slot_axis.expand(1, *angles.shape[1:]))[0]
    picked = torch.cat([picked, picked], dim=-1)
    return torch.cos(picked), torch.sin(picked)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    a, b = x.chunk(2, dim=-1)
    return torch.cat([-b, a], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (B, S, D) or (S, D)."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :].float()
    sin = sin[:, :, None, :].float()
    xf = x.float()
    return (xf * cos + rotate_half(xf) * sin).to(x.dtype)
