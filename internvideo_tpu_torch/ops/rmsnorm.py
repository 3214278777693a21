"""RMSNorm in plain PyTorch.

Port of internvideo_tpu/ops/rmsnorm.py:27 `rms_norm`, which the JAX package
leaves to XLA. Variance math is fp32 whatever the input dtype; the normed
value is cast to x's dtype, multiplied by the (fp32) weight, and cast to
x's dtype again: two roundings in bf16, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    *,
    eps: float = 1e-6,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """RMSNorm over the last dim; optionally adds `residual` into x first."""
    if residual is not None:
        x = x + residual
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (weight * normed.to(x.dtype)).to(x.dtype)
