"""Normalization layers (fp32 weights and fp32 math whatever the activation
dtype). Port of internvideo_tpu/nn/norms.py."""

from __future__ import annotations

import torch
from torch import nn

from internvideo_tpu_torch.ops.rmsnorm import rms_norm


class RMSNorm(nn.Module):
    """RMSNorm with fp32 variance math and an fp32 `weight`
    (internvideo_tpu/nn/norms.py:12-30)."""

    def __init__(self, dim: int, *, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, eps=self.eps).to(self.dtype)


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32 and cast to `dtype`; fp32 `weight`/`bias`
    (the JAX `scale`/`bias`, internvideo_tpu/nn/norms.py:33-61)."""

    def __init__(self, dim: int, *, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(self.dtype)
