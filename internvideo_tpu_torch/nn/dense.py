"""Dense layer and the seeded initializers the port's modules share.

`Dense` is the counterpart of flax `nn.Dense` as the JAX package uses it
(internvideo_tpu/nn/transformer.py:29 `_dense`): the weight is stored in
`param_dtype`, and input, weight and bias are cast to `dtype` for the
product. The weight is torch's (out, in); models/convert.py transposes the
flax (in, out) kernel into it.

Parameters are created empty and filled by `init_weights(generator)`, so
a model's initialisation depends only on the explicit torch.Generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_LECUN_TRUNC_CORRECTION = 0.87962566103423978  # std of N(0,1) truncated to [-2, 2]


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """Fill `t` with a standard normal truncated to [-2, 2], times `std`
    (flax `initializers.truncated_normal(std)`). Sampled in fp32 on t's
    device, then cast to t's dtype."""
    lo, hi = (math.erf(x / math.sqrt(2.0)) for x in (-2.0, 2.0))
    tmp = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    tmp.uniform_(lo, hi, generator=generator).erfinv_().mul_(math.sqrt(2.0))
    tmp.clamp_(-2.0, 2.0).mul_(std)
    return t.copy_(tmp)


@torch.no_grad()
def xavier_uniform_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill the (out, in) weight `t` from U(-a, a), a = sqrt(6 / (in + out))
    (flax `initializers.xavier_uniform()`), sampled in fp32 on t's device."""
    a = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    tmp = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    return t.copy_(tmp.uniform_(-a, a, generator=generator))


def lecun_normal_std(fan_in: int) -> float:
    """std for flax `initializers.lecun_normal()` (truncated-normal variance
    scaling, fan_in mode)."""
    return math.sqrt(1.0 / fan_in) / _LECUN_TRUNC_CORRECTION


class Dense(nn.Module):
    """`init_std`: the truncated-normal std of the weight, or
    "xavier_uniform" (the pretrain decoders' init)."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32,
                 init_std: float | str = 0.02, device=None):
        super().__init__()
        self.dtype = dtype
        self.init_std = init_std
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, dtype=param_dtype, device=device))
        self.bias = (
            nn.Parameter(torch.empty(out_features, dtype=param_dtype, device=device))
            if bias else None
        )

    def init_weights(self, generator: torch.Generator) -> None:
        if self.init_std == "xavier_uniform":
            xavier_uniform_(self.weight, generator)
        else:
            trunc_normal_(self.weight, self.init_std, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)
