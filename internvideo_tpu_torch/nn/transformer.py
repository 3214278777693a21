"""Transformer building blocks of the InternVideo2 encoder.

Port of internvideo_tpu/nn/transformer.py: DropPath, LayerScale with an
fp32 gamma, Mlp, self-Attention with a flat qkv projection and whole-dim
QK-RMSNorm (one (D,) weight across all heads, applied before the split into
heads), the pre-norm Block, CrossAttention and the mean-query
AttentionPoolingBlock. The residual stream stays in the activation dtype.

DropPath takes its per-sample keep mask as a tensor instead of drawing it:
the caller draws every block's masks before the blocks run, so that a
recomputed (checkpointed) block reuses the same mask.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from internvideo_tpu_torch.nn.dense import Dense
from internvideo_tpu_torch.nn.norms import LayerNorm, RMSNorm
from internvideo_tpu_torch.ops.attention import dot_product_attention


class DropPath(nn.Module):
    """Per-sample stochastic depth (transformer.py:51-64): where `keep` is
    False the sample's branch is zeroed, elsewhere it is scaled by
    1 / (1 - rate), in x's dtype. Identity when the rate is 0 or no mask is
    given (deterministic)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.rate == 0.0 or keep is None:
            return x
        mask = keep.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
        return torch.where(mask, x / (1.0 - self.rate), torch.zeros_like(x))


def draw_keep_masks(rates, batch: int, generator: torch.Generator) -> torch.Tensor:
    """(len(rates), 2, batch) bool: the keep masks of each block's two
    DropPaths, Bernoulli(1 - rate), drawn in one call on the generator's
    device."""
    u = torch.rand((len(rates), 2, batch), generator=generator, device=generator.device)
    keep = 1.0 - torch.tensor(rates, dtype=torch.float32, device=u.device)
    return u < keep[:, None, None]


class LayerScale(nn.Module):
    """gamma * x in fp32, cast back to `dtype` (transformer.py:67-83)."""

    def __init__(self, dim: int, init_value: float = 1e-5, *,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.gamma = nn.Parameter(
            torch.full((dim,), init_value, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x.float() * self.gamma).to(self.dtype)


_ACTS = {
    "gelu": lambda x: F.gelu(x),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),  # flax approximate=True
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
}


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, *, act: str = "gelu",
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if act not in _ACTS:
            raise ValueError(f"unknown mlp act {act!r}; one of {list(_ACTS)}")
        self.act = _ACTS[act]
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.fc1 = Dense(dim, hidden_dim, **kw)
        self.fc2 = Dense(hidden_dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class Attention(nn.Module):
    """Self-attention with optional whole-dim QK RMSNorm."""

    def __init__(self, dim: int, num_heads: int, *, qkv_bias: bool = False,
                 qk_normalization: bool = True, attn_impl: str = "auto",
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, **kw)
        if qk_normalization:
            self.q_norm = RMSNorm(dim, dtype=dtype, device=device)
            self.k_norm = RMSNorm(dim, dtype=dtype, device=device)
        else:
            self.q_norm = self.k_norm = None
        self.proj = Dense(dim, dim, **kw)

    def project_qkv(self, x: torch.Tensor):
        """(B, S, D) -> q, k, v as (B, S, H, D/H). v (and q, k without QK
        norm) are views into the flat (B, S, 3D) projection, no copy."""
        d = x.shape[-1]
        qkv = self.qkv(x)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        heads = (self.num_heads, d // self.num_heads)
        return q.unflatten(-1, heads), k.unflatten(-1, heads), v.unflatten(-1, heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.project_qkv(x)
        out = dot_product_attention(q, k, v, impl=self.attn_impl)
        return self.proj(out.flatten(-2))


class Block(nn.Module):
    """Pre-norm transformer block: RMSNorm -> attn -> LayerScale -> DropPath,
    then RMSNorm -> MLP -> LayerScale -> DropPath, each added to the
    residual in `dtype`."""

    def __init__(self, dim: int, num_heads: int, *, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_normalization: bool = True,
                 init_values: Optional[float] = 1e-5, drop_path: float = 0.0,
                 attn_impl: str = "auto", mlp_act: str = "gelu",
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.drop_path = drop_path
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.norm1 = RMSNorm(dim, dtype=dtype, device=device)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias,
                              qk_normalization=qk_normalization,
                              attn_impl=attn_impl, **kw)
        self.norm2 = RMSNorm(dim, dtype=dtype, device=device)
        # int(), exactly as transformer.py:235: 1408 * 48 / 11 -> 6144
        self.mlp = Mlp(dim, int(dim * mlp_ratio), act=mlp_act, **kw)
        if init_values:
            self.ls1 = LayerScale(dim, init_values, dtype=dtype, device=device)
            self.ls2 = LayerScale(dim, init_values, dtype=dtype, device=device)
        else:
            self.ls1 = self.ls2 = nn.Identity()
        self.droppath1 = DropPath(drop_path)
        self.droppath2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`keep`: (2, B) bool keep masks of the two DropPaths
        (`draw_keep_masks`); needed when not deterministic and drop_path > 0."""
        if deterministic or self.drop_path == 0.0:
            keep = None
        elif keep is None:
            raise ValueError("Block with drop_path > 0 in training needs its keep masks")
        k1, k2 = (None, None) if keep is None else keep
        x = x + self.droppath1(self.ls1(self.attn(self.norm1(x))), k1)
        return x + self.droppath2(self.ls2(self.mlp(self.norm2(x))), k2)


class CrossAttention(nn.Module):
    """Q from one stream, K/V from another (transformer.py:248-296).
    `return_attn` is not ported yet (ROADMAP queue 1, item 2)."""

    def __init__(self, dim: int, num_heads: int, *, out_dim: Optional[int] = None,
                 qkv_bias: bool = False, attn_impl: str = "auto",
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.q = Dense(dim, dim, bias=qkv_bias, **kw)
        self.k = Dense(dim, dim, bias=qkv_bias, **kw)
        self.v = Dense(dim, dim, bias=qkv_bias, **kw)
        self.proj = Dense(dim, out_dim or dim, **kw)

    def forward(self, x_q, x_k, x_v) -> torch.Tensor:
        d = x_q.shape[-1]
        heads = (self.num_heads, d // self.num_heads)
        q = self.q(x_q).unflatten(-1, heads)
        k = self.k(x_k).unflatten(-1, heads)
        v = self.v(x_v).unflatten(-1, heads)
        out = dot_product_attention(q, k, v, impl=self.attn_impl)
        return self.proj(out.flatten(-2))


class AttentionPoolingBlock(nn.Module):
    """Mean-query attention pooling head (transformer.py:299-330): the query
    is the sequence mean; q/k/v inputs go through separate LayerNorms (eps
    1e-5), then one biased cross-attention gives one pooled vector."""

    def __init__(self, dim: int, num_heads: int, out_dim: int, *,
                 attn_impl: str = "auto", dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.norm1_q = LayerNorm(dim, eps=1e-5, dtype=dtype, device=device)
        self.norm1_k = LayerNorm(dim, eps=1e-5, dtype=dtype, device=device)
        self.norm1_v = LayerNorm(dim, eps=1e-5, dtype=dtype, device=device)
        self.cross_attn = CrossAttention(
            dim, num_heads, out_dim=out_dim, qkv_bias=True, attn_impl=attn_impl,
            dtype=dtype, param_dtype=param_dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_q = self.norm1_q(x.mean(dim=1, keepdim=True))
        out = self.cross_attn(x_q, self.norm1_k(x), self.norm1_v(x))
        return out[:, 0]
