"""Transformer building blocks of the InternVideo2 encoder.

Port of internvideo_tpu/nn/transformer.py: DropPath, LayerScale with an
fp32 gamma, Mlp, self-Attention with a flat qkv projection and whole-dim
QK-RMSNorm (one (D,) weight across all heads, applied before the split into
heads), the pre-norm Block with RMSNorm or LayerNorm (`norm_type`, the
VideoMAE teacher's), CrossAttention (optionally returning its head-averaged
attention) and the mean-query AttentionPoolingBlock. The residual stream
stays in the activation dtype.

With RMSNorm QK normalization, Attention first offers the flat projection
to the fused qkv + QK-RMSNorm + attention op (ops/attention.py
`fused_qkv_attention_or_none`, kernel K3), as the JAX module does
(transformer.py:151-167); where that declines it runs the unfused chain.

`quant="int8"` (serving) builds the qkv, proj, fc1 and fc2 projections as
`ops/quant.py:Int8Dense` (int8 weights, activations quantized per row by
K7), as the JAX `_dense(quant=)` does (:29-38); the pooling head stays
dense.

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
from internvideo_tpu_torch.ops.attention import (
    dot_product_attention,
    fused_qkv_attention_or_none,
)
from internvideo_tpu_torch.ops.quant import serving_dense


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
                 quant: Optional[str] = None, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if act not in _ACTS:
            raise ValueError(f"unknown mlp act {act!r}; one of {list(_ACTS)}")
        self.act = _ACTS[act]
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.fc1 = serving_dense(quant, dim, hidden_dim, **kw)
        self.fc2 = serving_dense(quant, hidden_dim, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


def _make_norm(norm_type: str, dim: int, dtype: torch.dtype, device,
               eps: Optional[float] = None) -> nn.Module:
    """transformer.py:115-123: RMSNorm, or LayerNorm with eps 1e-6 (the
    timm / VideoMAE convention) unless `eps` is given."""
    if norm_type == "rmsnorm":
        return RMSNorm(dim, dtype=dtype, device=device)
    if norm_type == "layernorm":
        return LayerNorm(dim, eps=1e-6 if eps is None else eps, dtype=dtype, device=device)
    raise ValueError(f"unknown norm_type {norm_type!r}")


class Attention(nn.Module):
    """Self-attention with optional whole-dim QK normalization."""

    def __init__(self, dim: int, num_heads: int, *, qkv_bias: bool = False,
                 qk_normalization: bool = True, attn_impl: str = "auto",
                 norm_type: str = "rmsnorm", norm_eps: Optional[float] = None,
                 quant: Optional[str] = None, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.norm_type = norm_type
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.qkv = serving_dense(quant, dim, 3 * dim, bias=qkv_bias, **kw)
        if qk_normalization:
            self.q_norm = _make_norm(norm_type, dim, dtype, device, norm_eps)
            self.k_norm = _make_norm(norm_type, dim, dtype, device, norm_eps)
        else:
            self.q_norm = self.k_norm = None
        self.proj = serving_dense(quant, dim, dim, **kw)

    def _split(self, qkv: torch.Tensor):
        """Flat (B, S, 3D) projection -> q, k, v as (B, S, H, D/H). v (and
        q, k without QK norm) are views into it, no copy."""
        d = qkv.shape[-1] // 3
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        heads = (self.num_heads, d // self.num_heads)
        return q.unflatten(-1, heads), k.unflatten(-1, heads), v.unflatten(-1, heads)

    def project_qkv(self, x: torch.Tensor):
        """(B, S, D) -> the q, k, v the unfused chain gives attention."""
        return self._split(self.qkv(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.qkv(x)
        if self.q_norm is not None and self.norm_type == "rmsnorm":
            fused = fused_qkv_attention_or_none(
                qkv, self.q_norm.weight, self.k_norm.weight, num_heads=self.num_heads,
                eps=self.q_norm.eps, impl=self.attn_impl)
            if fused is not None:
                return self.proj(fused)
        out = dot_product_attention(*self._split(qkv), impl=self.attn_impl)
        return self.proj(out.flatten(-2))


class Block(nn.Module):
    """Pre-norm transformer block: norm -> attn -> LayerScale -> DropPath,
    then norm -> MLP -> LayerScale -> DropPath, each added to the residual
    in `dtype`. `norm_type` "rmsnorm" (InternVideo2) or "layernorm" (the
    VideoMAE teacher; eps 1e-6 unless `norm_eps`); `quant="int8"` serving
    projections."""

    def __init__(self, dim: int, num_heads: int, *, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, qk_normalization: bool = True,
                 init_values: Optional[float] = 1e-5, drop_path: float = 0.0,
                 attn_impl: str = "auto", mlp_act: str = "gelu",
                 norm_type: str = "rmsnorm", norm_eps: Optional[float] = None,
                 quant: Optional[str] = None, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.drop_path = drop_path
        kw = dict(quant=quant, dtype=dtype, param_dtype=param_dtype, device=device)
        self.norm1 = _make_norm(norm_type, dim, dtype, device, norm_eps)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias,
                              qk_normalization=qk_normalization, attn_impl=attn_impl,
                              norm_type=norm_type, norm_eps=norm_eps, **kw)
        self.norm2 = _make_norm(norm_type, dim, dtype, device, norm_eps)
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
    """Q from one stream, K/V from another (transformer.py:248-296). With
    `return_attn=True` it runs the attention itself in fp32 (logits with
    fp32 accumulation, fp32 softmax, probabilities cast to v's dtype before
    PV) and also returns the head-averaged probabilities (B, nq, nk): the
    teacher's pooling attention that drives attention-guided masking."""

    def __init__(self, dim: int, num_heads: int, *, out_dim: Optional[int] = None,
                 qkv_bias: bool = False, attn_impl: str = "auto",
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.q = Dense(dim, dim, bias=qkv_bias, **kw)
        self.k = Dense(dim, dim, bias=qkv_bias, **kw)
        self.v = Dense(dim, dim, bias=qkv_bias, **kw)
        self.proj = Dense(dim, out_dim or dim, **kw)

    def forward(self, x_q, x_k, x_v, return_attn: bool = False):
        d = x_q.shape[-1]
        heads = (self.num_heads, d // self.num_heads)
        q = self.q(x_q).unflatten(-1, heads)
        k = self.k(x_k).unflatten(-1, heads)
        v = self.v(x_v).unflatten(-1, heads)
        attn = None
        if return_attn:
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * heads[1] ** -0.5
            probs = torch.softmax(logits, dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
            out = out.to(self.dtype)
            attn = probs.mean(dim=1)  # (B, nq, nk)
        else:
            out = dot_product_attention(q, k, v, impl=self.attn_impl)
        out = self.proj(out.flatten(-2))
        return (out, attn) if return_attn else out


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

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        """(B, out_dim), and with `return_attn` also the pooling attention
        over the tokens, (B, N)."""
        x_q = self.norm1_q(x.mean(dim=1, keepdim=True))
        out = self.cross_attn(x_q, self.norm1_k(x), self.norm1_v(x), return_attn=return_attn)
        if return_attn:
            out, attn = out
            return out[:, 0], attn[:, 0]
        return out[:, 0]
