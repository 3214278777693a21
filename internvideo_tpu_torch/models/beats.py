"""The BEATs audio encoder: PyTorch port.

Port of internvideo_tpu/models/beats.py :1-209 (`BEATsConfig`,
`_relative_position_bucket`, `BEATsSelfAttention`, `BEATsLayer`,
`BEATsEncoder`), the checkpoint-faithful audio tower of the audio-visual
stage-2 model (`audio_tower="beats"`):

  * a 16 x 16 / 16 spectrogram patch convolution without bias, with the
    JAX module's SAME padding: a time axis that does not tile by 16 is
    padded on both sides (998 frames -> 5 + 5 -> 63 time patches), where
    the reference's torch Conv2d has none (62; ROADMAP queue 3);
    LayerNorm, then `post_extract_proj` to the encoder width;
  * a grouped Conv1d position embedding (kernel 128, 16 groups, padding 64,
    the last step trimmed), exact GELU, added to the tokens, then
    `encoder_layer_norm`;
  * post-norm layers with deep-norm residuals (x * (2L)^(1/4) + branch) and
    a T5-style bucketed relative position bias that only layer 0 owns and
    every later layer reuses, gated per (batch, head, query) from the raw
    query by `grep_linear` (8 outputs summed in pairs of 4) and `grep_a`;
  * the mean over the tokens as the pooled output.

Attention here is JAX's XLA attention, not a Pallas kernel, so it stays
plain torch: fp32 scores of fp32-widened q and k, the gated bias added in
fp32, an fp32 softmax, probabilities cast to the activation dtype, the PV
product in fp32, cast back. The LayerNorms are flax `nn.LayerNorm`'s (eps
1e-6, variance as E[x^2] - E[x]^2 in fp32). Submodules carry the flax
names, so models/convert.py maps a JAX tree onto them. BEATs' acoustic
tokenizer and quantizer (the JAX module's :210-341) are not ported
(ROADMAP queue 1, item 10).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from internvideo_tpu_torch.nn.dense import Dense, lecun_normal_std, trunc_normal_


@dataclasses.dataclass(frozen=True)
class BEATsConfig:
    """Same fields and defaults as internvideo_tpu's BEATsConfig (the
    BEATs_iter3 release geometry)."""

    input_patch_size: int = 16
    embed_dim: int = 512
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_layers: int = 12
    encoder_attention_heads: int = 12
    conv_pos: int = 128
    conv_pos_groups: int = 16
    num_buckets: int = 320
    max_distance: int = 800
    dtype: str = "float32"
    param_dtype: str = "float32"


def _relative_position_bucket(rel: torch.Tensor, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """Bidirectional T5 bucketing of the (S, S) int offsets `rel`."""
    nb = num_buckets // 2
    out = torch.where(rel > 0, nb, 0)
    rel = rel.abs()
    max_exact = nb // 2
    # clamped below at 1: log(0) is only ever masked by `rel < max_exact`
    large = max_exact + (
        torch.log(rel.clamp_min(1).float() / max_exact)
        / math.log(max_distance / max_exact) * (nb - max_exact)
    ).to(torch.int64)
    large = torch.clamp(large, max=nb - 1)
    return out + torch.where(rel < max_exact, rel, large)


def same_padding(n: int, p: int) -> tuple[int, int]:
    """(low, high) padding of a stride-`p`, kernel-`p` convolution over `n`
    steps under XLA's "SAME" rule: ceil(n / p) outputs, the total split
    with the extra step on the high side."""
    total = max((-(-n // p) - 1) * p + p - n, 0)
    return total // 2, total - total // 2


class FlaxLayerNorm(nn.Module):
    """flax `nn.LayerNorm` (eps 1e-6): fp32 statistics with the variance as
    max(E[x^2] - E[x]^2, 0), (x - mean) * (rsqrt(var + eps) * scale) + bias,
    cast to `dtype`."""

    def __init__(self, dim: int, *, eps: float = 1e-6, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf.square().mean(dim=-1, keepdim=True) - mean.square()).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(self.dtype)


class Conv(nn.Module):
    """flax `nn.Conv` as BEATs uses it: the weight (and bias) stored in
    `param_dtype`, torch's (out, in / groups, *kernel) layout, the product
    in `dtype`. 1-D or 2-D by the weight's rank."""

    def __init__(self, weight_shape: tuple, *, bias: bool, stride: int = 1, padding: int = 0,
                 groups: int = 1, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.stride, self.padding, self.groups, self.dtype = stride, padding, groups, dtype
        self.weight = nn.Parameter(torch.empty(weight_shape, dtype=param_dtype, device=device))
        self.bias = (nn.Parameter(torch.empty(weight_shape[0], dtype=param_dtype, device=device))
                     if bias else None)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """lecun_normal over fan_in = in / groups x the kernel size (flax's
        Conv default), zero bias."""
        trunc_normal_(self.weight, lecun_normal_std(math.prod(self.weight.shape[1:])), generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = F.conv2d if self.weight.dim() == 4 else F.conv1d
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return conv(x.to(self.dtype), self.weight.to(self.dtype), bias, stride=self.stride,
                    padding=self.padding, groups=self.groups)


def _kw(cfg: BEATsConfig, device) -> dict:
    return dict(dtype=getattr(torch, cfg.dtype), param_dtype=getattr(torch, cfg.param_dtype),
                device=device)


class BEATsSelfAttention(nn.Module):
    """Self-attention with the gated relative position bias. Only the layer
    with `has_rel_bias` owns `relative_attention_bias` (num_buckets, H);
    the others take the bias it computed."""

    def __init__(self, cfg: BEATsConfig, has_rel_bias: bool = False, *, device):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.encoder_embed_dim, cfg.encoder_attention_heads
        kw = _kw(cfg, device)
        self.dtype = kw["dtype"]
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            Dense(d, d, init_std=lecun_normal_std(d), **kw) for _ in range(4))
        self.relative_attention_bias = (
            nn.Parameter(torch.empty(cfg.num_buckets, h, dtype=kw["param_dtype"],
                                     device=device)) if has_rel_bias else None)
        self.grep_linear = Dense(d // h, 8, init_std=lecun_normal_std(d // h), **kw)
        self.grep_a = nn.Parameter(torch.ones(1, h, 1, 1, dtype=kw["param_dtype"],
                                              device=device))

    def position_bias(self, s: int) -> torch.Tensor:
        """(H, S, S): the bias table at the bucket of each key - query
        offset."""
        pos = torch.arange(s, device=self.relative_attention_bias.device)
        buckets = _relative_position_bucket(pos[None, :] - pos[:, None], self.cfg.num_buckets,
                                            self.cfg.max_distance)
        return self.relative_attention_bias[buckets].permute(2, 0, 1)

    def forward(self, x: torch.Tensor, pos_bias: Optional[torch.Tensor] = None):
        b, s, d = x.shape
        heads = (self.cfg.encoder_attention_heads, d // self.cfg.encoder_attention_heads)
        q = self.q_proj(x).unflatten(-1, heads)
        k = self.k_proj(x).unflatten(-1, heads)
        v = self.v_proj(x).unflatten(-1, heads)
        if pos_bias is None and self.relative_attention_bias is not None:
            pos_bias = self.position_bias(s)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * heads[1] ** -0.5
        if pos_bias is not None:
            g = self.grep_linear(q).reshape(b, s, heads[0], 2, 4).sum(-1)
            g = torch.sigmoid(g.float())  # (B, S, H, 2)
            gate_a = g[..., 0].transpose(1, 2)[..., None]  # (B, H, S, 1)
            gate_b = g[..., 1].transpose(1, 2)[..., None]
            gate = gate_a * (gate_b * self.grep_a.float() - 1.0) + 2.0
            scores = scores + gate * pos_bias.float()[None]
        p = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p.to(self.dtype).float(), v.float())
        return self.out_proj(out.to(self.dtype).reshape(b, s, d)), pos_bias


class BEATsLayer(nn.Module):
    """Post-norm deep-norm layer: LN(x * alpha + attn(x)), then
    LN(x * alpha + fc2(gelu(fc1(x)))), alpha = (2 L)^(1/4)."""

    def __init__(self, cfg: BEATsConfig, has_rel_bias: bool = False, *, device):
        super().__init__()
        d, f = cfg.encoder_embed_dim, cfg.encoder_ffn_embed_dim
        kw = _kw(cfg, device)
        self.alpha = (2 * cfg.encoder_layers) ** 0.25
        self.self_attn = BEATsSelfAttention(cfg, has_rel_bias, device=device)
        self.self_attn_layer_norm = FlaxLayerNorm(d, **kw)
        self.fc1 = Dense(d, f, init_std=lecun_normal_std(d), **kw)
        self.fc2 = Dense(f, d, init_std=lecun_normal_std(f), **kw)
        self.final_layer_norm = FlaxLayerNorm(d, **kw)

    def forward(self, x: torch.Tensor, pos_bias: Optional[torch.Tensor] = None):
        attn_out, pos_bias = self.self_attn(x, pos_bias)
        x = self.self_attn_layer_norm(x * self.alpha + attn_out)
        h = self.fc2(F.gelu(self.fc1(x)))
        return self.final_layer_norm(x * self.alpha + h), pos_bias


class BEATsEncoder(nn.Module):
    """fbank (B, frames, n_mels) -> (tokens (B, N, encoder_embed_dim),
    pooled (B, encoder_embed_dim)); N = ceil(frames / p) * ceil(n_mels / p)
    (SAME padding), time-major."""

    def __init__(self, config: BEATsConfig, *, device, generator: torch.Generator):
        super().__init__()
        self.config = cfg = config
        kw = _kw(cfg, device)
        self.dtype = kw["dtype"]
        p, e, d = cfg.input_patch_size, cfg.embed_dim, cfg.encoder_embed_dim
        self.patch_embedding = Conv((e, 1, p, p), bias=False, stride=p, **kw)
        self.layer_norm = FlaxLayerNorm(e, **kw)
        self.post_extract_proj = Dense(e, d, init_std=lecun_normal_std(e), **kw)
        self.pos_conv = Conv((d, d // cfg.conv_pos_groups, cfg.conv_pos), bias=True,
                             padding=cfg.conv_pos // 2, groups=cfg.conv_pos_groups, **kw)
        self.encoder_layer_norm = FlaxLayerNorm(d, **kw)
        self.layers = nn.ModuleList(BEATsLayer(cfg, i == 0, device=device)
                                    for i in range(cfg.encoder_layers))
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init in module order: lecun-normal Dense and Conv weights,
        zero biases, normal(0.02) relative-bias table; norms and `grep_a`
        keep their ones / zeros."""
        for m in self.modules():
            if isinstance(m, (Dense, Conv)):
                m.init_weights(generator)
            elif isinstance(m, BEATsSelfAttention) and m.relative_attention_bias is not None:
                t = m.relative_attention_bias
                t.copy_(torch.randn(t.shape, generator=generator, device=t.device) * 0.02)

    def forward(self, fbank: torch.Tensor):
        cfg = self.config
        p = cfg.input_patch_size
        b, frames, mels = fbank.shape
        (t0, t1), (m0, m1) = same_padding(frames, p), same_padding(mels, p)
        x = F.pad(fbank[:, None].to(self.dtype), (m0, m1, t0, t1))
        x = self.patch_embedding(x).flatten(2).transpose(1, 2)  # (B, N, E), time-major
        x = self.post_extract_proj(self.layer_norm(x))
        pc = self.pos_conv(x.transpose(1, 2))
        if cfg.conv_pos % 2 == 0:
            pc = pc[..., :-1]
        x = x + F.gelu(pc.transpose(1, 2))
        x = self.encoder_layer_norm(x)
        pos_bias = None
        for layer in self.layers:
            x, pos_bias = layer(x, pos_bias)
        return x, x.mean(dim=1)
