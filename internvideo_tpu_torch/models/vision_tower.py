"""InternVideo3 vision tower (SigLIP-style) and its patch-merger projector.

Port of internvideo_tpu/models/vision_tower.py: 1152-d, 27 layers, 16 heads
of 72, gelu-tanh MLP 4304, 16 px patches with temporal patch 2, a learned
48 x 48 position table resampled bilinearly (align-corners) to the input
grid, a 2D rotary embedding over (row, col) at head_dim / 4 frequencies
each, tokens in 2 x 2 merge-block order, deepstack taps after the listed
blocks, and patch mergers (LayerNorm -> concat 2 x 2 -> fc1 -> gelu -> fc2
to the text width; the deepstack mergers norm after the concat).

Attention is per temporal frame: the reference's cu_seqlens give each of
the gt frames its own segment, and every per-token table is the same for
each frame, so the frames are folded into the batch, (B * gt, gh * gw, D),
and attention runs dense at S = gh * gw = 196 (224 px): the small-S kernels
K2 / K4b at head dim 72 on a CUDA tensor. The tower has no remat, as in JAX.

`quant="int8"` (serving) builds each block's qkv, proj, fc1 and fc2 as
`ops/quant.py:Int8Dense` (K7 on the card), as the JAX `_VisionBlock`
(:139-170); the patch embed and the patch mergers stay dense.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from internvideo_tpu_torch.nn.dense import Dense
from internvideo_tpu_torch.nn.norms import LayerNorm
from internvideo_tpu_torch.nn.rope import apply_rope
from internvideo_tpu_torch.ops.attention import dot_product_attention
from internvideo_tpu_torch.ops.quant import serving_dense


@dataclasses.dataclass(frozen=True)
class VisionTowerConfig:
    hidden_size: int = 1152
    num_layers: int = 27
    num_heads: int = 16
    intermediate_size: int = 4304
    patch_size: int = 16
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    pos_embed_grid: int = 48  # sqrt(num_position_embeddings = 2304)
    # taps after 0-indexed block i
    deepstack_indexes: tuple[int, ...] = (8, 16, 24)
    text_hidden_size: int = 4096
    dtype: str = "float32"
    param_dtype: str = "float32"
    attn_impl: str = "auto"
    quant: str | None = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@torch.no_grad()
def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """Fill `t` with N(0, std^2) (flax `initializers.normal(std)`), sampled in
    fp32 on t's device."""
    tmp = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    return t.copy_(tmp.normal_(0.0, std, generator=generator))


def merge_order(gh: int, gw: int, m: int = 2) -> np.ndarray:
    """Row-major (gh * gw) token index in 2 x 2 merge-block order:
    (gh / m, gw / m, m, m)."""
    return np.arange(gh * gw).reshape(gh // m, m, gw // m, m).transpose(0, 2, 1, 3).reshape(-1)


def _vision_rope_tables(gt: int, gh: int, gw: int, head_dim: int, device=None):
    """2D rope cos / sin (gt * gh * gw, head_dim) fp32 for merge-block-ordered
    tokens: row coordinates drive the first head_dim / 4 frequency slots,
    column coordinates the next head_dim / 4, the half table tiled twice
    (rotate-half form). Angles in float64 on the host, as the JAX numpy
    tables."""
    rows, cols = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    order = merge_order(gh, gw)
    r = np.tile(rows.reshape(-1)[order], gt)
    c = np.tile(cols.reshape(-1)[order], gt)
    quarter = head_dim // 4
    inv = 1.0 / (10000.0 ** (np.arange(quarter, dtype=np.float64) / quarter))
    ang = np.concatenate([r[:, None] * inv[None], c[:, None] * inv[None]], axis=1)
    ang = np.concatenate([ang, ang], axis=1)
    return (torch.tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.tensor(np.sin(ang), dtype=torch.float32, device=device))


def _interpolate_pos_embed(table: torch.Tensor, n: int, gh: int, gw: int) -> torch.Tensor:
    """Bilinear resample of the (n * n, D) table to (gh * gw, D), row-major:
    linspace(0, n - 1, g) sample points with floor / ceil gathers, i.e.
    align-corners (not F.interpolate's default half-pixel convention)."""
    def axis(g):
        idx = np.linspace(0, n - 1, g)
        lo = idx.astype(np.int32)
        hi = np.clip(lo + 1, None, n - 1)
        return lo, hi, (idx - lo).astype(np.float32)

    h_lo, h_hi, dh = axis(gh)
    w_lo, w_hi, dw = axis(gw)
    idx = np.stack([(h_lo[:, None] * n + w_lo[None]).reshape(-1),
                    (h_lo[:, None] * n + w_hi[None]).reshape(-1),
                    (h_hi[:, None] * n + w_lo[None]).reshape(-1),
                    (h_hi[:, None] * n + w_hi[None]).reshape(-1)])
    wgt = np.stack([((1 - dh)[:, None] * (1 - dw)[None]).reshape(-1),
                    ((1 - dh)[:, None] * dw[None]).reshape(-1),
                    (dh[:, None] * (1 - dw)[None]).reshape(-1),
                    (dh[:, None] * dw[None]).reshape(-1)])
    gathered = table[torch.from_numpy(idx).long().to(table.device)]  # (4, gh * gw, D)
    return torch.einsum("kgd,kg->gd", gathered,
                        torch.from_numpy(wgt).to(device=table.device, dtype=torch.float32))


class VisionBlock(nn.Module):
    """Pre-norm block: LayerNorm -> qkv -> 2D rope on q, k -> attention ->
    proj; LayerNorm -> fc1 -> gelu-tanh -> fc2 (the JAX `_VisionBlock`)."""

    def __init__(self, cfg: VisionTowerConfig, *, device=None):
        super().__init__()
        dtype, pdtype = getattr(torch, cfg.dtype), getattr(torch, cfg.param_dtype)
        d = cfg.hidden_size
        self.cfg, self.attn_impl = cfg, cfg.attn_impl
        self.norm1 = LayerNorm(d, eps=1e-6, dtype=dtype, device=device)
        dense = lambda i, o: serving_dense(cfg.quant, i, o, dtype=dtype,  # noqa: E731
                                           param_dtype=pdtype, device=device)
        self.qkv = dense(d, 3 * d)
        self.proj = dense(d, d)
        self.norm2 = LayerNorm(d, eps=1e-6, dtype=dtype, device=device)
        self.fc1 = dense(d, cfg.intermediate_size)
        self.fc2 = dense(cfg.intermediate_size, d)

    def forward(self, x, cos, sin):
        cfg = self.cfg
        b, s, d = x.shape
        qkv = self.qkv(self.norm1(x)).reshape(b, s, 3, cfg.num_heads, cfg.head_dim)
        q = apply_rope(qkv[:, :, 0], cos, sin)
        k = apply_rope(qkv[:, :, 1], cos, sin)
        attn = dot_product_attention(q, k, qkv[:, :, 2], impl=self.attn_impl)
        x = x + self.proj(attn.reshape(b, s, d))
        h = F.gelu(self.fc1(self.norm2(x)), approximate="tanh")
        return x + self.fc2(h)


class PatchMerger(nn.Module):
    """LayerNorm -> concat each 2 x 2 block -> fc1 -> gelu -> fc2 to the
    text width; with `use_postshuffle_norm` the norm runs after the concat
    (the deepstack mergers)."""

    def __init__(self, cfg: VisionTowerConfig, use_postshuffle_norm: bool = False, *,
                 device=None):
        super().__init__()
        dtype, pdtype = getattr(torch, cfg.dtype), getattr(torch, cfg.param_dtype)
        self.factor = cfg.spatial_merge_size ** 2
        wide = self.factor * cfg.hidden_size
        self.use_postshuffle_norm = use_postshuffle_norm
        self.norm = LayerNorm(wide if use_postshuffle_norm else cfg.hidden_size, eps=1e-6,
                              dtype=dtype, device=device)
        self.linear_fc1 = Dense(wide, wide, dtype=dtype, param_dtype=pdtype, device=device)
        self.linear_fc2 = Dense(wide, cfg.text_hidden_size, dtype=dtype, param_dtype=pdtype,
                                device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        for d in (self.linear_fc1, self.linear_fc2):
            normal_(d.weight, 0.02, generator)
            with torch.no_grad():
                d.bias.zero_()

    def forward(self, x):  # (B, S, D) in merge-block order
        b, s, d = x.shape
        if self.use_postshuffle_norm:
            x = self.norm(x.reshape(b, s // self.factor, self.factor * d))
        else:
            x = self.norm(x).reshape(b, s // self.factor, self.factor * d)
        return self.linear_fc2(F.gelu(self.linear_fc1(x)))


class VisionTower(nn.Module):
    def __init__(self, cfg: VisionTowerConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if cfg.quant not in (None, "int8"):
            raise ValueError(f"unknown vision tower quant {cfg.quant!r}; None or 'int8'")
        if cfg.spatial_merge_size != 2:
            raise ValueError("the merge-block order is fixed at spatial_merge_size 2, as in JAX")
        dtype, pdtype = getattr(torch, cfg.dtype), getattr(torch, cfg.param_dtype)
        self.cfg, self.dtype = cfg, dtype
        patch_dim = cfg.temporal_patch_size * cfg.patch_size ** 2 * 3
        self.patch_embed = Dense(patch_dim, cfg.hidden_size, dtype=dtype, param_dtype=pdtype,
                                 device=device)
        self.pos_embed = nn.Parameter(torch.empty(cfg.pos_embed_grid ** 2, cfg.hidden_size,
                                                  dtype=pdtype, device=device))
        self.blocks = nn.ModuleList(VisionBlock(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        if generator is not None:
            self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Truncated normal (std 0.02) kernels, N(0, 0.02^2) position table,
        zero biases, unit LayerNorm weights (set at construction)."""
        self.patch_embed.init_weights(generator)
        normal_(self.pos_embed, 0.02, generator)
        for blk in self.blocks:
            for d in (blk.qkv, blk.proj, blk.fc1, blk.fc2):
                d.init_weights(generator)

    def forward(self, video: torch.Tensor):
        """video (B, T, H, W, 3), T a multiple of the temporal patch ->
        (tokens (B, S, D) in merge-block order, [deepstack taps (B, S, D)])."""
        cfg = self.cfg
        b, t, hh, ww, c = video.shape
        p, tp, m = cfg.patch_size, cfg.temporal_patch_size, cfg.spatial_merge_size
        gt, gh, gw = t // tp, hh // p, ww // p
        # patchify as one GEMM, in merge-block order
        x = video.reshape(b, gt, tp, gh // m, m, p, gw // m, m, p, c)
        x = x.permute(0, 1, 3, 6, 4, 7, 2, 5, 8, 9).reshape(b, gt * gh * gw, tp * p * p * c)
        x = self.patch_embed(x.to(self.dtype))
        pos = _interpolate_pos_embed(self.pos_embed.float(), cfg.pos_embed_grid, gh, gw)
        order = torch.from_numpy(merge_order(gh, gw, m)).to(pos.device)
        x = x + pos[order].repeat(gt, 1).to(self.dtype)[None]
        # frames folded into the batch: attention within each frame
        cos, sin = _vision_rope_tables(1, gh, gw, cfg.head_dim, device=x.device)
        x = x.reshape(b * gt, gh * gw, cfg.hidden_size)
        taps = []
        for i, blk in enumerate(self.blocks):
            x = blk(x, cos, sin)
            if i in cfg.deepstack_indexes:
                taps.append(x.reshape(b, gt * gh * gw, cfg.hidden_size))
        return x.reshape(b, gt * gh * gw, cfg.hidden_size), taps
