"""Patch embedding and sin-cos positional embeddings.

Port of internvideo_tpu/nn/embeds.py. The sin-cos tables are numpy and
equal JAX's exactly: a 3D embedding is a temporal 1D embedding on the first
D/4 channels and a spatial 2D embedding on the other 3D/4, in [T, H, W]
patch order, with an all-zero CLS slot in front. The patch projection is a
block reshape of channels-last video followed by one Dense, with patch
content flattened in (ts, p, p, c) order (embeds.py:112-131).

`interpolate_pos_embed` resamples a learned 3D pos embed to another grid
as JAX's `jax.image.resize(..., "trilinear")` does: a triangle kernel at
half-pixel centres, widened by 1 / scale on an axis that shrinks (the
antialiasing `F.interpolate` lacks), weights normalized per output row.
Each axis whose size changes is one small matmul with that axis's weight
matrix (`resize_weights`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from internvideo_tpu_torch.nn.dense import Dense, lecun_normal_std


def _sincos_1d(embed_dim: int, positions: np.ndarray) -> np.ndarray:
    if embed_dim % 2:
        raise ValueError(f"embed_dim {embed_dim} must be even")
    omega = 1.0 / 10000 ** (
        np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    )
    angles = np.outer(positions.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(angles), np.cos(angles)], axis=1)


def get_1d_sincos_pos_embed(embed_dim: int, length: int, cls_token: bool = False):
    emb = _sincos_1d(embed_dim, np.arange(length))
    if cls_token:
        emb = np.concatenate([np.zeros((1, embed_dim)), emb], axis=0)
    return emb.astype(np.float32)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int, cls_token: bool = False):
    if embed_dim % 2:
        raise ValueError(f"embed_dim {embed_dim} must be even")
    # row-major (h, w) flattening; the w coordinate occupies the first half
    # of the channels (embeds.py:43-51)
    hh, ww = np.meshgrid(
        np.arange(grid_size), np.arange(grid_size), indexing="ij"
    )
    emb = np.concatenate(
        [_sincos_1d(embed_dim // 2, ww), _sincos_1d(embed_dim // 2, hh)], axis=1
    )
    if cls_token:
        emb = np.concatenate([np.zeros((1, embed_dim)), emb], axis=0)
    return emb.astype(np.float32)


def get_3d_sincos_pos_embed(
    embed_dim: int, grid_size: int, t_size: int, cls_token: bool = False
):
    """[1 + T*H*W, D]: first D/4 channels temporal, last 3D/4 spatial."""
    if embed_dim % 4:
        raise ValueError(f"embed_dim {embed_dim} must be a multiple of 4")
    dim_t, dim_s = embed_dim // 4, embed_dim // 4 * 3
    emb_t = _sincos_1d(dim_t, np.arange(t_size))  # (T, D/4)
    emb_s = get_2d_sincos_pos_embed(dim_s, grid_size)  # (H*W, 3D/4)
    n_s = grid_size * grid_size
    full = np.concatenate(
        [
            np.repeat(emb_t[:, None, :], n_s, axis=1),
            np.broadcast_to(emb_s[None, :, :], (t_size, n_s, dim_s)),
        ],
        axis=-1,
    ).reshape(t_size * n_s, embed_dim)
    if cls_token:
        full = np.concatenate([np.zeros((1, embed_dim)), full], axis=0)
    return full.astype(np.float32)


def resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) float32 weights of `jax.image.scale_and_translate`'s
    linear kernel at scale n_out / n_in, translation 0, antialiased."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)  # widen only when downsampling
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = (1.0 - x).clamp_min(0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate_pos_embed(pos_embed: torch.Tensor, src_grid, dst_grid) -> torch.Tensor:
    """(1 + T0 H0 W0, D) with a CLS slot -> (1 + T1 H1 W1, D): trilinear
    resampling of the grid part (checkpoint surgery when the frame count or
    resolution changes; JAX nn/embeds.py:78-95)."""
    t0, h0, w0 = src_grid
    t1, h1, w1 = dst_grid
    cls_tok, grid = pos_embed[:1], pos_embed[1:]
    d = grid.shape[-1]
    vol = grid.reshape(t0, h0, w0, d)
    for axis, (n_in, n_out) in enumerate(((t0, t1), (h0, h1), (w0, w1))):
        if n_in != n_out:
            w = resize_weights(n_in, n_out).to(device=vol.device, dtype=vol.dtype)
            vol = torch.tensordot(vol, w, dims=([axis], [0])).movedim(-1, axis)
    return torch.cat([cls_tok, vol.reshape(t1 * h1 * w1, d)], dim=0)


class PatchEmbed3D(nn.Module):
    """Tubelet patchify: (B, T, H, W, C) channels-last -> (B, T', H'*W', D).

    Equivalent to a Conv3d with kernel = stride = (tubelet, p, p), written
    as a reshape + one Dense GEMM."""

    def __init__(self, embed_dim: int, *, patch_size: int = 14,
                 tubelet_size: int = 1, in_chans: int = 3,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.patch_size = patch_size
        self.tubelet_size = tubelet_size
        self.dtype = dtype
        fan_in = tubelet_size * patch_size * patch_size * in_chans
        self.proj = Dense(fan_in, embed_dim, dtype=dtype, param_dtype=param_dtype,
                          init_std=lecun_normal_std(fan_in), device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        p, ts = self.patch_size, self.tubelet_size
        if t % ts or h % p or w % p:
            raise ValueError(f"video {tuple(x.shape)} does not tile by ({ts}, {p}, {p})")
        gt, gh, gw = t // ts, h // p, w // p
        x = x.reshape(b, gt, ts, gh, p, gw, p, c)
        # -> (B, gt, gh, gw, ts, p, p, c): patch-content dims contiguous last
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
        x = x.reshape(b, gt, gh * gw, ts * p * p * c)
        return self.proj(x.to(self.dtype))
