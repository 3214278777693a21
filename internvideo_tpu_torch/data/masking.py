"""Masking for UMT / MAE-style pretraining: index-based, static shapes.

Port of internvideo_tpu/data/masking.py. Every generator returns
keep_indices, an int64 (B, n_vis) tensor of visible patch positions sorted
ascending, with n_vis a static function of the mask ratio; models gather
with it and the engine gathers the teachers' targets with the same
indices. Draws come from an explicit torch.Generator on the device.

Each generator is split in two: the draw of its noise, and a deterministic
`*_from_noise` function that turns the noise into sorted indices, so that
a test can feed it the same numpy noise as the JAX function. Attention-
guided masking draws without replacement in proportion to the teacher's
attention by the Gumbel-top-k trick, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import torch


def num_visible(num_tokens: int, mask_ratio: float) -> int:
    """Static visible count: N - int(N * ratio) (masking.py:22-24)."""
    return num_tokens - int(num_tokens * mask_ratio)


def _uniform(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=generator.device)


def random_keep_from_noise(noise: torch.Tensor, mask_ratio: float) -> torch.Tensor:
    """The n_vis positions of smallest noise per row, sorted."""
    n_vis = num_visible(noise.shape[-1], mask_ratio)
    return torch.argsort(noise, dim=-1, stable=True)[:, :n_vis].sort(dim=-1).values


def random_keep_indices(generator: torch.Generator, batch: int, num_tokens: int,
                        mask_ratio: float) -> torch.Tensor:
    """Uniform random masking (RandomMaskingGenerator)."""
    return random_keep_from_noise(_uniform(generator, (batch, num_tokens)), mask_ratio)


def tube_keep_from_noise(noise: torch.Tensor, t_size: int, mask_ratio: float) -> torch.Tensor:
    """One spatial mask from (B, spatial) noise, shared by all t_size frames:
    token index = t * spatial + s."""
    spatial = noise.shape[-1]
    keep_s = random_keep_from_noise(noise, mask_ratio)  # (B, n_vis_s)
    offsets = torch.arange(t_size, device=noise.device)[None, :, None] * spatial
    return (keep_s[:, None, :] + offsets).reshape(noise.shape[0], -1)


def tube_keep_indices(generator: torch.Generator, batch: int, t_size: int, spatial_size: int,
                      mask_ratio: float) -> torch.Tensor:
    """Tube masking (TubeMaskingGenerator)."""
    return tube_keep_from_noise(_uniform(generator, (batch, spatial_size)), t_size, mask_ratio)


def attention_guided_keep_from_noise(attn: torch.Tensor, gumbel: torch.Tensor,
                                     mask_ratio: float, *,
                                     batch: Optional[int] = None) -> torch.Tensor:
    """Top-n_vis of log(attn) + gumbel per row, sorted; with `batch` and
    per-frame rows (B*T, N), frame t's indices shift by t * N and the
    frames of a clip concatenate into (B, T * n_vis)."""
    rows, n = attn.shape
    n_vis = num_visible(n, mask_ratio)
    scores = torch.log(attn.float().clamp_min(1e-10)) + gumbel
    keep = torch.topk(scores, n_vis, dim=-1).indices.sort(dim=-1).values
    if batch is not None and rows != batch:
        t = rows // batch
        offsets = torch.arange(t, device=attn.device)[None, :, None] * n
        keep = (keep.reshape(batch, t, n_vis) + offsets).reshape(batch, t * n_vis)
    return keep


def attention_guided_keep_indices(generator: torch.Generator, attn: torch.Tensor,
                                  mask_ratio: float, *,
                                  batch: Optional[int] = None) -> torch.Tensor:
    """Visible tokens drawn in proportion to the teacher's attention
    (B*T or B, N), without replacement: Gumbel-top-k, which has the
    distribution of torch.multinomial(attn, N)[:, :n_vis]."""
    u = _uniform(generator, attn.shape).clamp_(min=torch.finfo(torch.float32).tiny)
    return attention_guided_keep_from_noise(attn, -torch.log(-torch.log(u)), mask_ratio,
                                            batch=batch)


def indices_to_mask(keep_indices: torch.Tensor, num_tokens: int) -> torch.Tensor:
    """Boolean visible mask (True = visible) from keep indices."""
    mask = torch.zeros((keep_indices.shape[0], num_tokens), dtype=torch.bool,
                       device=keep_indices.device)
    return mask.scatter_(1, keep_indices.long(), True)
