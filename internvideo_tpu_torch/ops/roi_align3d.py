"""ROIAlign3D / ROIPool3D as batched gathers in plain torch.

Port of internvideo_tpu/ops/roi_align3d.py, which replaces the alphaction
CUDA kernels (ROIAlign3d_cuda.cu, ROIPool3d_cuda.cu) by one XLA gather
and interpolation; there is no Pallas kernel, so this is plain torch too.
All ROIs are sampled at once, as JAX's `jax.vmap` (:69) does: each of the
four bilinear corners is one `index_select` of (ROI, sample point) rows
from the feature volume laid out (B * H * W, T * C), whose backward is one
`index_add_`.

Boxes follow the reference convention: (batch_idx, x1, y1, x2, y2) in input
spatial coordinates, applied identically to every frame of the clip.
"""

from __future__ import annotations

import torch


def _sample_grid(boxes: torch.Tensor, out_h: int, out_w: int, s: int, spatial_scale: float):
    """(batch index (N,), ys (N, out_h * s), xs (N, out_w * s)): s x s
    sample points per bin, as JAX's `one_roi` (:53-63)."""
    b = boxes[:, 0].to(torch.int64)
    x1, y1, x2, y2 = (boxes[:, i] * spatial_scale for i in range(1, 5))
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    bin_w, bin_h = rw / out_w, rh / out_h
    dev = boxes.device
    gy = (torch.arange(out_h * s, device=dev) + 0.5) / s  # in bin-height units
    gx = (torch.arange(out_w * s, device=dev) + 0.5) / s
    ys = y1[:, None] + gy[None] * bin_h[:, None]
    xs = x1[:, None] + gx[None] * bin_w[:, None]
    return b, ys, xs


def _bilinear_sample(features: torch.Tensor, b, ys, xs) -> torch.Tensor:
    """features (B, T, H, W, C); b (N,), ys (N, Ph), xs (N, Pw) ->
    (N, Ph, Pw, T, C), with JAX's `_bilinear_sample` (:20) edge rules: the
    corners clamped into the map, the weights against the clamped corner
    clamped to [0, 1]."""
    bsz, t, h, w, c = features.shape
    flat = features.permute(0, 2, 3, 1, 4).reshape(bsz * h * w, t * c)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)[:, :, None, None, None]  # (N, Ph, 1, 1, 1)
    wx = torch.clamp(xs - x0, 0.0, 1.0)[:, None, :, None, None]  # (N, 1, Pw, 1, 1)
    n, ph, pw = ys.shape[0], ys.shape[1], xs.shape[1]
    base = b[:, None, None] * (h * w)

    def g(yi, xi):  # (N, Ph, Pw, T, C)
        idx = base + yi[:, :, None] * w + xi[:, None, :]
        return flat.index_select(0, idx.reshape(-1)).view(n, ph, pw, t, c)

    top = g(y0, x0) * (1 - wx) + g(y0, x1) * wx
    bot = g(y1, x0) * (1 - wx) + g(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def _roi_sample(features, boxes, output_size, spatial_scale, s, reduce):
    out_h, out_w = output_size
    b, ys, xs = _sample_grid(boxes, out_h, out_w, s, spatial_scale)
    sampled = _bilinear_sample(features, b, ys, xs)  # (N, oh * s, ow * s, T, C)
    n, _, _, t, c = sampled.shape
    sampled = reduce(sampled.view(n, out_h, s, out_w, s, t, c))  # (N, oh, ow, T, C)
    return sampled.permute(0, 3, 1, 2, 4)


def roi_align_3d(
    features: torch.Tensor,  # (B, T, H, W, C)
    boxes: torch.Tensor,  # (N, 5): (batch_idx, x1, y1, x2, y2)
    *,
    output_size: tuple[int, int] = (7, 7),
    spatial_scale: float = 1.0,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """(N, T, out_h, out_w, C) aligned per-ROI features: the mean of
    sampling_ratio x sampling_ratio bilinear samples per bin."""
    return _roi_sample(features, boxes, output_size, spatial_scale, sampling_ratio,
                       lambda x: x.mean(dim=(2, 4)))


def roi_pool_3d(
    features: torch.Tensor,
    boxes: torch.Tensor,
    *,
    output_size: tuple[int, int] = (7, 7),
    spatial_scale: float = 1.0,
) -> torch.Tensor:
    """Max-pool variant (ROIPool3d_cuda.cu): the max of 4 x 4 bilinear
    samples per bin (dense sampling approximates exact max pooling)."""
    return _roi_sample(features, boxes, output_size, spatial_scale, 4,
                       lambda x: x.amax(dim=(2, 4)))
