"""Temporal action localization: the trainable ActionFormer-class model.

Port of internvideo_tpu/models/actionformer.py (the reference's TAL
training suite, InternVideo1/Downstream/Temporal-Action-Localization/libs/
modeling/meta_archs.py:167-750):

  * conv embed -> windowed-attention blocks, with a masked stride-2 max
    pool between pyramid levels; each block's attention passes the window
    and segment ids (0 valid, -2 pad) to `ops.attention.
    dot_product_attention`, which takes K5 with K8's segment masking
    (non-causal, windowed) on a CUDA tensor and the plain band-masked
    attention on a CPU one;
  * anchor-free point heads: shared conv cls and reg towers with a
    per-level learnable scale applied before the ReLU;
  * point generation and label assignment (radius center sampling,
    per-level regression ranges, the shortest-duration tie-break with the
    reference's 1e-3 tolerance), vectorised over (points x events);
  * sigmoid focal + ctr-DIoU 1D losses over the positive count;
  * inference: per-class score thresholding -> segments, consumed by
    eval/temporal_detection.py's NMS and mAP.

The flax modules' numerics are kept: LayerNorm with eps 1e-6 and E[x^2] -
E[x]^2 variance (models/beats.py:FlaxLayerNorm), the tanh GELU, SAME
padding (1 on each side) for every k=3 conv, lecun-normal init. Padding
positions are re-zeroed after every position-mixing op (the reference's
MaskedConv1D contract). Features arrive as (B, T, C) with a validity mask,
ground truth as (B, max_events, 2) + labels with an event mask.
models/convert.py:actionformer_params_from_jax maps JAX params onto this
module's state_dict.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from internvideo_tpu_torch.models.beats import Conv, FlaxLayerNorm
from internvideo_tpu_torch.nn.dense import Dense, lecun_normal_std
from internvideo_tpu_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class ActionFormerConfig:
    in_dim: int = 2048          # InternVideo feature dim
    embed_dim: int = 256
    num_heads: int = 4
    num_levels: int = 4         # pyramid levels (stride 2**l)
    num_blocks: int = 2         # transformer blocks in the stem
    window: int = 9             # local attention window, |i - j| < window (full if <= 0)
    head_layers: int = 3
    num_classes: int = 20
    max_seq_len: int = 256      # T at stride 1 (divisible by 2**levels)
    center_sample_radius: float = 1.5
    # per-level regression ranges in stride-1 frame units, contiguous and
    # not stride-scaled (the reference's config.py:51)
    regression_ranges: Optional[tuple] = None
    dtype: str = "float32"

    def ranges(self) -> np.ndarray:
        if self.regression_ranges is not None:
            return np.asarray(self.regression_ranges, np.float32)
        r = [(0.0, 4.0)]
        for _ in range(1, self.num_levels):
            r.append((r[-1][1], r[-1][1] * 2))
        r[-1] = (r[-1][0], 1e8)
        return np.asarray(r, np.float32)


def generate_points(cfg: ActionFormerConfig) -> np.ndarray:
    """(sum_l T / 2^l, 4) rows of [t, range_lo, range_hi, stride]: the
    PointGenerator (loc_generators.py:28-85) materialised once."""
    rows = []
    ranges = cfg.ranges()
    for lvl in range(cfg.num_levels):
        stride = 2 ** lvl
        t = cfg.max_seq_len // stride
        coords = (np.arange(t, dtype=np.float32) + 0.5) * stride
        lo = np.full(t, ranges[lvl, 0], np.float32)
        hi = np.full(t, ranges[lvl, 1], np.float32)
        st = np.full(t, float(stride), np.float32)
        rows.append(np.stack([coords, lo, hi, st], axis=1))
    return np.concatenate(rows, axis=0)


def _conv3(in_dim: int, out_dim: int, dtype: torch.dtype, device) -> Conv:
    """flax nn.Conv(out_dim, (3,), padding="SAME") on (B, C, T)."""
    return Conv((out_dim, in_dim, 3), bias=True, padding=1, dtype=dtype, device=device)


def _on_time(conv: Conv, x: torch.Tensor) -> torch.Tensor:
    """A (B, C, T) conv applied to (B, T, C)."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in fp32, or wider (an fp64 model stays fp64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _zero_pads(h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], h, torch.zeros((), dtype=h.dtype, device=h.device))


class _ConvHead(nn.Module):
    """Shared 1-D conv tower + final conv (meta_archs.py:14-165)."""

    def __init__(self, dim: int, out_dim: int, layers: int, *, dtype: torch.dtype, device):
        super().__init__()
        self.conv = nn.ModuleList(_conv3(dim, dim, dtype, device) for _ in range(layers))
        self.ln = nn.ModuleList(FlaxLayerNorm(dim, dtype=dtype, device=device)
                                for _ in range(layers))
        self.out = _conv3(dim, out_dim, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, D)
        for conv, ln in zip(self.conv, self.ln):
            x = F.relu(ln(_on_time(conv, x)))
        return _on_time(self.out, x)


class _Block(nn.Module):
    """Pre-LN windowed self-attention + GELU MLP (JAX :102-130)."""

    def __init__(self, dim: int, num_heads: int, window: int, *, dtype: torch.dtype, device,
                 attn_impl: str = "auto"):
        super().__init__()
        self.num_heads, self.window, self.attn_impl = num_heads, window, attn_impl
        kw = dict(dtype=dtype, device=device)
        self.norm1 = FlaxLayerNorm(dim, **kw)
        self.qkv = Dense(dim, 3 * dim, init_std=lecun_normal_std(dim), **kw)
        self.proj = Dense(dim, dim, init_std=lecun_normal_std(dim), **kw)
        self.norm2 = FlaxLayerNorm(dim, **kw)
        self.fc1 = Dense(dim, 4 * dim, init_std=lecun_normal_std(dim), **kw)
        self.fc2 = Dense(4 * dim, dim, init_std=lecun_normal_std(4 * dim), **kw)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        q, k, v = self.qkv(self.norm1(x)).chunk(3, dim=-1)
        shp = (b, t, self.num_heads, d // self.num_heads)
        # padding tokens get segment -2 so nothing valid attends to them
        seg = torch.where(mask, 0, -2).to(torch.int32)
        out = dot_product_attention(
            q.reshape(shp), k.reshape(shp), v.reshape(shp),
            q_segment_ids=seg, kv_segment_ids=seg,
            window=self.window if self.window > 0 else None, impl=self.attn_impl,
        ).reshape(b, t, d)
        x = x + self.proj(out)
        h = self.fc1(self.norm2(x))
        return x + self.fc2(F.gelu(h, approximate="tanh"))


class ActionFormer(nn.Module):
    """feats (B, T, C) float, mask (B, T) bool -> (cls_logits (B, P,
    num_classes), offsets (B, P, 2) in stride units (fp32, or fp64 in an
    fp64 model), point_mask (B, P)), P = sum over levels of T / 2^l."""

    def __init__(self, config: ActionFormerConfig, *, device, generator: torch.Generator):
        super().__init__()
        self.config = cfg = config
        self.dtype = dt = getattr(torch, cfg.dtype)
        d = cfg.embed_dim
        self.embed0 = _conv3(cfg.in_dim, d, dt, device)
        self.embed1 = _conv3(d, d, dt, device)
        self.stem = nn.ModuleList(_Block(d, cfg.num_heads, cfg.window, dtype=dt, device=device)
                                  for _ in range(cfg.num_blocks))
        self.levels = nn.ModuleList(_Block(d, cfg.num_heads, cfg.window, dtype=dt, device=device)
                                    for _ in range(1, cfg.num_levels))
        self.cls_head = _ConvHead(d, cfg.num_classes, cfg.head_layers, dtype=dt, device=device)
        self.reg_head = _ConvHead(d, 2, cfg.head_layers, dtype=dt, device=device)
        self.scales = nn.ParameterList(
            nn.Parameter(torch.ones((), dtype=torch.float32, device=device))
            for _ in range(cfg.num_levels))
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's defaults, in module order: lecun-normal conv and dense
        weights, zero biases; norms and scales keep their ones / zeros."""
        for m in self.modules():
            if isinstance(m, (Dense, Conv)):
                m.init_weights(generator)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor):
        x = _zero_pads(feats.to(self.dtype), mask)
        x = _on_time(self.embed1, F.relu(_on_time(self.embed0, x)))
        x = _zero_pads(x, mask)
        for blk in self.stem:
            x = _zero_pads(blk(x, mask), mask)
        logits, offsets, masks = [], [], []
        m = mask
        for lvl, scale in enumerate(self.scales):
            if lvl > 0:
                # masked max pool (window 2, stride 2, SAME): pads are -inf,
                # so a window with a valid input keeps its true max
                x = torch.where(m[..., None], x, float("-inf"))
                x = F.max_pool1d(x.transpose(1, 2), 2, 2, ceil_mode=True).transpose(1, 2)
                m = m[:, ::2]
                x = _zero_pads(x, m)  # fully padded windows: -inf -> 0
                x = _zero_pads(self.levels[lvl - 1](x, m), m)
            logits.append(self.cls_head(x))
            offsets.append(F.relu(_wide(self.reg_head(x)) * scale))
            masks.append(m)
        return torch.cat(logits, dim=1), torch.cat(offsets, dim=1), torch.cat(masks, dim=1)


# ---------------------------------------------------------------------------
# Label assignment + losses (meta_archs.py:432-560, losses.py:5-170)
# ---------------------------------------------------------------------------


def label_points(
    points: torch.Tensor,      # (P, 4) [t, lo, hi, stride]
    segments: torch.Tensor,    # (B, N, 2) start/end in stride-1 units
    labels: torch.Tensor,      # (B, N) int in [0, C)
    event_mask: torch.Tensor,  # (B, N) bool
    *,
    num_classes: int,
    center_sample_radius: float = 1.5,
):
    """-> (cls_targets (B, P, C) multi-hot, reg_targets (B, P, 2) in stride
    units, pos_mask (B, P))."""
    t = points[None, :, 0, None]                     # (1, P, 1)
    stride = points[None, :, 3, None]
    lo, hi = points[None, :, 1, None], points[None, :, 2, None]
    seg = segments[:, None]                          # (B, 1, N, 2)
    left = t - seg[..., 0]                           # (B, P, N)
    right = seg[..., 1] - t
    lens = seg[..., 1] - seg[..., 0]

    center = 0.5 * (seg[..., 0] + seg[..., 1])
    t_min = torch.maximum(center - stride * center_sample_radius, seg[..., 0])
    t_max = torch.minimum(center + stride * center_sample_radius, seg[..., 1])
    inside = torch.minimum(t - t_min, t_max - t) > 0

    max_dist = torch.maximum(left, right)
    in_range = (max_dist >= lo) & (max_dist <= hi)
    valid = inside & in_range & event_mask[:, None]

    big = torch.tensor(float("inf"), dtype=lens.dtype, device=lens.device)
    lens_m = torch.where(valid, lens, big)
    min_len = lens_m.amin(dim=-1, keepdim=True)         # (B, P, 1)
    # multi-match tolerance (meta_archs.py: min_len + 1e-3)
    match = (lens_m <= min_len + 1e-3) & valid          # (B, P, N)

    onehot = F.one_hot(labels.long(), num_classes).to(torch.float32)  # (B, N, C)
    cls_targets = torch.clamp(torch.einsum("bpn,bnc->bpc", match.float(), onehot), 0.0, 1.0)
    pos_mask = match.any(dim=-1)

    # regression target from the argmin-length matched event, normalised
    # by stride (the reference divides by stride before the loss)
    idx = torch.argmin(torch.where(match, lens_m, big), dim=-1)  # (B, P)
    gl = left.gather(-1, idx[..., None])[..., 0]
    gr = right.gather(-1, idx[..., None])[..., 0]
    reg_targets = torch.stack([gl, gr], dim=-1) / points[None, :, 3, None]
    return cls_targets, reg_targets, pos_mask


def ctr_diou_loss_1d(pred, target, eps: float = 1e-8):
    """Per-row DIoU for center-offset 1-D segments (losses.py:108-170)."""
    lp, rp = pred[..., 0], pred[..., 1]
    lg, rg = target[..., 0], target[..., 1]
    inter = torch.minimum(lp, lg) + torch.minimum(rp, rg)
    union = (lp + rp) + (lg + rg) - inter
    iou = inter / torch.clamp(union, min=eps)
    # smallest enclosing box + center distance
    len_c = torch.maximum(lp, lg) + torch.maximum(rp, rg)
    rho = 0.5 * (rp - lp) - 0.5 * (rg - lg)
    return 1.0 - iou + rho.square() / torch.clamp(len_c.square(), min=eps)


def focal_multihot(logits, targets, *, gamma=2.0, alpha=0.25):
    """fvcore sigmoid_focal_loss (losses.py:5-52), multi-hot targets."""
    p = torch.sigmoid(_wide(logits))
    ce = -(targets * F.logsigmoid(logits) + (1 - targets) * F.logsigmoid(-logits))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
    return alpha_t * loss


def actionformer_loss(model_out, points, batch, cfg: ActionFormerConfig,
                      *, loss_weight: float = 1.0):
    """Total = focal cls / num_pos + weight * DIoU over positives
    (meta_archs.py:560-640 `losses`); `points` (P, 4) and `batch`
    ("segments", "labels", "event_mask") on the model's device."""
    logits, offsets, point_mask = model_out
    cls_t, reg_t, pos = label_points(
        points, batch["segments"], batch["labels"], batch["event_mask"],
        num_classes=cfg.num_classes, center_sample_radius=cfg.center_sample_radius)
    valid = point_mask
    num_pos = (pos & valid).sum().clamp_min(1).float()
    cls_loss = (focal_multihot(logits, cls_t) * valid[..., None]).sum() / num_pos
    reg_loss = (ctr_diou_loss_1d(offsets, reg_t) * (pos & valid)).sum() / num_pos
    return cls_loss + loss_weight * reg_loss, {
        "cls_loss": cls_loss, "reg_loss": reg_loss, "num_pos": num_pos,
    }


def decode_detections(
    logits,    # (P, C)
    offsets,   # (P, 2) stride units
    points: np.ndarray,  # (P, 4)
    *,
    score_threshold: float = 0.1,
    max_per_class: int = 100,
):
    """-> {class: (K, 3) float32 rows of (start, end, score)}, ready for
    eval/temporal_detection.nms_proposals (meta_archs.py:650-750). Host
    numpy; tensors are copied to the host first."""
    logits, offsets = (x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor)
                       else np.asarray(x) for x in (logits, offsets))
    probs = 1.0 / (1.0 + np.exp(-np.asarray(logits, np.float64)))
    t = points[:, 0]
    stride = points[:, 3]
    starts = t - offsets[:, 0] * stride
    ends = t + offsets[:, 1] * stride
    out = {}
    for c in range(probs.shape[1]):
        keep = probs[:, c] >= score_threshold
        if not np.any(keep):
            out[c] = np.zeros((0, 3), np.float32)
            continue
        segs = np.stack([starts[keep], ends[keep], probs[keep, c]], axis=1)
        order = np.argsort(-segs[:, 2])[:max_per_class]
        out[c] = segs[order].astype(np.float32)
    return out
