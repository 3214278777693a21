"""Frozen teacher encoders for UMT masked distillation: PyTorch port.

Port of internvideo_tpu/models/teachers.py:

  * `CLIPTeacher`: the InternVL-CLIP-6B image encoder applied per frame
    (an InternVideo2 stack with num_frames 1, RMSNorm / whole-dim QK-norm /
    LayerScale 0.1, attention-pooled head), returning
      - K intermediate layers in ascending block order, l2-normed, with
        the per-frame CLS tokens averaged over time and the patch tokens
        concatenated over time: (K, B, 1 + T*HW, C);
      - the pooled projection, frame-averaged and l2-normed: (B, C_clip);
      - the pooling attention over each frame's patches: (B*T, HW), which
        drives attention-guided masking.
  * `MAETeacher`: the VideoMAE-g14 hybrid: no CLS token, a frozen 1-D
    sinusoid pos table, LayerNorm blocks (eps 1e-6) with qkv bias and no QK
    norm, and the final `norm` (LayerNorm's default eps 1e-5) applied to
    the last block's output *before* it is recorded (:159-169); returns K
    patch-feature layers in ascending block order, l2-normed: (K, B, N, C).

Teachers are ordinary modules built on their device from a seeded
generator; the trainer freezes them (train/state.py `frozen_teacher`) and
runs them under torch.no_grad(), the counterpart of `stop_gradient`. On the
card the CLIP teacher's attention runs the fused qkv kernel K3 (S = 257,
head dim 128) and the MAE teacher's the flash forward K1 (S = 4096).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from internvideo_tpu_torch.models.internvideo2 import InternVideo2, InternVideo2Config
from internvideo_tpu_torch.nn.dense import Dense
from internvideo_tpu_torch.nn.embeds import PatchEmbed3D
from internvideo_tpu_torch.nn.norms import LayerNorm
from internvideo_tpu_torch.nn.transformer import Block


@dataclasses.dataclass(frozen=True)
class TeacherConfig:
    """Same fields and defaults as internvideo_tpu's TeacherConfig."""

    embed_dim: int = 3200
    depth: int = 48
    num_heads: int = 25
    mlp_ratio: float = 4.0
    patch_size: int = 14
    img_size: int = 224
    clip_embed_dim: int = 768
    return_layers: int = 6
    return_interval: float = 1.0
    norm_type: str = "rmsnorm"  # MAE teacher: "layernorm"
    qk_normalization: bool = True
    init_values: float = 0.1
    tubelet_size: int = 1
    dtype: str = "float32"
    param_dtype: str = "float32"
    attn_impl: str = "auto"

    @property
    def return_indices(self) -> tuple[int, ...]:
        return tuple(
            self.depth - int(i * self.return_interval) - 1
            for i in range(self.return_layers)
        )


def _l2(x: torch.Tensor) -> torch.Tensor:
    """x / ||x|| over the last dim, the norm taken in fp32 and cast to x's
    dtype before the division, as the JAX modules do."""
    return x / torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True).to(x.dtype)


class CLIPTeacher(nn.Module):
    def __init__(self, config: TeacherConfig, *, device, generator: torch.Generator):
        super().__init__()
        self.config = cfg = config
        self.encoder = InternVideo2(InternVideo2Config(
            embed_dim=cfg.embed_dim, depth=cfg.depth, num_heads=cfg.num_heads,
            mlp_ratio=cfg.mlp_ratio, patch_size=cfg.patch_size,
            img_size=cfg.img_size, num_frames=1, tubelet_size=1,
            qk_normalization=cfg.qk_normalization, init_values=cfg.init_values,
            clip_embed_dim=cfg.clip_embed_dim, num_classes=0,
            dtype=cfg.dtype, param_dtype=cfg.param_dtype,
            attn_impl=cfg.attn_impl, norm_type=cfg.norm_type,
        ), device=device, generator=generator)

    def forward(self, video: torch.Tensor):
        """video (B, T, H, W, 3) -> (z, pooled, attn) as documented above."""
        b, t = video.shape[:2]
        out = self.encoder(
            video.reshape((b * t, 1) + tuple(video.shape[2:])),
            return_hidden_layers=sorted(set(self.config.return_indices)),
            return_pool_attn=True,
        )
        # hidden states arrive in ascending block order; each layer's
        # per-frame tokens fold into one clip: CLS averaged over time, patch
        # tokens concatenated over time. One layer at a time into the
        # output, so the 6B teacher's K stacked copies never coexist.
        hidden = out.hidden_states
        hw1, c = hidden[0].shape[1:]
        z = torch.empty((len(hidden), b, 1 + t * (hw1 - 1), c), dtype=hidden[0].dtype,
                        device=video.device)
        for i, h in enumerate(hidden):
            cls = h[:, :1].reshape(b, t, 1, c).mean(dim=1)
            z[i] = _l2(torch.cat([cls, h[:, 1:].reshape(b, t * (hw1 - 1), c)], dim=1))
        out.hidden_states = hidden = None
        pooled = _l2(out.pooled.reshape(b, t, -1).mean(dim=1))
        attn = out.pool_attn[:, 1:]  # (B*T, HW): drop the attention onto CLS
        return z, pooled, attn


def sinusoid_table_1d(n_position: int, dim: int) -> np.ndarray:
    """The 1-D transformer sinusoid table (videomae.py
    get_sinusoid_encoding_table): angle[p, j] = p / 10000^(2*(j//2)/dim),
    sin on even columns, cos on odd; float32."""
    pos = np.arange(n_position)[:, None]
    j = np.arange(dim)[None, :]
    angle = pos / np.power(10000.0, 2 * (j // 2) / dim)
    table = np.zeros((n_position, dim), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


class MAETeacher(nn.Module):
    """`num_frames`: the frames of the clips it will see. The JAX module
    sizes its pos table from the first video; a torch parameter needs the
    token count N = num_frames / tubelet * (img / patch)^2 when it is built."""

    def __init__(self, config: TeacherConfig, *, num_frames: int, device,
                 generator: torch.Generator):
        super().__init__()
        self.config = cfg = config
        dtype = getattr(torch, cfg.dtype)
        param_dtype = getattr(torch, cfg.param_dtype)
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed3D(d, patch_size=cfg.patch_size,
                                        tubelet_size=cfg.tubelet_size, **kw)
        n = num_frames // cfg.tubelet_size * (cfg.img_size // cfg.patch_size) ** 2
        self.pos_embed = nn.Parameter(torch.from_numpy(sinusoid_table_1d(n, d)).to(
            device=device, dtype=param_dtype))
        self.blocks = nn.ModuleList(
            Block(d, cfg.num_heads, mlp_ratio=cfg.mlp_ratio, qkv_bias=True,
                  qk_normalization=False, init_values=cfg.init_values or None,
                  norm_type="layernorm", attn_impl=cfg.attn_impl, **kw)
            for _ in range(cfg.depth)
        )
        self.norm = LayerNorm(d, dtype=dtype, device=device)  # LayerNorm's default eps 1e-5
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, Dense):
                    m.init_weights(generator)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        """video (B, T, H, W, 3) -> (K, B, N, C) l2-normed patch features."""
        x = self.patch_embed(video)  # (B, T', L, C)
        x = x.reshape(x.shape[0], -1, self.config.embed_dim)
        x = x + self.pos_embed.detach()[None].to(self.dtype)
        want = set(self.config.return_indices)
        z = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i == len(self.blocks) - 1:
                x = self.norm(x)
            if i in want:
                z.append(x)
        return _l2(torch.stack(z))  # ascending block order
