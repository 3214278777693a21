"""UMT / MAE masked-pretraining student: PyTorch port.

Port of internvideo_tpu/models/pretrain.py (`PretrainInternVideo2`):

  student = the InternVideo2 encoder on the visible tokens only
  + K CLIP-align decoders (Linear -> LayerNorm -> l2), one per aligned
    intermediate layer, fed the layer's tokens plus a learnable sin-cos
    `clip_pos_embed` gathered at the visible positions (CLS slot in front);
  + one final CLIP decoder on the attention-pooled output;
  + K MAE-align decoders (Linear -> exact GELU -> Linear -> LayerNorm -> l2)
    on the patch tokens (no CLS) plus `mae_pos_embed`.

Aligned layers are depth - int(i * interval) - 1 for i < K, and decoder j
pairs with the j-th of them in ascending block order (:198-211). Masking is
by index: `keep_indices` (B, n_vis) has a static visible count
(data/masking.py). Decoder weights start from xavier-uniform, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from internvideo_tpu_torch.models.internvideo2 import InternVideo2, InternVideo2Config
from internvideo_tpu_torch.models.teachers import _l2
from internvideo_tpu_torch.nn.dense import Dense
from internvideo_tpu_torch.nn.embeds import get_3d_sincos_pos_embed
from internvideo_tpu_torch.nn.norms import LayerNorm


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    """Same fields and defaults as internvideo_tpu's PretrainConfig."""

    encoder: InternVideo2Config = dataclasses.field(default_factory=InternVideo2Config)
    clip_output_dim: int = 3200  # teacher hidden dim (InternVL-6B: 3200)
    clip_final_output_dim: int = 768  # teacher projector dim
    clip_norm_type: str = "l2"
    clip_return_layers: int = 6
    clip_return_interval: float = 1.0
    mae_output_dim: int = 768
    mae_norm_type: str = "l2"
    mae_return_layers: int = 1
    mae_return_interval: float = 1.0
    distill_final_features: bool = True

    def return_indices(self, k: int, interval: float) -> tuple[int, ...]:
        return tuple(self.encoder.depth - int(i * interval) - 1 for i in range(k))

    @property
    def clip_indices(self) -> tuple[int, ...]:
        return self.return_indices(self.clip_return_layers, self.clip_return_interval)

    @property
    def mae_indices(self) -> tuple[int, ...]:
        return self.return_indices(self.mae_return_layers, self.mae_return_interval)


@dataclasses.dataclass
class PretrainOutput:
    clip_middle: Optional[torch.Tensor]  # (K, B, 1+n_vis, clip_output_dim), l2-normed
    clip_final: Optional[torch.Tensor]  # (B, clip_final_output_dim)
    mae: Optional[torch.Tensor]  # (K_mae, B, n_vis, mae_output_dim)
    tokens: Optional[torch.Tensor] = None  # (B, 1+n_vis, D)
    pooled: Optional[torch.Tensor] = None  # (B, clip_embed_dim)


class _LinearDecoder(nn.Module):
    """Linear -> LayerNorm (eps 1e-5) -> l2 (pretrain.py:74-94)."""

    def __init__(self, in_dim: int, out_dim: int, norm_type: str = "l2", *,
                 dtype: torch.dtype, param_dtype: torch.dtype, device):
        super().__init__()
        self.norm_type = norm_type
        self.head = Dense(in_dim, out_dim, dtype=dtype, param_dtype=param_dtype,
                          init_std="xavier_uniform", device=device)
        self.norm = LayerNorm(out_dim, eps=1e-5, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.head(x))
        return _l2(x) if self.norm_type == "l2" else x


class _MlpDecoder(nn.Module):
    """Linear -> exact GELU -> Linear -> LayerNorm (eps 1e-5) -> l2
    (pretrain.py:97-125); `head.0` / `head.2` are JAX's `head_0` / `head_2`."""

    def __init__(self, in_dim: int, out_dim: int, norm_type: str = "l2", *,
                 dtype: torch.dtype, param_dtype: torch.dtype, device):
        super().__init__()
        self.norm_type = norm_type
        kw = dict(dtype=dtype, param_dtype=param_dtype, init_std="xavier_uniform",
                  device=device)
        self.head = nn.Sequential(Dense(in_dim, in_dim, **kw), nn.GELU(),
                                  Dense(in_dim, out_dim, **kw))
        self.norm = LayerNorm(out_dim, eps=1e-5, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.head(x))
        return _l2(x) if self.norm_type == "l2" else x


class PretrainInternVideo2(nn.Module):
    def __init__(self, config: PretrainConfig, *, device, generator: torch.Generator):
        super().__init__()
        self.config = cfg = config
        enc = cfg.encoder
        dtype, param_dtype = getattr(torch, enc.dtype), getattr(torch, enc.param_dtype)
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        d = enc.embed_dim
        gt, gh, _ = enc.grid_size
        self.encoder = InternVideo2(enc, device=device, generator=generator)

        def table(cls_token: bool) -> nn.Parameter:
            pos = get_3d_sincos_pos_embed(d, gh, gt, cls_token=cls_token)
            return nn.Parameter(torch.from_numpy(pos).to(device=device, dtype=param_dtype))

        self.clip_pos_embed = table(True)
        self.clip_decoder = nn.ModuleList(
            _LinearDecoder(d, cfg.clip_output_dim, cfg.clip_norm_type, **kw)
            for _ in sorted(set(cfg.clip_indices)))
        self.final_clip_decoder = (
            _LinearDecoder(enc.clip_embed_dim, cfg.clip_final_output_dim,
                           cfg.clip_norm_type, **kw)
            if cfg.distill_final_features else None)
        if cfg.mae_return_layers:
            self.mae_pos_embed = table(False)
            self.mae_decoder = nn.ModuleList(
                _MlpDecoder(d, cfg.mae_output_dim, cfg.mae_norm_type, **kw)
                for _ in sorted(set(cfg.mae_indices)))
        else:
            self.mae_pos_embed = self.mae_decoder = None
        with torch.no_grad():
            for name, m in self.named_modules():
                if isinstance(m, Dense) and not name.startswith("encoder."):
                    m.init_weights(generator)

    def forward(
        self,
        video: torch.Tensor,  # (B, T, H, W, 3)
        keep_indices: Optional[torch.Tensor] = None,  # (B, n_vis) visible positions
        *,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        return_align: Optional[bool] = None,  # None: align iff masked
    ) -> PretrainOutput:
        cfg, enc = self.config, self.config.encoder
        if return_align is None:
            return_align = keep_indices is not None
        want = sorted(set(cfg.clip_indices) | set(cfg.mae_indices))
        out = self.encoder(video, keep_indices=keep_indices, deterministic=deterministic,
                           generator=generator,
                           return_hidden_layers=want if return_align else None)
        if not return_align:
            return PretrainOutput(None, None, None, tokens=out.tokens, pooled=out.pooled)
        hidden = dict(zip(want, out.hidden_states))
        b = video.shape[0]
        if keep_indices is None:
            keep_indices = torch.arange(enc.num_patches, device=video.device).expand(b, -1)
        keep = keep_indices.long()

        # visible positions (+1 past the CLS slot), with the CLS slot in front
        pos = self.clip_pos_embed
        clip_pos_vis = torch.cat([pos[:1].expand(b, 1, -1), pos[keep + 1]], dim=1).to(self.dtype)
        clip_middle = torch.stack([
            dec(hidden[layer] + clip_pos_vis)
            for layer, dec in zip(sorted(set(cfg.clip_indices)), self.clip_decoder)])
        clip_final = (self.final_clip_decoder(out.pooled)
                      if self.final_clip_decoder is not None else None)
        if self.mae_decoder is None:
            return PretrainOutput(clip_middle, clip_final, None, tokens=out.tokens,
                                  pooled=out.pooled)
        mae_pos_vis = self.mae_pos_embed[keep].to(self.dtype)
        mae = torch.stack([
            dec(hidden[layer][:, 1:] + mae_pos_vis)
            for layer, dec in zip(sorted(set(cfg.mae_indices)), self.mae_decoder)])
        return PretrainOutput(clip_middle, clip_final, mae, tokens=out.tokens, pooled=out.pooled)
