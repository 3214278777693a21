"""VideoCLIP stage-2 model: vision tower + BERT text / fusion tower.

Port of internvideo_tpu/models/videoclip.py: the InternVideo2 tower (or, with
`pretrain` set, the masked pretrain student `PretrainInternVideo2` whose
CLIP-align decoders feed the UTA branch), the fusion BERT (models/bert.py,
cross-attending to the tower's width), `vision_proj` / `text_proj` into the
shared `embed_dim` space, the `itm_head` for video-text matching and the
learnable temperature, clamped at `temp_min`.

Submodules carry the flax names (`vision_encoder`, `text_encoder`,
`vision_proj`, `text_proj`, `itm_head`, `temp`), so `models/convert.py`
maps a JAX tree onto them. The three projections run in the tower's dtype
with fp32 weights, as the JAX `nn.Dense(dtype=...)` does. The JAX forward's
`init_all_branches` exists for flax init, which this port does not need:
every branch is built at construction. The stage-2 losses and train step
(VTC, VTM, MLM and UTA) are in train/engines/clip.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from internvideo_tpu_torch.models.bert import BertConfig, BertModel, BertOutput
from internvideo_tpu_torch.models.internvideo2 import InternVideo2, InternVideo2Config
from internvideo_tpu_torch.models.pretrain import PretrainConfig, PretrainInternVideo2
from internvideo_tpu_torch.nn.dense import Dense


@dataclasses.dataclass(frozen=True)
class VideoCLIPConfig:
    """Same fields and defaults as internvideo_tpu's VideoCLIPConfig."""

    vision: InternVideo2Config = dataclasses.field(default_factory=InternVideo2Config)
    text: BertConfig = dataclasses.field(default_factory=BertConfig)
    embed_dim: int = 512
    temp_init: float = 0.07
    temp_min: float = 1 / 100.0
    # the masked pretrain student as the tower; `pretrain.encoder` must equal `vision`
    pretrain: Optional[PretrainConfig] = None


@dataclasses.dataclass
class VideoCLIPOutput:
    vision_embeds: torch.Tensor  # (B, 1+N, Dv) token embeddings
    pooled_vision: torch.Tensor  # (B, clip_embed_dim)
    text_embeds: torch.Tensor  # (B, L, Dt)
    pooled_text: torch.Tensor  # (B, Dt)
    vision_proj: torch.Tensor  # (B, embed_dim)
    text_proj: torch.Tensor  # (B, embed_dim)
    temp: torch.Tensor  # ()
    clip_middle: Optional[torch.Tensor] = None  # (K, B, 1+n_vis, C_t), l2-normed
    clip_final: Optional[torch.Tensor] = None  # (B, C_proj)


class VideoCLIP(nn.Module):
    def __init__(self, config: VideoCLIPConfig, *, device, generator: torch.Generator):
        super().__init__()
        self.config = cfg = config
        if cfg.pretrain is not None and cfg.pretrain.encoder != cfg.vision:
            raise ValueError("VideoCLIPConfig: pretrain.encoder must equal vision")
        self.vision_encoder = (
            PretrainInternVideo2(cfg.pretrain, device=device, generator=generator)
            if cfg.pretrain is not None
            else InternVideo2(cfg.vision, device=device, generator=generator))
        self.text_encoder = BertModel(cfg.text, vision_width=cfg.vision.embed_dim,
                                      device=device, generator=generator)
        kw = dict(dtype=getattr(torch, cfg.vision.dtype), param_dtype=torch.float32,
                  device=device)
        self.vision_proj = Dense(cfg.vision.clip_embed_dim, cfg.embed_dim, **kw)
        self.text_proj = Dense(cfg.text.hidden_size, cfg.embed_dim, **kw)
        self.itm_head = Dense(cfg.text.hidden_size, 2, **kw)
        self.temp = nn.Parameter(torch.tensor(cfg.temp_init, dtype=torch.float32, device=device))
        for m in (self.vision_proj, self.text_proj, self.itm_head):
            m.init_weights(generator)

    def clamped_temp(self) -> torch.Tensor:
        """The temperature, clamped at `temp_min` (the reference clamps it
        every step)."""
        return torch.clamp(self.temp, min=self.config.temp_min)

    def encode_vision(self, video, keep_indices=None, deterministic: bool = True,
                      return_align=None, generator=None):
        """(tokens, pooled, clip_middle, clip_final); the align pair is None
        for the plain tower or unmasked forwards."""
        if self.config.pretrain is not None:
            out = self.vision_encoder(video, keep_indices, deterministic=deterministic,
                                      generator=generator, return_align=return_align)
            return out.tokens, out.pooled, out.clip_middle, out.clip_final
        out = self.vision_encoder(video, keep_indices=keep_indices, deterministic=deterministic,
                                  generator=generator)
        return out.tokens, out.pooled, None, None

    def encode_text(self, input_ids, attention_mask, deterministic: bool = True,
                    generator=None):
        """(last hidden state, pooled CLS) of the text-only layers."""
        out = self.text_encoder(input_ids, attention_mask, mode="text",
                                deterministic=deterministic, generator=generator)
        return out.last_hidden_state, out.pooled

    def fusion(self, text_embeds, text_mask, vision_embeds, vision_mask=None,
               deterministic: bool = True, with_mlm_logits: bool = False,
               generator=None) -> BertOutput:
        """The fusion layers on precomputed text embeds, cross-attending to
        `vision_embeds`."""
        return self.text_encoder(
            encoder_embeds=text_embeds, attention_mask=text_mask, vision_embeds=vision_embeds,
            vision_mask=vision_mask, mode="fusion", deterministic=deterministic,
            with_mlm_logits=with_mlm_logits, generator=generator)

    def text_multimodal(self, input_ids, attention_mask, vision_embeds,
                        deterministic: bool = True, with_mlm_logits: bool = True,
                        generator=None) -> BertOutput:
        """Full text + fusion pass with cross-attention (the MLM path)."""
        return self.text_encoder(
            input_ids, attention_mask, vision_embeds=vision_embeds, mode="multimodal",
            deterministic=deterministic, with_mlm_logits=with_mlm_logits, generator=generator)

    def itm_logits(self, fusion_cls: torch.Tensor) -> torch.Tensor:
        return self.itm_head(fusion_cls)

    def forward(self, video, input_ids, attention_mask, keep_indices=None,
                deterministic: bool = True, generator=None) -> VideoCLIPOutput:
        vision_embeds, pooled_vision, clip_middle, clip_final = self.encode_vision(
            video, keep_indices, deterministic, generator=generator)
        text_embeds, pooled_text = self.encode_text(input_ids, attention_mask, deterministic,
                                                    generator=generator)
        return VideoCLIPOutput(
            vision_embeds=vision_embeds, pooled_vision=pooled_vision,
            text_embeds=text_embeds, pooled_text=pooled_text,
            vision_proj=self.vision_proj(pooled_vision), text_proj=self.text_proj(pooled_text),
            temp=self.clamped_temp(), clip_middle=clip_middle, clip_final=clip_final)
