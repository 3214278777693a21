"""Audio-visual VideoCLIP stage 2: PyTorch port.

Port of internvideo_tpu/models/videoclip_av.py (`VideoCLIPAVConfig`,
`VideoCLIPAV`), the counterpart of the reference's
InternVideo2_Stage2_audiovisual: one model, three media types, each batch
trained as one of them (train/engines/clip.py `make_av_clip_train_step`):

  * "video": the plain InternVideo2 tower's tokens and `vision_proj` of its
    pooled output;
  * "audio": the audio tower's tokens through `audio_to_fusion` (to the
    vision width, which the fusion BERT's cross-attention reads) and
    `audio_proj` of its pooled output;
  * "audio_video": [audio tokens | vision tokens] concatenated, audio first,
    and `av_proj` of [audio pooled | vision pooled].

The audio tower is models/audio.py's `AudioEncoder` ("simple") or
models/beats.py's `BEATsEncoder` ("beats"). The text / fusion tower is the
BERT of models/bert.py. Every branch is built at construction, so the JAX
forward's `init_all_branches` (a flax init device) is accepted and does
nothing. Submodules carry the flax names (`vision_encoder`,
`audio_encoder`, `text_encoder`, `vision_proj`, `audio_proj`, `av_proj`,
`text_proj`, `itm_head`, `audio_to_fusion`, `temp`), so
models/convert.py maps a JAX tree onto them. The heads run in the vision
tower's dtype with fp32 weights, as the JAX Dense(dtype=...) do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from internvideo_tpu_torch.models.audio import AudioEncoder, AudioEncoderConfig
from internvideo_tpu_torch.models.bert import BertConfig, BertModel, BertOutput
from internvideo_tpu_torch.models.beats import BEATsConfig, BEATsEncoder
from internvideo_tpu_torch.models.internvideo2 import InternVideo2, InternVideo2Config
from internvideo_tpu_torch.models.videoclip import VideoCLIPOutput
from internvideo_tpu_torch.nn.dense import Dense, lecun_normal_std

MEDIA_TYPES = ("video", "audio", "audio_video")


@dataclasses.dataclass(frozen=True)
class VideoCLIPAVConfig:
    """Same fields and defaults as internvideo_tpu's VideoCLIPAVConfig."""

    vision: InternVideo2Config = dataclasses.field(default_factory=InternVideo2Config)
    audio: AudioEncoderConfig = dataclasses.field(default_factory=AudioEncoderConfig)
    # "simple" = models/audio.AudioEncoder; "beats" = models/beats.BEATsEncoder
    audio_tower: str = "simple"
    beats: object = None  # BEATsConfig when audio_tower == "beats" (None: its defaults)
    text: BertConfig = dataclasses.field(default_factory=BertConfig)
    embed_dim: int = 512
    temp_init: float = 0.07
    temp_min: float = 1 / 100.0


class VideoCLIPAV(nn.Module):
    def __init__(self, config: VideoCLIPAVConfig, *, device, generator: torch.Generator):
        super().__init__()
        self.config = cfg = config
        if cfg.audio_tower not in ("simple", "beats"):
            raise ValueError(f"unknown audio_tower {cfg.audio_tower!r}")
        self.vision_encoder = InternVideo2(cfg.vision, device=device, generator=generator)
        if cfg.audio_tower == "beats":
            self.audio_encoder = BEATsEncoder(cfg.beats or BEATsConfig(), device=device,
                                              generator=generator)
            audio_width = self.audio_encoder.config.encoder_embed_dim
        else:
            self.audio_encoder = AudioEncoder(cfg.audio, device=device, generator=generator)
            audio_width = cfg.audio.embed_dim
        self.text_encoder = BertModel(cfg.text, vision_width=cfg.vision.embed_dim,
                                      device=device, generator=generator)
        kw = dict(dtype=getattr(torch, cfg.vision.dtype), param_dtype=torch.float32,
                  device=device)
        v, t, e = cfg.vision.clip_embed_dim, cfg.text.hidden_size, cfg.embed_dim
        self.vision_proj = Dense(v, e, **kw)
        self.audio_proj = Dense(audio_width, e, **kw)
        self.av_proj = Dense(audio_width + v, e, **kw)
        self.text_proj = Dense(t, e, **kw)
        self.itm_head = Dense(t, 2, init_std=lecun_normal_std(t), **kw)
        self.audio_to_fusion = Dense(audio_width, cfg.vision.embed_dim,
                                     init_std=lecun_normal_std(audio_width), **kw)
        self.temp = nn.Parameter(torch.tensor(cfg.temp_init, dtype=torch.float32, device=device))
        for m in (self.vision_proj, self.audio_proj, self.av_proj, self.text_proj,
                  self.itm_head, self.audio_to_fusion):
            m.init_weights(generator)

    def clamped_temp(self) -> torch.Tensor:
        return torch.clamp(self.temp, min=self.config.temp_min)

    def _encode_audio(self, audio, deterministic: bool):
        if self.config.audio_tower == "beats":
            return self.audio_encoder(audio)  # no dropout paths
        return self.audio_encoder(audio, deterministic=deterministic)

    def encode_media(self, media_type: str, video: Optional[torch.Tensor] = None,
                     audio: Optional[torch.Tensor] = None, deterministic: bool = True,
                     generator: Optional[torch.Generator] = None):
        """(fusion tokens (B, L, vision width), projected pooled (B, embed_dim))."""
        if media_type == "video":
            out = self.vision_encoder(video, deterministic=deterministic, generator=generator)
            return out.tokens, self.vision_proj(out.pooled)
        if media_type == "audio":
            tokens, pooled = self._encode_audio(audio, deterministic)
            return self.audio_to_fusion(tokens), self.audio_proj(pooled)
        if media_type == "audio_video":
            v = self.vision_encoder(video, deterministic=deterministic, generator=generator)
            a_tokens, a_pooled = self._encode_audio(audio, deterministic)
            tokens = torch.cat([self.audio_to_fusion(a_tokens), v.tokens], dim=1)
            # jnp.concatenate promotes mixed dtypes (an fp32 tower beside a bf16 one)
            dt = torch.promote_types(a_pooled.dtype, v.pooled.dtype)
            return tokens, self.av_proj(torch.cat([a_pooled.to(dt), v.pooled.to(dt)], dim=-1))
        raise ValueError(f"unknown media_type {media_type!r}; one of {MEDIA_TYPES}")

    def fusion(self, text_embeds, text_mask, media_tokens, deterministic: bool = True,
               with_mlm_logits: bool = False, generator=None) -> BertOutput:
        """The fusion layers on precomputed text embeds, cross-attending to
        the fusion-width tokens of `encode_media` (unmasked: K1 / K2)."""
        return self.text_encoder(
            encoder_embeds=text_embeds, attention_mask=text_mask, vision_embeds=media_tokens,
            mode="fusion", deterministic=deterministic, with_mlm_logits=with_mlm_logits,
            generator=generator)

    def text_multimodal(self, input_ids, attention_mask, media_tokens,
                        deterministic: bool = True, with_mlm_logits: bool = True,
                        generator=None) -> BertOutput:
        return self.text_encoder(
            input_ids, attention_mask, vision_embeds=media_tokens, mode="multimodal",
            deterministic=deterministic, with_mlm_logits=with_mlm_logits, generator=generator)

    def itm_logits(self, fusion_cls: torch.Tensor) -> torch.Tensor:
        return self.itm_head(fusion_cls)

    def encode_text(self, input_ids, attention_mask, deterministic: bool = True,
                    generator=None):
        """(last hidden state, text_proj of the CLS token)."""
        out = self.text_encoder(input_ids, attention_mask, mode="text",
                                deterministic=deterministic, generator=generator)
        return out.last_hidden_state, self.text_proj(out.pooled)

    def forward(self, input_ids, attention_mask, video=None, audio=None,
                media_type: str = "video", deterministic: bool = True,
                init_all_branches: bool = False, generator=None) -> VideoCLIPOutput:
        del init_all_branches  # every branch exists from construction
        media_tokens, media_proj = self.encode_media(media_type, video, audio, deterministic,
                                                     generator)
        text_embeds, text_proj = self.encode_text(input_ids, attention_mask, deterministic,
                                                  generator)
        return VideoCLIPOutput(
            vision_embeds=media_tokens, pooled_vision=media_proj, text_embeds=text_embeds,
            pooled_text=text_proj, vision_proj=media_proj, text_proj=text_proj,
            temp=self.clamped_temp())
