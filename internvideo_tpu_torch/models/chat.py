"""InternVideo2-Chat: vision encoder -> QFormer bridge -> LLM.

Port of internvideo_tpu/models/chat.py (BASELINE config #4, "1B ViT ->
QFormer -> 7B LLM video QA inference with KV cache"): the BLIP-2 /
VideoChat bridge. `num_queries` learnable query tokens run through a
fusion-mode BERT (models/bert.py) that self-attends among the queries and
cross-attends to the InternVideo2 tokens (every layer with `fusion_layer`
0); `llm_proj` maps the query outputs into the LLM's width, and they are
prefixed to the prompt's token embeddings. The LLM is the M2LA decoder
(models/llm.py); its dense latent cache is the chat KV cache.

On the card the forward runs K1 in every ViT block (S = 1 + T x 256 > 1024)
and in every QFormer cross-attention (32 queries on the vision tokens), K2
in every QFormer self-attention and K5 in every LLM layer of the prompt
pass. Decode is the plain absorbed decode over the dense cache, as in JAX.

`vision_in` and `llm_proj` are flax `nn.Dense` with no dtype in JAX, which
computes in the promotion of the input and its fp32 kernel: fp32 here, with
fp32 parameters, as are the query tokens. Submodules carry the flax names
(`vision_encoder`, `qformer.query_tokens`, `qformer.vision_in`,
`qformer.bert`, `llm_proj`, `language_model`), so `models/convert.py` maps
a JAX tree onto them.

`prefill` writes num_queries + prompt_len cache entries, the queries first,
so a decode step after it runs at cache_len = num_queries + prompt_len +
step: `cache_prefix_len` tells `models/generation.generate` so (JAX's
generate does not know it; see there).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from internvideo_tpu_torch.models.bert import BertConfig, BertModel
from internvideo_tpu_torch.models.internvideo2 import InternVideo2, InternVideo2Config
from internvideo_tpu_torch.models.llm import LLMConfig, LLMOutput, MLATransformer
from internvideo_tpu_torch.nn.dense import Dense, trunc_normal_


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    """Same fields and defaults as internvideo_tpu's QFormerConfig."""

    num_queries: int = 32
    bert: BertConfig = dataclasses.field(
        default_factory=lambda: BertConfig(
            hidden_size=768, num_layers=12, num_heads=12,
            intermediate_size=3072, fusion_layer=0,  # cross-attention everywhere
        ))


class QFormer(nn.Module):
    """vision tokens (B, N, Dv) -> (B, num_queries, hidden)."""

    def __init__(self, cfg: QFormerConfig, vision_width: int, *, device,
                 generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        h = cfg.bert.hidden_size
        self.query_tokens = nn.Parameter(
            torch.empty(1, cfg.num_queries, h, dtype=torch.float32, device=device))
        self.vision_in = Dense(vision_width, h, device=device)
        trunc_normal_(self.query_tokens, 0.02, generator)
        self.vision_in.init_weights(generator)
        self.bert = BertModel(cfg.bert, device=device, generator=generator, fusion_only=True)

    def forward(self, vision_tokens: torch.Tensor, deterministic: bool = True,
                generator=None) -> torch.Tensor:
        vis = self.vision_in(vision_tokens)
        queries = self.query_tokens.to(vis.dtype).expand(vis.shape[0], -1, -1)
        return self.bert(encoder_embeds=queries, vision_embeds=vis, mode="fusion",
                         deterministic=deterministic, generator=generator).last_hidden_state


@dataclasses.dataclass(frozen=True)
class VideoChatConfig:
    """Same fields and defaults as internvideo_tpu's VideoChatConfig."""

    vision: InternVideo2Config = dataclasses.field(default_factory=InternVideo2Config)
    qformer: QFormerConfig = dataclasses.field(default_factory=QFormerConfig)
    llm: LLMConfig = dataclasses.field(default_factory=LLMConfig)


class VideoChat(nn.Module):
    def __init__(self, config: VideoChatConfig, *, device, generator: torch.Generator):
        super().__init__()
        self.config = cfg = config
        self.vision_encoder = InternVideo2(cfg.vision, device=device, generator=generator)
        self.qformer = QFormer(cfg.qformer, cfg.vision.embed_dim, device=device,
                               generator=generator)
        self.llm_proj = Dense(cfg.qformer.bert.hidden_size, cfg.llm.hidden_size, device=device)
        self.llm_proj.init_weights(generator)
        self.language_model = MLATransformer(cfg.llm, device=device, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.language_model.device

    @property
    def cache_prefix_len(self) -> int:
        """Cache entries `prefill` writes ahead of the prompt: the queries."""
        return self.config.qformer.num_queries

    def encode_video_queries(self, video: torch.Tensor, deterministic: bool = True,
                             generator=None) -> torch.Tensor:
        """(B, T, H, W, 3) -> (B, num_queries, D_llm) fp32."""
        out = self.vision_encoder(video, deterministic=deterministic, generator=generator)
        q = self.qformer(out.tokens, deterministic=deterministic, generator=generator)
        return self.llm_proj(q)

    def _prompt_embeds(self, input_ids, video, deterministic: bool = True):
        vis = self.encode_video_queries(video, deterministic)
        txt = self.language_model.embed_tokens(input_ids)
        return torch.cat([vis.to(txt.dtype), txt], dim=1)

    def forward(self, input_ids: torch.Tensor, video: torch.Tensor, deterministic: bool = True,
                with_logits: bool = True) -> LLMOutput:
        """Teacher-forcing forward over [video queries | prompt]."""
        return self.language_model(input_embeds=self._prompt_embeds(input_ids, video,
                                                                    deterministic),
                                   with_logits=with_logits)

    # --- generation -------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        return self.language_model.init_cache(batch, max_len, dtype)

    def prefill(self, input_ids, video, caches) -> LLMOutput:
        """[video queries | prompt] into the dense caches (in place, entries
        0 .. num_queries + prompt_len - 1); the last position's logits."""
        return self.language_model.prefill(self._prompt_embeds(input_ids, video), caches)

    def decode_step(self, token_ids, caches, cache_len, **kw) -> LLMOutput:
        return self.language_model.decode_step(token_ids, caches, cache_len, **kw)
