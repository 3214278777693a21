"""InternVideo3-style video MLLM: vision tower -> patch mergers -> LLM.

Port of internvideo_tpu/models/mllm.py, the training forward and the
serving surfaces:

  * visual features from the tower's last block and its deepstack taps,
    each through its patch merger into the text width;
  * placeholder scatter (`scatter_visual`): the video / image token
    positions of input_ids take the visual embeddings, by a cumsum-gather
    with no dynamic shapes;
  * the deepstack features are added to the hidden states at the visual
    positions after each of the first len(deepstack) LLM layers (Qwen3-VL);
  * the text model is chosen by config class: an LLMConfig gives the M2LA
    transformer (models/llm.py), a GQAConfig the dense-GQA one
    (models/llm_gqa.py, the Qwen3-VL-dense compose); both take mRoPE and
    packed-sequence segment ids, each layer under `torch.utils.checkpoint`
    when the config sets `remat`;
  * with `hico_tokens_per_frame` (the InternVideo2.5 recipe) the merged
    tokens of each temporal frame are compressed by `hico_compress` before
    the LLM, and the deepstack taps are off;
  * serving: the dense cache (`init_cache`, `prefill`, `decode_step`) and,
    for the M2LA text model, the page pools (`prefill_paged`,
    `decode_step_paged`); the prompt pass scatters the visual tokens and
    adds the deepstack residuals as the forward does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from internvideo_tpu_torch.models.llm import (
    LLMConfig,
    LLMOutput,
    MLATransformer,
    _write_positions,
)
from internvideo_tpu_torch.models.llm_gqa import GQATransformer
from internvideo_tpu_torch.models.vision_tower import PatchMerger, VisionTower, VisionTowerConfig


@dataclasses.dataclass(frozen=True)
class MLLMConfig:
    vision: VisionTowerConfig = dataclasses.field(default_factory=VisionTowerConfig)
    # LLMConfig (M2LA) or llm_gqa.GQAConfig (the dense Qwen3-VL compose)
    text: object = dataclasses.field(default_factory=LLMConfig)
    # HiCo token budget per merged frame (None = no compression)
    hico_tokens_per_frame: Optional[int] = None
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653


def scatter_visual(text_embeds: torch.Tensor, visual_embeds: torch.Tensor,
                   visual_mask: torch.Tensor) -> torch.Tensor:
    """Place visual_embeds (B, Nv, D) at the True positions of visual_mask
    (B, L): position j takes visual row (cumsum of the mask up to j) - 1,
    clipped to [0, Nv - 1]; the other positions keep text_embeds. Rows past
    the real visual count are never selected while mask.sum(1) == Nv."""
    idx = torch.cumsum(visual_mask.to(torch.int32), dim=1) - 1
    idx = idx.clamp(0, visual_embeds.shape[1] - 1).long()
    gathered = torch.gather(visual_embeds, 1,
                            idx[..., None].expand(-1, -1, visual_embeds.shape[-1]))
    return torch.where(visual_mask[..., None], gathered.to(text_embeds.dtype), text_embeds)


def hico_compress(frame_tokens: torch.Tensor, target_tokens: int, *, refine_iters: int = 2,
                  temp: float = 50.0) -> torch.Tensor:
    """HiCo-style per-frame token compression: (B, T, N, D) -> (B, T, K, D).

    The JAX package's own formulation (internvideo_tpu/models/mllm.py:295;
    the reference documents only the 16-tokens-per-frame budget), so that
    function is its only reference:

      1. farthest-point sampling over cosine distance picks K seed tokens
         (K steps; the first seed is token 0, ties take the lowest index);
      2. max(refine_iters, 1) soft-Lloyd steps: a softmax at `temp` of the
         cosine similarities to the centroids assigns the tokens, and the
         centroids become the assignment-weighted token means.

    The outputs are those unnormalised token means. Plain torch: no kernel
    lies behind it on either package.
    """
    b, t, n, d = frame_tokens.shape
    k = target_tokens
    x = frame_tokens.reshape(b * t, n, d)
    xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-6)
    idx = torch.zeros((b * t, k), dtype=torch.long, device=x.device)
    d_min = torch.full((b * t, n), float("inf"), device=x.device)
    for i in range(k):
        nxt = d_min.argmax(dim=1)
        idx[:, i] = nxt
        picked = torch.gather(xn, 1, nxt[:, None, None].expand(-1, 1, d))
        d_min = torch.minimum(d_min, 1.0 - torch.einsum("bnd,bqd->bn", xn, picked))
    centroids = torch.gather(xn, 1, idx[..., None].expand(-1, -1, d))
    for _ in range(max(refine_iters, 1)):
        assign = torch.softmax(torch.einsum("bnd,bkd->bnk", xn, centroids) * temp, dim=-1)
        merged = torch.einsum("bnk,bnd->bkd", assign, x)
        merged = merged / (assign.sum(dim=1)[..., None] + 1e-6)
        centroids = merged / (torch.linalg.vector_norm(merged, dim=-1, keepdim=True) + 1e-6)
    return merged.reshape(b, t, k, d)


class VideoMLLM(nn.Module):
    def __init__(self, cfg: MLLMConfig, *, device, generator: torch.Generator):
        super().__init__()
        self.config = cfg
        self.vision_tower = VisionTower(cfg.vision, device=device, generator=generator)
        self.merger = PatchMerger(cfg.vision, device=device)
        # the deepstack mergers norm after the 2 x 2 shuffle; the main one before
        self.deepstack_merger = nn.ModuleList(
            PatchMerger(cfg.vision, use_postshuffle_norm=True, device=device)
            for _ in cfg.vision.deepstack_indexes)
        for m in (self.merger, *self.deepstack_merger):
            m.init_weights(generator)
        # the text flavour by config class: GQAConfig -> dense GQA
        text_cls = GQATransformer if hasattr(cfg.text, "num_kv_heads") else MLATransformer
        self.language_model = text_cls(cfg.text, device=device, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.language_model.device

    def encode_video(self, video: torch.Tensor):
        """(B, T, H, W, 3) -> (visual (B, Nv, D_text), [deepstack (B, Nv, D_text)]).

        With `hico_tokens_per_frame` = R the merged tokens of each of the
        T / temporal_patch_size frames are compressed to R (Nv = frames x R,
        the placeholder count the prompt must carry) and the deepstack taps
        are off: their positions would not survive the compression."""
        cfg = self.config
        tokens, taps = self.vision_tower(video)
        visual = self.merger(tokens)
        if cfg.hico_tokens_per_frame:
            frames = video.shape[1] // cfg.vision.temporal_patch_size
            b, nv, d = visual.shape
            r = cfg.hico_tokens_per_frame
            visual = hico_compress(visual.reshape(b, frames, nv // frames, d), r)
            return visual.reshape(b, frames * r, d), []
        return visual, [m(t) for m, t in zip(self.deepstack_merger, taps)]

    def _prompt_embeds(self, input_ids, video):
        """(token embeddings with the visual tokens scattered in, the
        deepstack residuals at the visual positions or None)."""
        cfg = self.config
        embeds = self.language_model.embed(input_ids)
        if video is None:
            return embeds, None
        visual, taps = self.encode_video(video)
        vmask = (input_ids == cfg.video_token_id) | (input_ids == cfg.image_token_id)
        embeds = scatter_visual(embeds, visual, vmask)
        zeros = torch.zeros_like(embeds)
        return embeds, [scatter_visual(zeros, d, vmask) for d in taps]

    def forward(self, input_ids: torch.Tensor, video: Optional[torch.Tensor] = None, *,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                with_logits: bool = True) -> LLMOutput:
        """input_ids (B, L) with video placeholders; video (B, T, H, W, 3);
        position_ids (3, B, L) mRoPE grids or (B, L); segment_ids (B, L)."""
        embeds, deepstack = self._prompt_embeds(input_ids, video)
        return self._run_llm(embeds, deepstack, position_ids, segment_ids, with_logits)

    def _run_llm(self, x, deepstack, position_ids, segment_ids, with_logits) -> LLMOutput:
        lm = self.language_model
        b, s, _ = x.shape
        if position_ids is None:
            position_ids = lm._positions(b, s)
        cos, sin = lm._rope(position_ids)
        for i in range(len(lm.layers)):
            x = lm.run_layer(i, x, cos, sin, segment_ids)
            if deepstack is not None and i < len(deepstack):
                x = x + deepstack[i]
        x = lm.norm(x)
        return LLMOutput(logits=lm._head(x) if with_logits else None, hidden=x)

    # --- serving ----------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        return self.language_model.init_cache(batch, max_len, dtype)

    def _prompt_pass(self, input_ids, video, position_ids, attend):
        """The prompt through the LLM: `attend(i, layer, xn, cos, sin)`
        returns layer i's attention output (filling its cache); the
        deepstack residuals are added after the first len(deepstack)
        layers. Returns the final-normed hidden states."""
        lm = self.language_model
        x, deepstack = self._prompt_embeds(input_ids, video)
        b, s, _ = x.shape
        if position_ids is None:
            position_ids = lm._positions(b, s)
        cos, sin = lm._rope(position_ids)
        for i, layer in enumerate(lm.layers):
            x = x + attend(i, layer, layer.input_layernorm(x), cos, sin)
            x = x + layer.mlp(layer.post_attention_layernorm(x))
            if deepstack is not None and i < len(deepstack):
                x = x + deepstack[i]
        return lm.norm(x)

    def prefill(self, input_ids, video, caches, *, position_ids=None) -> LLMOutput:
        """The prompt (with its video) into the dense caches, in place;
        returns the last-position logits."""
        x = self._prompt_pass(
            input_ids, video, position_ids,
            lambda i, layer, xn, cos, sin: layer.self_attn.prefill(xn, cos, sin, caches[i], 0)[0])
        return LLMOutput(logits=self._head(x[:, -1:]), hidden=x, caches=caches)

    def decode_step(self, token_ids, caches, cache_len, *, position_ids=None) -> LLMOutput:
        return self.language_model.decode_step(token_ids, caches, cache_len,
                                               position_ids=position_ids)

    def _head(self, h):
        """LM-head delegate (the ServingEngine samples from it directly)."""
        return self.language_model._head(h)

    def prefill_paged(self, input_ids, video, pages, block_tables, page_size: int, *,
                      position_ids=None) -> LLMOutput:
        """The prompt pass writing each layer's latent entries at token
        positions 0..S-1 of the page pools (in place), then causal
        self-attention over the prompt (K5 on the kernel route). The M2LA
        text model only: the dense-GQA flavour serves from its dense cache."""
        if not hasattr(self.config.text, "mla"):
            raise ValueError("paged prefill drives the latent (M2LA) page pools; the dense-GQA "
                             "text model uses its (B, L, Hkv, D) cache")
        b, s = input_ids.shape
        write_pos = torch.arange(s, device=input_ids.device)[None].expand(b, s)

        def attend(i, layer, xn, cos, sin):
            entries = layer.self_attn.compute_cache_entry(xn, cos, sin)
            _write_positions(pages[i], entries, block_tables, write_pos, page_size)
            return layer.self_attn(xn, cos, sin, causal=True)

        x = self._prompt_pass(input_ids, video, position_ids, attend)
        return LLMOutput(logits=self._head(x[:, -1:]), hidden=x, caches=pages)

    def decode_step_paged(self, token_ids, pages, block_tables, seq_lens, page_size: int, *,
                          impl: Optional[str] = None) -> LLMOutput:
        return self.language_model.decode_step_paged(token_ids, pages, block_tables, seq_lens,
                                                     page_size, impl=impl)
