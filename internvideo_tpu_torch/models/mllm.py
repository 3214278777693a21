"""InternVideo3-style video MLLM: vision tower -> patch mergers -> MLA LLM.

Port of internvideo_tpu/models/mllm.py, the training forward:

  * visual features from the tower's last block and its deepstack taps,
    each through its patch merger into the text width;
  * placeholder scatter (`scatter_visual`): the video / image token
    positions of input_ids take the visual embeddings, by a cumsum-gather
    with no dynamic shapes;
  * the deepstack features are added to the hidden states at the visual
    positions after each of the first len(deepstack) LLM layers (Qwen3-VL);
  * the text model is the M2LA transformer (models/llm.py) with mRoPE and
    packed-sequence segment ids, each layer under `torch.utils.checkpoint`
    when the config sets `remat`.

Not in this slice (the multimodal serving slice, ROADMAP "Next slice"):
HiCo compression (`hico_tokens_per_frame`, `hico_compress`), the video
prefill and decode surfaces, and a dense GQA text model; each raises
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from internvideo_tpu_torch.models.llm import LLMConfig, LLMOutput, MLATransformer
from internvideo_tpu_torch.models.vision_tower import PatchMerger, VisionTower, VisionTowerConfig

_SERVING = "is not ported yet (ROADMAP: the multimodal serving slice)"


@dataclasses.dataclass(frozen=True)
class MLLMConfig:
    vision: VisionTowerConfig = dataclasses.field(default_factory=VisionTowerConfig)
    text: LLMConfig = dataclasses.field(default_factory=LLMConfig)
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


def hico_compress(frame_tokens, target_tokens, **kwargs):
    raise NotImplementedError(f"HiCo token compression {_SERVING}")


class VideoMLLM(nn.Module):
    def __init__(self, cfg: MLLMConfig, *, device, generator: torch.Generator):
        super().__init__()
        if hasattr(cfg.text, "num_kv_heads"):
            raise NotImplementedError(f"a dense GQA text model (llm_gqa.py) {_SERVING}")
        self.config = cfg
        self.vision_tower = VisionTower(cfg.vision, device=device, generator=generator)
        self.merger = PatchMerger(cfg.vision, device=device)
        # the deepstack mergers norm after the 2 x 2 shuffle; the main one before
        self.deepstack_merger = nn.ModuleList(
            PatchMerger(cfg.vision, use_postshuffle_norm=True, device=device)
            for _ in cfg.vision.deepstack_indexes)
        for m in (self.merger, *self.deepstack_merger):
            m.init_weights(generator)
        self.language_model = MLATransformer(cfg.text, device=device, generator=generator)

    def encode_video(self, video: torch.Tensor):
        """(B, T, H, W, 3) -> (visual (B, Nv, D_text), [deepstack (B, Nv, D_text)])."""
        if self.config.hico_tokens_per_frame:
            raise NotImplementedError(f"hico_tokens_per_frame (HiCo compression) {_SERVING}")
        tokens, taps = self.vision_tower(video)
        return self.merger(tokens), [m(t) for m, t in zip(self.deepstack_merger, taps)]

    def forward(self, input_ids: torch.Tensor, video: Optional[torch.Tensor] = None, *,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                with_logits: bool = True) -> LLMOutput:
        """input_ids (B, L) with video placeholders; video (B, T, H, W, 3);
        position_ids (3, B, L) mRoPE grids or (B, L); segment_ids (B, L)."""
        cfg = self.config
        embeds = self.language_model.embed(input_ids)
        deepstack = None
        if video is not None:
            visual, taps = self.encode_video(video)
            vmask = (input_ids == cfg.video_token_id) | (input_ids == cfg.image_token_id)
            embeds = scatter_visual(embeds, visual, vmask)
            zeros = torch.zeros_like(embeds)
            deepstack = [scatter_visual(zeros, d, vmask) for d in taps]
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

    def init_cache(self, *args, **kwargs):
        raise NotImplementedError(f"VideoMLLM.init_cache {_SERVING}")

    def prefill(self, *args, **kwargs):
        raise NotImplementedError(f"the video prefill {_SERVING}")

    def decode_step(self, *args, **kwargs):
        raise NotImplementedError(f"VideoMLLM.decode_step {_SERVING}")

    def prefill_paged(self, *args, **kwargs):
        raise NotImplementedError(f"the paged video prefill {_SERVING}")

    def decode_step_paged(self, *args, **kwargs):
        raise NotImplementedError(f"VideoMLLM.decode_step_paged {_SERVING}")
