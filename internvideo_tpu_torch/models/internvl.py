"""InternVL / Intern-S1 compose: InternViT encoder -> pixel-shuffle
projector -> (MoE) LLM.

Port of internvideo_tpu/models/internvl.py (:1-117). The vision side is
the InternVideo2 encoder at T = 1 (tubelet 1): InternS1's InternViT-6B
(3200 wide, 45 layers, RMSNorm + whole-dim QK-RMSNorm) or InternViT-300M
(1024 wide, 24 layers, LayerNorm, no QK-norm). Its tokens lose the CLS
token, go through the pixel shuffle (ratio 0.5: each 2 x 2 block of
patches stacked into the channels, in the order (row in block, column in
block, channel)) and the projector (LayerNorm -> Dense -> exact GELU ->
Dense into the text width), and replace the image placeholders of the
prompt (`scatter_visual`, as the VideoMLLM). The text model is the M2LA
`MLATransformer`, dense (Intern-S1-mini) or MoE (Intern-S1).

The encoder still builds its attention-pooling head (`num_classes=0` keeps
it), so the state_dict holds the JAX tree's parameters; the compose reads
only the tokens and skips the pool's compute (`with_pool=False`), as JAX's
jit drops that dead branch. The pool's parameters get no gradient, and
AdamW decays them as optax does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from internvideo_tpu_torch.models.internvideo2 import InternVideo2, InternVideo2Config
from internvideo_tpu_torch.models.llm import LLMConfig, LLMOutput, MLATransformer
from internvideo_tpu_torch.models.mllm import scatter_visual
from internvideo_tpu_torch.nn.dense import Dense
from internvideo_tpu_torch.nn.norms import LayerNorm


@dataclasses.dataclass(frozen=True)
class InternVLConfig:
    vision: InternVideo2Config = dataclasses.field(
        default_factory=lambda: InternVideo2Config(num_frames=1, tubelet_size=1, num_classes=0))
    text: LLMConfig = dataclasses.field(default_factory=LLMConfig)
    downsample_ratio: float = 0.5  # pixel-shuffle factor (0.5 -> 2 x 2 stack)
    image_token_id: int = 152957


def pixel_shuffle(x: torch.Tensor, ratio: float) -> torch.Tensor:
    """(B, H, W, C) -> (B, H r, W r, C / r^2): each s x s block of
    positions (s = 1 / r) stacked into the channels, in the order (row in
    block, column in block, channel)."""
    b, h, w, c = x.shape
    s = int(round(1.0 / ratio))
    x = x.reshape(b, h // s, s, w // s, s, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // s, w // s, c * s * s)


class InternVLChat(nn.Module):
    def __init__(self, cfg: InternVLConfig, *, device, generator: torch.Generator):
        super().__init__()
        self.config = cfg
        self.vision_tower = InternVideo2(cfg.vision, device=device, generator=generator)
        dtype = getattr(torch, cfg.text.dtype)
        kw = dict(dtype=dtype, param_dtype=getattr(torch, cfg.text.param_dtype), device=device)
        s = int(round(1.0 / cfg.downsample_ratio))
        width = cfg.vision.embed_dim * s * s
        self.mlp1_norm = LayerNorm(width, dtype=dtype, device=device)
        self.mlp1_fc1 = Dense(width, cfg.text.hidden_size, **kw)
        self.mlp1_fc2 = Dense(cfg.text.hidden_size, cfg.text.hidden_size, **kw)
        for d in (self.mlp1_fc1, self.mlp1_fc2):
            d.init_weights(generator)
        self.language_model = MLATransformer(cfg.text, device=device, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.language_model.device

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, n_tokens, text hidden): InternViT patches ->
        pixel shuffle -> LayerNorm + MLP projector."""
        cfg = self.config
        patches = self.vision_tower(images[:, None], with_pool=False).tokens[:, 1:]
        b, n, c = patches.shape
        g = int(round(n ** 0.5))
        x = pixel_shuffle(patches.reshape(b, g, g, c), cfg.downsample_ratio)
        x = self.mlp1_norm(x.reshape(b, -1, x.shape[-1]))
        return self.mlp1_fc2(F.gelu(self.mlp1_fc1(x)))

    def forward(self, input_ids: torch.Tensor, images: Optional[torch.Tensor] = None, *,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                with_logits: bool = True) -> LLMOutput:
        """input_ids (B, L) with `image_token_id` placeholders, one run of
        n_tokens a row; images (B, H, W, 3); position_ids (B, L);
        segment_ids (B, L) for packed rows."""
        lm = self.language_model
        embeds = lm.embed(input_ids)
        if images is not None:
            mask = input_ids == self.config.image_token_id
            embeds = scatter_visual(embeds, self.encode_images(images), mask)
        return lm(input_embeds=embeds, position_ids=position_ids, segment_ids=segment_ids,
                  with_logits=with_logits)
