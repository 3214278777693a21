"""BERT text / fusion tower of VideoCLIP stage 2: PyTorch port.

Port of internvideo_tpu/models/bert.py: layers below `fusion_layer` are
text-only, layers from it up also cross-attend to vision tokens; three run
modes, "text" (layers [0, fusion_layer)), "fusion" (precomputed token
embeds enter at fusion_layer) and "multimodal" (all layers); an optional MLM
head (dense -> exact gelu -> LayerNorm -> decoder to the vocabulary).

Attention with a padding mask (self-attention with `attention_mask`,
cross-attention with `vision_mask`) is the plain einsum path of :82-97:
fp32 logits (q and k widened, so the logits are not rounded to `dtype`), the
additive NEG_INF bias, an fp32 softmax, probabilities cast to v's dtype, the
second product in fp32, cast to `dtype`. Without a mask it goes through
`dot_product_attention` (:98-102): K2 or K1 on the card (cross-attention to
the 1B tower's 1025 tokens takes K1, as in JAX).

The cross-attention key / value projections read the vision width, which
flax infers at init and `BertConfig` does not hold: `BertModel` takes it as
`vision_width` (default: hidden_size). Every layer, cross-attention and MLM
head is built whatever the mode (JAX creates the ones its init mode
touches), except with `fusion_only=True`: then only the layers exist, as in
a JAX tree that only ever ran mode "fusion" (the chat QFormer's). Submodules
carry the flax names, so `models/convert.py` maps a JAX tree onto them.

Dropout (rate `cfg.dropout`) is active only with `deterministic=False` and
an explicit torch.Generator on the activations' device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from internvideo_tpu_torch.models.llm import Embedding
from internvideo_tpu_torch.nn.dense import Dense, trunc_normal_
from internvideo_tpu_torch.nn.norms import LayerNorm
from internvideo_tpu_torch.ops.attention import dot_product_attention
from internvideo_tpu_torch.ops.attention_xla import NEG_INF


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """Same fields and defaults as internvideo_tpu's BertConfig."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    fusion_layer: int = 9
    layer_norm_eps: float = 1e-12
    dropout: float = 0.1
    dtype: str = "float32"
    param_dtype: str = "float32"
    attn_impl: str = "auto"


@dataclasses.dataclass
class BertOutput:
    last_hidden_state: torch.Tensor  # (B, L, H)
    pooled: torch.Tensor  # (B, H): the CLS token
    mlm_logits: Optional[torch.Tensor] = None  # (B, L, vocab)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout`: keep with probability 1 - rate, scale kept values
    by 1 / (1 - rate); identity when deterministic or the rate is 0."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def padding_bias(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(B, L) 1 / 0 mask -> (B, 1, 1, L) additive fp32 bias (0 keep, NEG_INF
    drop), as `_padding_bias` (:157-163)."""
    if mask is None:
        return None
    return torch.where(mask[:, None, None, :] > 0, 0.0, NEG_INF).to(torch.float32)


class BertAttention(nn.Module):
    """`_BertSelfAttention` (:58-107): self-attention, or cross-attention
    with key / value projections from `kv_width`."""

    def __init__(self, cfg: BertConfig, kv_width: int, *, device):
        super().__init__()
        self.cfg = cfg
        self.attn_impl = cfg.attn_impl  # the unmasked route; settable, as Attention's
        self.dtype = getattr(torch, cfg.dtype)
        kw = dict(dtype=self.dtype, param_dtype=getattr(torch, cfg.param_dtype), device=device)
        d = cfg.hidden_size
        self.query = Dense(d, d, **kw)
        self.key = Dense(kv_width, d, **kw)
        self.value = Dense(kv_width, d, **kw)
        self.proj = Dense(d, d, **kw)

    def forward(self, x, kv, attn_bias, deterministic: bool = True, generator=None):
        cfg = self.cfg
        b, lq, d = x.shape
        heads = (cfg.num_heads, d // cfg.num_heads)
        q = self.query(x).unflatten(-1, heads)
        k = self.key(kv).unflatten(-1, heads)
        v = self.value(kv).unflatten(-1, heads)
        if attn_bias is not None:
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * heads[1] ** -0.5
            probs = torch.softmax(logits + attn_bias, dim=-1).to(v.dtype)
            probs = dropout(probs, cfg.dropout, deterministic, generator)
            out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(self.dtype)
        else:
            out = dot_product_attention(q, k, v, impl=self.attn_impl)
            # the kernels have no probability hook: dropout on the output
            out = dropout(out, cfg.dropout, deterministic, generator)
        out = self.proj(out.reshape(b, lq, d))
        return dropout(out, cfg.dropout, deterministic, generator)


class BertLayer(nn.Module):
    """`_BertLayer` (:110-154): post-norm self-attention, cross-attention
    (fusion layers, when vision tokens are given), GELU MLP."""

    def __init__(self, cfg: BertConfig, has_cross: bool, vision_width: int, *, device):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
        kw = dict(dtype=dtype, param_dtype=getattr(torch, cfg.param_dtype), device=device)
        d = cfg.hidden_size

        def norm():
            return LayerNorm(d, eps=cfg.layer_norm_eps, dtype=dtype, device=device)

        self.attention = BertAttention(cfg, d, device=device)
        self.attention_norm = norm()
        if has_cross:
            self.crossattention = BertAttention(cfg, vision_width, device=device)
            self.crossattention_norm = norm()
        else:
            self.crossattention = self.crossattention_norm = None
        self.intermediate = Dense(d, cfg.intermediate_size, **kw)
        self.output = Dense(cfg.intermediate_size, d, **kw)
        self.output_norm = norm()

    def forward(self, x, self_bias, vision, vision_bias, deterministic: bool = True,
                generator=None):
        drop = dict(deterministic=deterministic, generator=generator)
        x = self.attention_norm(x + self.attention(x, x, self_bias, **drop))
        if self.crossattention is not None and vision is not None:
            x = self.crossattention_norm(
                x + self.crossattention(x, vision, vision_bias, **drop))
        ff = self.output(F.gelu(self.intermediate(x)))
        ff = dropout(ff, self.cfg.dropout, deterministic, generator)
        return self.output_norm(x + ff)


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig, *, vision_width: Optional[int] = None, device,
                 generator: torch.Generator, fusion_only: bool = False):
        super().__init__()
        self.cfg = cfg
        self.fusion_only = fusion_only
        dtype, pdtype = getattr(torch, cfg.dtype), getattr(torch, cfg.param_dtype)
        kw = dict(dtype=dtype, param_dtype=pdtype, device=device)
        d = cfg.hidden_size
        vision_width = d if vision_width is None else vision_width
        if not fusion_only:
            self.word_embeddings = Embedding(cfg.vocab_size, d, **kw)
            self.position_embeddings = Embedding(cfg.max_position_embeddings, d, **kw)
            self.token_type_embeddings = Embedding(cfg.type_vocab_size, d, **kw)
            self.embeddings_norm = LayerNorm(d, eps=cfg.layer_norm_eps, dtype=dtype,
                                             device=device)
        self.layer = nn.ModuleList(
            BertLayer(cfg, i >= cfg.fusion_layer, vision_width, device=device)
            for i in range(cfg.num_layers))
        if not fusion_only:
            self.mlm_transform = Dense(d, d, **kw)
            self.mlm_norm = LayerNorm(d, eps=cfg.layer_norm_eps, dtype=dtype, device=device)
            self.mlm_decoder = Dense(d, cfg.vocab_size, **kw)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init in module order: truncated-normal(0.02) embedding
        tables and Dense weights, zero biases; LayerNorms keep ones / zeros."""
        for m in self.modules():
            if isinstance(m, Embedding):
                trunc_normal_(m.weight, 0.02, generator)
            elif isinstance(m, Dense):
                m.init_weights(generator)

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,  # (B, L)
        attention_mask: Optional[torch.Tensor] = None,  # (B, L) 1 = keep
        *,
        encoder_embeds: Optional[torch.Tensor] = None,  # fusion-mode input (B, L, H)
        vision_embeds: Optional[torch.Tensor] = None,  # (B, Lv, vision_width)
        vision_mask: Optional[torch.Tensor] = None,  # (B, Lv)
        mode: str = "text",  # text | fusion | multimodal
        deterministic: bool = True,
        with_mlm_logits: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> BertOutput:
        cfg = self.cfg
        if self.fusion_only and (mode != "fusion" or with_mlm_logits):
            raise ValueError("a fusion_only BertModel runs mode 'fusion' without the MLM head")
        if mode == "fusion":
            if encoder_embeds is None:
                raise ValueError("mode 'fusion' needs encoder_embeds")
            x = encoder_embeds
            layers = range(cfg.fusion_layer, cfg.num_layers)
        elif mode in ("text", "multimodal"):
            pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
            x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
                 + self.token_type_embeddings(torch.zeros_like(input_ids)))
            x = dropout(self.embeddings_norm(x), cfg.dropout, deterministic, generator)
            # xbert.py:722-733: text = [0, fusion), multimodal = all layers
            layers = range(0, cfg.fusion_layer if mode == "text" else cfg.num_layers)
        else:
            raise ValueError(f"unknown mode {mode!r}")

        self_bias, vision_bias = padding_bias(attention_mask), padding_bias(vision_mask)
        vision = vision_embeds if mode != "text" else None
        for i in layers:
            x = self.layer[i](x, self_bias, vision, vision_bias, deterministic, generator)

        mlm_logits = None
        if with_mlm_logits:
            t = self.mlm_norm(F.gelu(self.mlm_transform(x)))
            mlm_logits = self.mlm_decoder(t)
        return BertOutput(last_hidden_state=x, pooled=x[:, 0], mlm_logits=mlm_logits)
