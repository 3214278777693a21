"""Decoder-only language model (Qwen3-MLA style): the M2LA LLM serving path.

Port of internvideo_tpu/models/llm.py: the text tower of InternVideo3-8B
(36 layers, hidden 4096, SwiGLU 12288, MLA with kv_lora_rank 896 and
128 / 128 / 128 rope / nope / v dims, rope_theta 5e6, mRoPE [24, 20, 20]).
Layer = RMSNorm -> MLA -> residual; RMSNorm -> SwiGLU -> residual.

Surfaces: the full forward (training: packed segment ids, and with
`remat` each layer under `torch.utils.checkpoint(use_reentrant=False)`, the
JAX `nn.remat(_DecoderLayer)` :193-194, when autograd is on), the dense
latent cache (`init_cache`, `prefill`, `decode_step`) and the paged one
(`init_paged_cache`, `prefill_paged`, `decode_step_paged`), whose pools are
written in place. `quant="int8_wo"` / `"int8_mix"` (serving) builds the
attention projections (nn/mla.py), the SwiGLU's gate, up and down and the
lm_head as `ops/quant.py:Int8WoDense`; under int8_mix the layer projections
take K7 at >= INT8_MIX_DYN_M flattened rows and the lm_head stays
weight-only (JAX models/llm.py:85-100, 204-215).

With `moe` (a nn/moe.py MoEConfig) every layer past the first
`moe_first_k_dense` takes an `MoEMlp` as its `mlp` (the rest keep a
SwiGLU); every caller reaches it through `DecoderLayer.feed_forward`, as
JAX's `_mlp` (:137-157). Each MoE layer keeps its last aux loss (JAX sows
it into "intermediates"), and every pass returns their sum as
`LLMOutput.moe_aux_loss` (`moe_aux_losses`). `fp8` raises
NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from internvideo_tpu_torch.nn.dense import trunc_normal_
from internvideo_tpu_torch.nn.mla import MLAConfig, MLAttention
from internvideo_tpu_torch.nn.moe import MoEMlp
from internvideo_tpu_torch.nn.norms import RMSNorm
from internvideo_tpu_torch.nn.paged_cache import paged_write
from internvideo_tpu_torch.nn.rope import YarnConfig, mrope_cos_sin, rope_cos_sin
from internvideo_tpu_torch.ops.quant import serving_dense


@dataclasses.dataclass(frozen=True)
class LLMConfig:
    vocab_size: int = 151936
    hidden_size: int = 4096
    num_layers: int = 36
    intermediate_size: int = 12288
    rms_norm_eps: float = 1e-6
    rope_theta: float = 5_000_000.0
    mrope_section: Optional[tuple[int, int, int]] = (24, 20, 20)
    rope_scaling: Optional[YarnConfig] = None
    mla: MLAConfig = dataclasses.field(default_factory=MLAConfig)
    moe: "object | None" = None
    moe_first_k_dense: int = 0
    tie_word_embeddings: bool = False
    fp8: Optional[str] = None
    quant: Optional[str] = None
    dtype: str = "float32"
    param_dtype: str = "float32"
    attn_impl: str = "auto"
    remat: bool = False


@dataclasses.dataclass
class LLMOutput:
    logits: Optional[torch.Tensor]
    hidden: torch.Tensor
    caches: Optional[list] = None
    # a MoE model's summed per-layer aux losses (None without MoE layers)
    moe_aux_loss: Optional[torch.Tensor] = None


def _check_options(cfg: LLMConfig) -> None:
    if cfg.quant not in (None, "int8_wo", "int8_mix"):
        raise ValueError(f"unknown quant {cfg.quant!r}; None, 'int8_wo' or 'int8_mix'")
    if cfg.fp8 is not None:
        raise NotImplementedError(f"fp8={cfg.fp8!r} is not ported yet (ROADMAP queue 1, item 10)")


class SwiGLU(nn.Module):
    """down(silu(gate(x)) * up(x)); with `quant` the three projections are
    Int8WoDense (int8_mix: K7 at >= INT8_MIX_DYN_M rows)."""

    def __init__(self, dim: int, intermediate: int, *, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, quant: Optional[str] = None,
                 device=None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, param_dtype=param_dtype, device=device)
        self.gate_proj = serving_dense(quant, dim, intermediate, **kw)
        self.up_proj = serving_dense(quant, dim, intermediate, **kw)
        self.down_proj = serving_dense(quant, intermediate, dim, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class DecoderLayer(nn.Module):
    """`dense_mlp`: a SwiGLU even in a MoE model (its first_k_dense layers)."""

    def __init__(self, cfg: LLMConfig, *, dense_mlp: bool = False, device=None):
        super().__init__()
        dtype, pdtype = getattr(torch, cfg.dtype), getattr(torch, cfg.param_dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, dtype=dtype,
                                       device=device)
        self.self_attn = MLAttention(cfg.mla, dtype=dtype, param_dtype=pdtype,
                                     attn_impl=cfg.attn_impl, quant=cfg.quant, device=device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps,
                                                dtype=dtype, device=device)
        self.is_moe = cfg.moe is not None and not dense_mlp
        if self.is_moe:
            self.mlp = MoEMlp(cfg.moe, cfg.hidden_size, dtype=dtype, param_dtype=pdtype,
                              device=device)
        else:
            self.mlp = SwiGLU(cfg.hidden_size, cfg.intermediate_size, dtype=dtype,
                              param_dtype=pdtype, quant=cfg.quant, device=device)
        self.moe_aux_loss: Optional[torch.Tensor] = None

    def feed_forward(self, x):
        """The layer's MLP on the normed `x`; a MoE layer keeps its aux loss
        in `moe_aux_loss` (JAX's sow)."""
        out = self.mlp(x)
        if not self.is_moe:
            return out
        self.moe_aux_loss = out.aux_loss
        return out.output

    def forward(self, x, cos, sin, segment_ids=None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, q_segment_ids=segment_ids,
                               kv_segment_ids=segment_ids, causal=True)
        return x + self.feed_forward(self.post_attention_layernorm(x))

    def decode(self, x, cos, sin, cache, cache_len):
        h, cache = self.self_attn.decode(self.input_layernorm(x), cos, sin, cache, cache_len)
        x = x + h
        return x + self.feed_forward(self.post_attention_layernorm(x)), cache


class Embedding(nn.Module):
    """Token table (vocab, hidden) in param_dtype; lookups cast to dtype."""

    def __init__(self, vocab: int, dim: int, *, dtype, param_dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(vocab, dim, dtype=param_dtype, device=device))

    def forward(self, ids):
        return self.weight[ids].to(self.dtype)

    def attend(self, h):
        """Tied output head: h @ table^T in dtype."""
        return F.linear(h.to(self.dtype), self.weight.to(self.dtype))


class MLATransformer(nn.Module):
    def __init__(self, cfg: LLMConfig, *, device, generator: torch.Generator):
        super().__init__()
        _check_options(cfg)
        self.cfg = cfg
        dtype, pdtype = getattr(torch, cfg.dtype), getattr(torch, cfg.param_dtype)
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype,
                                      param_dtype=pdtype, device=device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, dense_mlp=i < cfg.moe_first_k_dense,
                                                 device=device)
                                    for i in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, dtype=dtype, device=device)
        if not cfg.tie_word_embeddings:
            # weight-only even under int8_mix: prefill scores the last position only
            self.lm_head = serving_dense(cfg.quant and "int8_wo", cfg.hidden_size,
                                         cfg.vocab_size, bias=False, dtype=dtype,
                                         param_dtype=pdtype, device=device)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Truncated normal (std 0.02) tables, kernels, kv_b, routers, expert
        stacks and expert biases; zero dense biases; unit norm weights (set
        at construction)."""
        trunc_normal_(self.embed_tokens.weight, 0.02, generator)
        for layer in self.layers:
            layer.self_attn.init_weights(generator)
            if layer.is_moe:
                layer.mlp.init_weights(generator)
                continue
            for d in (layer.mlp.gate_proj, layer.mlp.up_proj, layer.mlp.down_proj):
                d.init_weights(generator)
        if not self.cfg.tie_word_embeddings:
            self.lm_head.init_weights(generator)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def run_layer(self, i: int, x, cos, sin, segment_ids=None):
        """Decoder layer i; with `remat` and autograd on, its activations are
        recomputed in the backward instead of kept."""
        layer = self.layers[i]
        if self.cfg.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(layer, x, cos, sin, segment_ids,
                                                     use_reentrant=False)
        return layer(x, cos, sin, segment_ids)

    def _rope(self, position_ids):
        cfg = self.cfg
        rope_dim = cfg.mla.qk_rope_head_dim
        if position_ids.dim() == 3 and cfg.mrope_section:
            return mrope_cos_sin(position_ids, rope_dim, cfg.mrope_section, cfg.rope_theta)
        if position_ids.dim() == 3:
            position_ids = position_ids[0]
        return rope_cos_sin(position_ids, rope_dim, cfg.rope_theta, cfg.rope_scaling)

    def _output(self, logits, x, caches=None) -> LLMOutput:
        return LLMOutput(logits=logits, hidden=x, caches=caches,
                         moe_aux_loss=moe_aux_losses(self) if self.cfg.moe is not None else None)

    def _head(self, h):
        if self.cfg.tie_word_embeddings:
            return self.embed_tokens.attend(h)
        return self.lm_head(h)

    def embed(self, input_ids):
        return self.embed_tokens(input_ids)

    def _positions(self, b: int, s: int):
        return torch.arange(s, device=self.device)[None].expand(b, s)

    def forward(self, input_ids=None, *, input_embeds=None, position_ids=None,
                segment_ids=None, with_logits: bool = True) -> LLMOutput:
        x = input_embeds if input_embeds is not None else self.embed(input_ids)
        b, s, _ = x.shape
        if position_ids is None:
            position_ids = self._positions(b, s)
        cos, sin = self._rope(position_ids)
        for i in range(len(self.layers)):
            x = self.run_layer(i, x, cos, sin, segment_ids)
        x = self.norm(x)
        return self._output(self._head(x) if with_logits else None, x)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        return [torch.zeros((batch, max_len, self.cfg.mla.cache_dim), dtype=dtype,
                            device=self.device) for _ in range(self.cfg.num_layers)]

    def prefill(self, input_embeds, caches, *, position_ids=None) -> LLMOutput:
        """Run the prompt, fill the latent caches (in place), return the
        last-position logits."""
        b, s, _ = input_embeds.shape
        if position_ids is None:
            position_ids = self._positions(b, s)
        cos, sin = self._rope(position_ids)
        x = input_embeds
        for layer, cache in zip(self.layers, caches):
            h, _ = layer.self_attn.prefill(layer.input_layernorm(x), cos, sin, cache, 0)
            x = x + h
            x = x + layer.feed_forward(layer.post_attention_layernorm(x))
        x = self.norm(x)
        return self._output(self._head(x[:, -1:]), x, caches)

    def decode_step(self, token_ids, caches, cache_len, *, position_ids=None) -> LLMOutput:
        x = self.embed_tokens(token_ids)
        b = x.shape[0]
        if position_ids is None:
            position_ids = torch.full((b, 1), int(cache_len), dtype=torch.int32,
                                      device=self.device)
        cos, sin = self._rope(position_ids)
        for layer, cache in zip(self.layers, caches):
            x, _ = layer.decode(x, cos, sin, cache, cache_len)
        x = self.norm(x)
        return self._output(self._head(x), x, caches)

    def prefill_paged(self, input_ids, pages, block_tables, page_size: int, *,
                      input_embeds=None, position_ids=None) -> LLMOutput:
        """Prompt pass writing latent entries into the page pools (in
        place); attention is plain causal self-attention over the prompt
        (K5 on the kernel route)."""
        x = input_embeds if input_embeds is not None else self.embed_tokens(input_ids)
        b, s, _ = x.shape
        if position_ids is None:
            position_ids = self._positions(b, s)
        cos, sin = self._rope(position_ids)
        for layer, pool in zip(self.layers, pages):
            xn = layer.input_layernorm(x)
            entries = layer.self_attn.compute_cache_entry(xn, cos, sin)
            _write_positions(pool, entries, block_tables, position_ids, page_size)
            x = x + layer.self_attn(xn, cos, sin, causal=True)
            x = x + layer.feed_forward(layer.post_attention_layernorm(x))
        x = self.norm(x)
        return self._output(self._head(x[:, -1:]), x, pages)

    def decode_step_paged(self, token_ids, pages, block_tables, seq_lens, page_size: int, *,
                          impl: Optional[str] = None) -> LLMOutput:
        """One decode step over the paged pools: write each token's latent
        entry at position seq_lens[b], then absorbed paged attention over
        seq_lens + 1 tokens (K6 on the kernel route)."""
        x = self.embed_tokens(token_ids)
        positions = seq_lens[:, None].to(torch.int32)  # (B, 1)
        cos, sin = self._rope(positions)
        for layer, pool in zip(self.layers, pages):
            xn = layer.input_layernorm(x)
            entry = layer.self_attn.compute_cache_entry(xn, cos, sin)
            _write_positions(pool, entry, block_tables, positions, page_size)
            x = x + layer.self_attn.decode_paged(xn, cos, sin, pool, block_tables, seq_lens + 1,
                                                 impl=impl)
            x = x + layer.feed_forward(layer.post_attention_layernorm(x))
        x = self.norm(x)
        return self._output(self._head(x), x, pages)


def init_paged_cache(cfg, batch: int, max_len: int, page_size: int = 64,
                     dtype=torch.bfloat16, device=None):
    """Zeroed page pools (one per layer) + block tables for a fixed batch:
    sequence b's page j is pool page b * pages_per_seq + j. Returns
    (pages_per_layer, block_tables (B, pages_per_seq) int32)."""
    pages_per_seq = -(-max_len // page_size)
    n_pages = batch * pages_per_seq
    pages = [torch.zeros((n_pages, page_size, cfg.mla.cache_dim), dtype=dtype, device=device)
             for _ in range(cfg.num_layers)]
    tables = torch.arange(n_pages, dtype=torch.int32, device=device).reshape(batch, pages_per_seq)
    return pages, tables


def _write_positions(pages, entries, tables, positions, page_size: int):
    """Scatter (B, S, C) entries at token `positions` (B, S) into the pool
    in place."""
    b, s, c = entries.shape
    positions = positions.long()
    pids = torch.gather(tables.long(), 1, positions // page_size).reshape(-1)
    return paged_write(pages, entries.reshape(-1, c), pids, (positions % page_size).reshape(-1))


def moe_aux_losses(model) -> torch.Tensor:
    """The sum of the aux losses the MoE layers of `model` (an
    MLATransformer) kept on their last pass: JAX's `moe_aux_losses` over
    the sown losses (:451-458). 0.0 when the model has no MoE layer."""
    total = torch.zeros((), dtype=torch.float32, device=model.device)
    for layer in model.layers:
        if layer.is_moe and layer.moe_aux_loss is not None:
            total = total + layer.moe_aux_loss
    return total
