"""Dense-GQA causal LM (stock Qwen3 / LLaMA class).

Port of internvideo_tpu/models/llm_gqa.py: grouped-query attention with
optional per-head q/k RMSNorm, SwiGLU and RoPE (or mRoPE for the
Qwen3-VL-dense compose), and an optional sliding window. The method surface
is MLATransformer's (init_cache / prefill / decode_step, `run_layer`,
`_rope`, `_head`), so `models/generation.generate` and `models/mllm.VideoMLLM`
drive it unchanged.

KV cache: per layer a (B, max_len, Hkv, D) K and V tensor, written in place
(the JAX package returns updated copies).

Attention routes, as in JAX:

  * the full forward and the prompt prefill call `dot_product_attention`
    causal, with the config's window and `attn_impl`: on the card K5's
    grouped-query / windowed forward (csrc/flash_fwd_causal.cu, K/V heads
    read through their strides, never repeated), on the CPU its plain
    version. The training forward's backward (RL, train/rl_trainer.py) is
    K5's grouped-query / windowed backward (csrc/flash_bwd_causal_dq.cu,
    flash_bwd_causal_dkv.cu, the dk/dv kernel summing each group's q
    heads); with `remat` each layer is recomputed in the backward
    (`run_layer`);
  * decode attends on the plain route (`impl="xla"`, ops/attention_xla.py)
    over the whole cache, with the unwritten tail and the positions outside
    the window masked by kv segment ids (0 visible, -2 not) against q
    segment 0. That is the JAX design (:134-160), not a fallback: one query
    row per sequence has no tile for a flash kernel to fill.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from internvideo_tpu_torch.models.llm import Embedding, LLMOutput, SwiGLU
from internvideo_tpu_torch.nn.dense import Dense, trunc_normal_
from internvideo_tpu_torch.nn.norms import RMSNorm
from internvideo_tpu_torch.nn.rope import apply_rope, mrope_cos_sin, rope_cos_sin
from internvideo_tpu_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class GQAConfig:
    vocab_size: int = 151936
    hidden_size: int = 4096
    num_layers: int = 36
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: Optional[int] = None  # default hidden / num_heads
    intermediate_size: int = 12288
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    # 3D mRoPE sections for the Qwen3-VL-dense compose (None = plain 1D)
    mrope_section: Optional[tuple[int, int, int]] = None
    # sliding-window attention: each token attends to the last
    # `sliding_window` positions
    sliding_window: Optional[int] = None
    qk_norm: bool = True  # Qwen3 per-head q/k RMSNorm
    qkv_bias: bool = False
    tie_word_embeddings: bool = False
    dtype: str = "float32"
    param_dtype: str = "float32"
    attn_impl: str = "auto"
    remat: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads


class GQAAttention(nn.Module):
    def __init__(self, cfg: GQAConfig, *, device=None):
        super().__init__()
        self.cfg, self.attn_impl = cfg, cfg.attn_impl
        dtype, pdtype = getattr(torch, cfg.dtype), getattr(torch, cfg.param_dtype)
        hd, w = cfg.hd, cfg.hidden_size

        def dense(n_in, n_out, bias):
            return Dense(n_in, n_out, bias=bias, dtype=dtype, param_dtype=pdtype, device=device)

        self.q_proj = dense(w, cfg.num_heads * hd, cfg.qkv_bias)
        self.k_proj = dense(w, cfg.num_kv_heads * hd, cfg.qkv_bias)
        self.v_proj = dense(w, cfg.num_kv_heads * hd, cfg.qkv_bias)
        self.o_proj = dense(cfg.num_heads * hd, w, False)
        if cfg.qk_norm:  # over the head dim (Qwen3 q_norm / k_norm)
            self.q_norm = RMSNorm(hd, eps=cfg.rms_norm_eps, dtype=dtype, device=device)
            self.k_norm = RMSNorm(hd, eps=cfg.rms_norm_eps, dtype=dtype, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        for d in (self.q_proj, self.k_proj, self.v_proj, self.o_proj):
            d.init_weights(generator)

    def _qkv(self, x, cos, sin):
        cfg = self.cfg
        b, s, _ = x.shape
        q = self.q_proj(x).unflatten(-1, (cfg.num_heads, cfg.hd))
        k = self.k_proj(x).unflatten(-1, (cfg.num_kv_heads, cfg.hd))
        v = self.v_proj(x).unflatten(-1, (cfg.num_kv_heads, cfg.hd))
        if cfg.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    def _attend(self, q, k, v, **kw):
        out = dot_product_attention(q, k, v, **kw)
        return self.o_proj(out.flatten(-2))

    def forward(self, x, cos, sin, segment_ids=None):
        q, k, v = self._qkv(x, cos, sin)
        return self._attend(q, k, v, causal=True, q_segment_ids=segment_ids,
                            kv_segment_ids=segment_ids, window=self.cfg.sliding_window,
                            impl=self.attn_impl)

    def prefill(self, x, cos, sin, cache, cache_len: int = 0):
        """cache: (k, v), each (B, L, Hkv, D); the prompt fills [0, S) in
        place. `cache_len` exists for MLAttention call compatibility; the
        prompt always starts the cache."""
        del cache_len
        q, k, v = self._qkv(x, cos, sin)
        ck, cv = cache
        s = x.shape[1]
        ck[:, :s] = k.to(ck.dtype)
        cv[:, :s] = v.to(cv.dtype)
        out = self._attend(q, k, v, causal=True, window=self.cfg.sliding_window,
                           impl=self.attn_impl)
        return out, (ck, cv)

    def decode(self, x, cos, sin, cache, cache_len: int):
        """One token: write entry `cache_len` (in place), attend over
        [0, cache_len] (and within the window) on the plain route."""
        q, k, v = self._qkv(x, cos, sin)
        ck, cv = cache
        b, max_len = x.shape[0], ck.shape[1]
        ck[:, cache_len] = k[:, 0].to(ck.dtype)
        cv[:, cache_len] = v[:, 0].to(cv.dtype)
        pos = torch.arange(max_len, device=x.device)
        visible = pos <= cache_len
        if self.cfg.sliding_window is not None:
            visible &= pos > cache_len - self.cfg.sliding_window
        kv_seg = torch.where(visible, 0, -2).to(torch.int32)[None].expand(b, max_len)
        q_seg = torch.zeros((b, 1), dtype=torch.int32, device=x.device)
        out = self._attend(q, ck.to(q.dtype), cv.to(q.dtype), q_segment_ids=q_seg,
                           kv_segment_ids=kv_seg, impl="xla")
        return out, (ck, cv)


class GQALayer(nn.Module):
    def __init__(self, cfg: GQAConfig, *, device=None):
        super().__init__()
        dtype, pdtype = getattr(torch, cfg.dtype), getattr(torch, cfg.param_dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, dtype=dtype,
                                       device=device)
        self.self_attn = GQAAttention(cfg, device=device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps,
                                                dtype=dtype, device=device)
        self.mlp = SwiGLU(cfg.hidden_size, cfg.intermediate_size, dtype=dtype,
                          param_dtype=pdtype, device=device)

    def forward(self, x, cos, sin, segment_ids=None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, segment_ids)
        return x + self.mlp(self.post_attention_layernorm(x))

    def decode(self, x, cos, sin, cache, cache_len):
        h, cache = self.self_attn.decode(self.input_layernorm(x), cos, sin, cache, cache_len)
        x = x + h
        return x + self.mlp(self.post_attention_layernorm(x)), cache


class GQATransformer(nn.Module):
    def __init__(self, cfg: GQAConfig, *, device, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        dtype, pdtype = getattr(torch, cfg.dtype), getattr(torch, cfg.param_dtype)
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size, dtype=dtype,
                                      param_dtype=pdtype, device=device)
        self.layers = nn.ModuleList(GQALayer(cfg, device=device) for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, dtype=dtype, device=device)
        if not cfg.tie_word_embeddings:
            self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, bias=False, dtype=dtype,
                                 param_dtype=pdtype, device=device)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Truncated normal (std 0.02) table and kernels, zero biases, unit
        norm weights (set at construction)."""
        trunc_normal_(self.embed_tokens.weight, 0.02, generator)
        for layer in self.layers:
            layer.self_attn.init_weights(generator)
            for d in (layer.mlp.gate_proj, layer.mlp.up_proj, layer.mlp.down_proj):
                d.init_weights(generator)
        if not self.cfg.tie_word_embeddings:
            self.lm_head.init_weights(generator)

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    def run_layer(self, i: int, x, cos, sin, segment_ids=None):
        """Layer i; with `remat` and autograd on, recomputed in the backward."""
        layer = self.layers[i]
        if self.cfg.remat and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(layer, x, cos, sin, segment_ids,
                                                     use_reentrant=False)
        return layer(x, cos, sin, segment_ids)

    def _rope(self, position_ids):
        cfg = self.cfg
        if position_ids.dim() == 3 and cfg.mrope_section:
            return mrope_cos_sin(position_ids, cfg.hd, cfg.mrope_section, cfg.rope_theta)
        if position_ids.dim() == 3:
            position_ids = position_ids[0]
        return rope_cos_sin(position_ids, cfg.hd, cfg.rope_theta)

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
        return LLMOutput(logits=self._head(x) if with_logits else None, hidden=x)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        shape = (batch, max_len, self.cfg.num_kv_heads, self.cfg.hd)
        return [tuple(torch.zeros(shape, dtype=dtype, device=self.device) for _ in range(2))
                for _ in range(self.cfg.num_layers)]

    def prefill(self, input_embeds, caches, *, position_ids=None) -> LLMOutput:
        """Run the prompt, fill the caches (in place), return the
        last-position logits."""
        b, s, _ = input_embeds.shape
        if position_ids is None:
            position_ids = self._positions(b, s)
        cos, sin = self._rope(position_ids)
        x = input_embeds
        for layer, cache in zip(self.layers, caches):
            h, _ = layer.self_attn.prefill(layer.input_layernorm(x), cos, sin, cache)
            x = x + h
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        x = self.norm(x)
        return LLMOutput(logits=self._head(x[:, -1:]), hidden=x, caches=caches)

    def decode_step(self, token_ids, caches, cache_len, *, position_ids=None) -> LLMOutput:
        x = self.embed_tokens(token_ids)
        b = x.shape[0]
        if position_ids is None:
            position_ids = torch.full((b, 1), int(cache_len), dtype=torch.int32,
                                      device=self.device)
        cos, sin = self._rope(position_ids)
        for layer, cache in zip(self.layers, caches):
            x, _ = layer.decode(x, cos, sin, cache, int(cache_len))
        x = self.norm(x)
        return LLMOutput(logits=self._head(x), hidden=x, caches=caches)
