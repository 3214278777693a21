"""Multi-head Latent Attention (MLA / M2LA): the prefill and decode paths.

Port of internvideo_tpu/nn/mla.py. K/V are compressed into a
`kv_lora_rank` latent per token plus one shared `qk_rope_head_dim` rotary
key; per-head K-nope / V are decompressed by `kv_b_proj_kernel`
(R, H, nope + v), kept in the JAX layout. The softmax scale is
(nope + rope)^-0.5.

  * `forward` (the JAX `__call__`, training / prefill): decompress K at
    d_qk with the rope tail added and V at d_v (not padded to d_qk), then
    causal flash attention (K5 on the kernel route).
  * `prefill`: the forward plus the dense latent cache, with the chunked
    `cache_len > 0` branch through `q_position_offset`.
  * `decode` (dense cache) and `decode_paged` (page pool, K6 on the kernel
    route): absorbed single-token decode, q_lat = q_nope @ W_uk, scores over
    the latents, out = (probs . c) @ W_uv.

`quant="int8_wo"` / `"int8_mix"` (serving) builds q_proj (or q_a / q_b),
kv_a_proj_with_mqa and o_proj as `ops/quant.py:Int8WoDense` (int8_mix:
with `dyn_m_threshold = INT8_MIX_DYN_M`, so prefill-sized calls take K7);
kv_b stays a raw parameter in `param_dtype` (it feeds the absorbed-decode
einsums), as in JAX (nn/mla.py:77-139).

Caches are written in place (`prefill`, `decode`) and returned, where JAX
returns an updated copy. `attn_impl`: auto | kernel | plain (or the JAX
spellings pallas | xla). The kernel route on a CPU tensor runs the kernels'
plain versions. Head-parallel (mesh) decode is not ported (ROADMAP queue 1,
item 8b): the serving engine refuses a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from internvideo_tpu_torch.nn.dense import Dense, trunc_normal_
from internvideo_tpu_torch.nn.norms import RMSNorm
from internvideo_tpu_torch.nn.rope import apply_rope
from internvideo_tpu_torch.ops.attention import _route, dot_product_attention
from internvideo_tpu_torch.ops.quant import serving_dense


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    hidden_size: int = 4096
    num_heads: int = 32
    kv_lora_rank: int = 896
    q_lora_rank: Optional[int] = None
    qk_rope_head_dim: int = 128
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    qkv_bias: bool = True
    o_bias: bool = False
    q_bias: bool = True
    window: Optional[int] = None
    kv_norm: bool = False

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def cache_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim


class MLAttention(nn.Module):
    def __init__(self, cfg: MLAConfig, *, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 quant: Optional[str] = None, device=None):
        super().__init__()
        if quant not in (None, "int8_wo", "int8_mix"):
            raise ValueError(f"unknown quant {quant!r}; None, 'int8_wo' or 'int8_mix'")
        self.cfg, self.dtype, self.attn_impl = cfg, dtype, attn_impl
        dense = lambda i, o, bias: serving_dense(quant, i, o, bias=bias, dtype=dtype,  # noqa: E731
                                                 param_dtype=param_dtype, device=device)
        qd = cfg.num_heads * cfg.q_head_dim
        if cfg.q_lora_rank is None:
            self.q_proj = dense(cfg.hidden_size, qd, cfg.q_bias)
        else:
            self.q_a_proj = dense(cfg.hidden_size, cfg.q_lora_rank, cfg.qkv_bias)
            self.q_a_layernorm = RMSNorm(cfg.q_lora_rank, dtype=dtype, device=device)
            self.q_b_proj = dense(cfg.q_lora_rank, qd, False)
        self.kv_a_proj_with_mqa = dense(cfg.hidden_size, cfg.cache_dim, cfg.qkv_bias)
        if cfg.kv_norm:
            self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, dtype=dtype, device=device)
        self.kv_b_proj_kernel = nn.Parameter(torch.empty(
            cfg.kv_lora_rank, cfg.num_heads, cfg.qk_nope_head_dim + cfg.v_head_dim,
            dtype=param_dtype, device=device))
        self.o_proj = dense(cfg.num_heads * cfg.v_head_dim, cfg.hidden_size, cfg.o_bias)

    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.children():
            if isinstance(m, Dense):
                m.init_weights(generator)
        trunc_normal_(self.kv_b_proj_kernel, 0.02, generator)

    def _project_q(self, x):
        cfg = self.cfg
        b, s, _ = x.shape
        if cfg.q_lora_rank is None:
            q = self.q_proj(x)
        else:
            q = self.q_b_proj(self.q_a_layernorm(self.q_a_proj(x)))
        q = q.reshape(b, s, cfg.num_heads, cfg.q_head_dim)
        return q[..., :cfg.qk_nope_head_dim], q[..., cfg.qk_nope_head_dim:]

    def _compress_kv(self, x):
        cfg = self.cfg
        ckv = self.kv_a_proj_with_mqa(x)
        lat = ckv[..., :cfg.kv_lora_rank]  # (B, S, R)
        if cfg.kv_norm:
            lat = self.kv_a_layernorm(lat)
        return lat, ckv[..., cfg.kv_lora_rank:]  # latent, shared rope key

    def _kv_b(self):
        """(w_uk (R, H, nope), w_uv (R, H, v)) in the compute dtype."""
        kv_b = self.kv_b_proj_kernel.to(self.dtype)
        return kv_b[..., :self.cfg.qk_nope_head_dim], kv_b[..., self.cfg.qk_nope_head_dim:]

    def forward(self, x, cos, sin, *, q_segment_ids=None, kv_segment_ids=None,
                causal: bool = True):
        """Training / prefill forward with decompressed K/V: x (B, S, D),
        cos/sin (B, S, P) -> (B, S, D)."""
        cfg = self.cfg
        b, s, _ = x.shape
        q_nope, q_pe = self._project_q(x)
        ckv, k_pe = self._compress_kv(x)
        w_k, w_v = self._kv_b()
        # K arrives with room for the rope tail (the weight slice is padded,
        # not the activations); V stays at v_head_dim
        w_k_padded = torch.nn.functional.pad(w_k, (0, cfg.qk_rope_head_dim))
        k = torch.einsum("bsr,rhd->bshd", ckv, w_k_padded)
        k_pe = apply_rope(k_pe[:, :, None, :], cos, sin)  # (B, S, 1, P)
        k = k + torch.nn.functional.pad(k_pe.to(k.dtype), (cfg.qk_nope_head_dim, 0))
        v = torch.einsum("bsr,rhd->bshd", ckv, w_v)
        q = torch.cat([q_nope, apply_rope(q_pe, cos, sin)], dim=-1)
        out = dot_product_attention(
            q, k, v, causal=causal, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, softmax_scale=cfg.q_head_dim ** -0.5,
            impl=self.attn_impl, window=cfg.window)
        return self.o_proj(out.reshape(b, s, cfg.num_heads * cfg.v_head_dim))

    def compute_cache_entry(self, x, cos, sin):
        """(B, S, D) -> (B, S, R + P) latent entries (the rope key rotated)."""
        ckv, k_pe_raw = self._compress_kv(x)
        k_pe = apply_rope(k_pe_raw[:, :, None, :], cos, sin)[:, :, 0, :]
        return torch.cat([ckv, k_pe], dim=-1)

    def prefill(self, x, cos, sin, cache, cache_len: int, *, causal: bool = True):
        """Forward + write the latent cache (B, max_len, R + P) in place at
        [cache_len, cache_len + S); returns (out, cache). With cache_len > 0
        (a later chunk) the chunk attends over the cached latents plus
        itself, query row i at key index cache_len + i."""
        cfg = self.cfg
        if not isinstance(cache_len, int):
            raise TypeError("prefill cache_len must be a Python int; chunk boundaries are "
                            "host-driven")
        b, s, _ = x.shape
        cache[:, cache_len:cache_len + s] = self.compute_cache_entry(x, cos, sin).to(cache.dtype)
        if cache_len == 0:
            return self.forward(x, cos, sin, causal=causal), cache
        q_nope, q_pe = self._project_q(x)
        q = torch.cat([q_nope, apply_rope(q_pe, cos, sin)], dim=-1)
        total = cache_len + s
        c_all = cache[:, :total, :cfg.kv_lora_rank].to(self.dtype)
        p_all = cache[:, :total, cfg.kv_lora_rank:].to(self.dtype)
        kv = torch.einsum("bsr,rhd->bshd", c_all, self.kv_b_proj_kernel.to(self.dtype))
        k_nope, v = kv[..., :cfg.qk_nope_head_dim], kv[..., cfg.qk_nope_head_dim:]
        k = torch.cat([k_nope, p_all[:, :, None, :].expand(
            *k_nope.shape[:-1], cfg.qk_rope_head_dim)], dim=-1)
        out = dot_product_attention(
            q, k, v, causal=causal, softmax_scale=cfg.q_head_dim ** -0.5,
            impl=self.attn_impl, window=cfg.window, q_position_offset=cache_len)
        return self.o_proj(out.reshape(b, s, cfg.num_heads * cfg.v_head_dim)), cache

    def _absorbed_scores_out(self, q_lat, q_pe, cache, valid):
        """Absorbed attention over a (B, L, R + P) cache with `valid` (B, L):
        fp32 scores (as ops/paged_decode.py's plain version; JAX's XLA
        branch rounds them to the model dtype, the same numbers in fp32),
        fp32 softmax, probabilities in the model dtype for probs . c."""
        cfg = self.cfg
        c = cache[:, :, :cfg.kv_lora_rank].to(self.dtype)
        p = cache[:, :, cfg.kv_lora_rank:].to(self.dtype)
        scores = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), c.float())
                  + torch.einsum("bqhd,bsd->bhqs", q_pe.float(), p.float())
                  ) * (cfg.q_head_dim ** -0.5)
        scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
        probs = torch.softmax(scores, dim=-1).to(self.dtype)
        return torch.einsum("bhqs,bsr->bqhr", probs, c)

    def decode(self, x, cos, sin, cache, cache_len):
        """Absorbed single-token decode over the dense cache: x (B, 1, D);
        writes this token's entry at `cache_len` in place; returns (out,
        cache)."""
        cfg = self.cfg
        b = x.shape[0]
        q_nope, q_pe = self._project_q(x)
        q_pe = apply_rope(q_pe, cos, sin)
        pos = int(cache_len)
        cache[:, pos:pos + 1] = self.compute_cache_entry(x, cos, sin).to(cache.dtype)
        w_uk, w_uv = self._kv_b()
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)
        valid = (torch.arange(cache.shape[1], device=cache.device) <= pos)[None].expand(b, -1)
        ctx = self._absorbed_scores_out(q_lat, q_pe, cache, valid)
        out = torch.einsum("bqhr,rhd->bqhd", ctx, w_uv)
        return self.o_proj(out.reshape(b, 1, cfg.num_heads * cfg.v_head_dim)), cache

    def decode_paged(self, x, cos, sin, pages, block_tables, seq_lens,
                     impl: Optional[str] = None):
        """Absorbed decode over a page pool (the caller wrote this token's
        entry first): `seq_lens` (B,) count the cached tokens including it.
        The kernel route runs K6 (ops/paged_decode.py) on a CUDA tensor; the
        plain route its plain version, the gather formulation."""
        from internvideo_tpu_torch.ops.paged_decode import (
            paged_mla_decode,
            paged_mla_decode_ref,
        )

        cfg = self.cfg
        b = x.shape[0]
        q_nope, q_pe = self._project_q(x)
        q_pe = apply_rope(q_pe, cos, sin)
        w_uk, w_uv = self._kv_b()
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)
        decode = (paged_mla_decode if _route(impl or self.attn_impl, x) == "kernel"
                  else paged_mla_decode_ref)
        ctx = decode(q_lat[:, 0].to(self.dtype), q_pe[:, 0].to(self.dtype), pages, block_tables,
                     seq_lens, softmax_scale=cfg.q_head_dim ** -0.5)[:, None]  # (B, 1, H, R)
        out = torch.einsum("bqhr,rhd->bqhd", ctx, w_uv)
        return self.o_proj(out.reshape(b, 1, cfg.num_heads * cfg.v_head_dim))
