"""Plain scaled-dot-product attention: the reference every attention kernel
of the port is held against.

Port of internvideo_tpu/ops/attention_xla.py:23 `xla_attention`: causal,
segment ids, GQA by repeating K/V heads, `q_position_offset`, and the
sliding window as an explicit band mask (the JAX "xla" route hands a window
to the Pallas interpreter, ops/attention.py:310-320, whose flash semantics
give a row with no key in its band 0; so does this one). Materialises the
(Sq, Sk) scores, so it is for short sequences and checks. Cast chain as in
JAX: fp32 logits, fp32 softmax, probabilities cast to v's dtype before PV,
fp32 accumulation, output in the input dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention_xla(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    *,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,  # (B, Sq) int; 0 = padding
    kv_segment_ids: Optional[torch.Tensor] = None,  # (B, Sk)
    softmax_scale: Optional[float] = None,
    q_position_offset: int = 0,  # causal / window: query row i sits at key index i+off
    window: Optional[int] = None,  # keys with p - j < window (and j - p < window
                                   # without causal)
) -> torch.Tensor:
    orig_dtype = q.dtype
    _, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    if hq != hkv:
        if hq % hkv:
            raise ValueError(f"query heads {hq} not divisible by kv heads {hkv}")
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    scale = softmax_scale if softmax_scale is not None else d ** -0.5

    acc = torch.promote_types(orig_dtype, torch.float32)  # fp32, or fp64 for an fp64 anchor
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale

    mask = None
    if causal or window is not None:
        rel = (q_position_offset + torch.arange(sq, device=q.device)[:, None]
               - torch.arange(sk, device=q.device)[None, :])  # p - j
    if causal:
        mask = (rel >= 0)[None, None]
    if window is not None:
        band = ((rel < window) if causal else (rel.abs() < window))[None, None]
        mask = band if mask is None else mask & band
    if q_segment_ids is not None or kv_segment_ids is not None:
        if q_segment_ids is None or kv_segment_ids is None:
            raise ValueError("pass both q_segment_ids and kv_segment_ids")
        seg = q_segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :]
        mask = seg if mask is None else mask & seg
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)

    probs = torch.softmax(logits, dim=-1)
    if window is not None:  # flash semantics: a row with no key in its band gives 0
        probs = probs.masked_fill(~mask.any(-1, keepdim=True), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).to(acc), v.to(acc))
    return out.to(orig_dtype)
