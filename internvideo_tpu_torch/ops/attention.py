"""Attention dispatcher: the CUDA kernels or the plain reference.

Port of internvideo_tpu/ops/attention.py:151 `dot_product_attention`, with
the same keyword signature, and of `fused_qkv_attention_or_none` (:81).
`impl`:

  * "auto": the kernel for a CUDA tensor, the plain version for a CPU one;
  * "kernel" (JAX spelling "pallas"): ops/flash_attention.py, which launches
    the CUDA kernel on a CUDA tensor and runs its plain version on a CPU one;
  * "plain" (JAX spelling "xla"): ops/attention_xla.py.

Segment ids, grouped-query heads and the sliding window reach the kernel
route (K5 / K8). A case the kernels do not take (an uninstantiated head
dim, the backward of a grouped-query or windowed call, ...) raises on the
kernel route, including "auto" on a CUDA tensor; nothing falls back to the
plain route. The plain route takes a window with an explicit band mask
(`attention_xla(window=)`), where the JAX "xla" route sends it to the
Pallas interpreter (:310-320); both give a row with no key in its band 0.
The sequence-parallel and head-parallel contexts of the JAX dispatcher are
not ported yet (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

from typing import Optional

import torch

from internvideo_tpu_torch.ops.attention_xla import attention_xla
from internvideo_tpu_torch.ops.flash_attention import (
    flash_attention,
    fused_qkv_eligible,
    fused_qkv_large_eligible,
    fused_qkv_rmsnorm_attention,
)

_IMPLS = {"kernel": "kernel", "pallas": "kernel", "plain": "plain", "xla": "plain"}


def _route(impl: str, x: torch.Tensor) -> str:
    if impl == "auto":
        return "kernel" if x.is_cuda else "plain"
    if impl in _IMPLS:
        return _IMPLS[impl]
    raise ValueError(f"unknown attention impl {impl!r}")


def fused_qkv_attention_or_none(
    qkv: torch.Tensor,  # (B, S, 3W) flat projection output
    q_weight: torch.Tensor,  # (W,) whole-dim QK-RMSNorm weights
    k_weight: torch.Tensor,
    *,
    num_heads: int,
    eps: float = 1e-6,
    softmax_scale: Optional[float] = None,
    impl: str = "auto",
    allow_large: bool = False,
) -> Optional[torch.Tensor]:
    """Fused qkv + QK-RMSNorm + attention (K3) when it applies, else None:
    the caller then runs the unfused path. Declines on the plain route
    ("auto" for a CPU tensor, as the JAX dispatcher declines off the TPU)
    and outside `fused_qkv_eligible`. `allow_large=True`, the JAX opt-in to
    the blocked-K large-S variant, also takes K11 where
    `fused_qkv_large_eligible` holds (1024 < S <= 8192); no model sets it,
    as in JAX (:90-101), so the encoder keeps K1 at S > 1024."""
    if _route(impl, qkv) != "kernel":
        return None
    _, s, w3 = qkv.shape
    w = w3 // 3
    if w3 != 3 * w or w % num_heads:
        return None
    d, itemsize = w // num_heads, qkv.element_size()
    if not (fused_qkv_eligible(s, num_heads, d, itemsize)
            or (allow_large and fused_qkv_large_eligible(s, num_heads, d, itemsize))):
        return None
    return fused_qkv_rmsnorm_attention(qkv, q_weight, k_weight, num_heads=num_heads,
                                       eps=eps, softmax_scale=softmax_scale)


def native_attention_layout(impl: str = "auto") -> str:
    """The layout the attention path consumes without copies: "bshd". The
    JAX package returns "bhsd" for its TPU kernel (ops/attention.py:136);
    the Hopper kernels take element strides, so either layout is a free
    view here and producers keep (B, S, H, D)."""
    if impl != "auto" and impl not in _IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}")
    return "bshd"


def dot_product_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    impl: str = "auto",  # auto | kernel | plain (or pallas | xla)
    block_q: int = 1024,  # TPU tile sizes: accepted for signature parity,
    block_k: int = 1024,  # unused (the CUDA kernel picks its own tiles)
    window: Optional[int] = None,
    q_position_offset: int = 0,
    layout: str = "bshd",
) -> torch.Tensor:
    if _route(impl, q) == "kernel":
        return flash_attention(
            q, k, v, causal=causal, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, softmax_scale=softmax_scale,
            window=window, q_position_offset=q_position_offset, layout=layout,
        )
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "bhsd":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    out = attention_xla(
        q, k, v, causal=causal, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, softmax_scale=softmax_scale,
        q_position_offset=q_position_offset, window=window,
    )
    return out if layout == "bshd" else out.transpose(1, 2)
