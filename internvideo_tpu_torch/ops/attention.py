"""Attention dispatcher: the CUDA flash kernel or the plain reference.

Port of internvideo_tpu/ops/attention.py:151 `dot_product_attention`, with
the same keyword signature. `impl`:

  * "auto": the kernel for a CUDA tensor, the plain version for a CPU one;
  * "kernel" (JAX spelling "pallas"): ops/flash_attention.py, which launches
    the CUDA kernel on a CUDA tensor and runs its plain version on a CPU one;
  * "plain" (JAX spelling "xla"): ops/attention_xla.py.

A case the kernel does not take (causal, segment ids, window, GQA, ...)
raises on the kernel route, including "auto" on a CUDA tensor; nothing
falls back to the plain route. The sequence-parallel and head-parallel
contexts of the JAX dispatcher are not ported yet (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

from typing import Optional

import torch

from internvideo_tpu_torch.ops.attention_xla import attention_xla
from internvideo_tpu_torch.ops.flash_attention import flash_attention

_IMPLS = {"kernel": "kernel", "pallas": "kernel", "plain": "plain", "xla": "plain"}


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
    if impl == "auto":
        route = "kernel" if q.is_cuda else "plain"
    elif impl in _IMPLS:
        route = _IMPLS[impl]
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    if route == "kernel":
        return flash_attention(
            q, k, v, causal=causal, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, softmax_scale=softmax_scale,
            window=window, q_position_offset=q_position_offset, layout=layout,
        )
    if window is not None or layout != "bshd":
        raise NotImplementedError(
            "window / bhsd layout are not ported yet (ROADMAP queue 2, K5)")
    return attention_xla(
        q, k, v, causal=causal, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, softmax_scale=softmax_scale,
        q_position_offset=q_position_offset,
    )
