"""Flash attention forward: the Hopper CUDA kernel and its plain version.

Counterpart of internvideo_tpu/ops/flash_attention.py `flash_attention`
(:2037) and `flash_attention_with_lse` (:1188), for the case the
InternVideo2 encoder runs: non-causal, no segment ids, no window, one K/V
head per query head, d_v == d_qk, layout (B, S, H, D). Every other argument
raises NotImplementedError naming the ROADMAP item that brings it.

A CUDA tensor goes to the kernel (`csrc/flash_fwd.cu`, built by `_build`)
or raises; a CPU tensor goes to the plain version `flash_attention_ref`.
There is no fallback from one to the other.

The LSE is the natural-log softmax normaliser, (B, H, Sq) float32; a row
that sees no key gets out 0 and LSE -inf.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from internvideo_tpu_torch.ops import _build

# Head dims the kernel is instantiated for (csrc/flash_fwd.cu IVT_CASE).
KERNEL_HEAD_DIMS = (64, 88)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_launches = 0


def launch_count() -> int:
    """How many times the CUDA kernel has been launched in this process."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _check_supported(q, k, v, *, causal, q_segment_ids, kv_segment_ids,
                     window, q_position_offset, layout):
    if causal:
        raise NotImplementedError(
            "causal flash attention is not ported yet (ROADMAP queue 2, K5)")
    if q_segment_ids is not None or kv_segment_ids is not None:
        raise NotImplementedError(
            "segment ids are not ported yet (ROADMAP queue 2, K8)")
    if window is not None or q_position_offset:
        raise NotImplementedError(
            "window / q_position_offset are not ported yet (ROADMAP queue 2, K5)")
    if layout != "bshd":
        raise NotImplementedError(
            f"layout {layout!r} is not ported yet (ROADMAP queue 2, K5)")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected (B, S, H, D) inputs, got {q.shape}, {k.shape}, {v.shape}")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise NotImplementedError(
            f"q {tuple(q.shape)} / k {tuple(k.shape)} / v {tuple(v.shape)}: d_v != d_qk "
            "is not ported yet (ROADMAP queue 2, K5)")
    if q.shape[2] != k.shape[2]:
        raise NotImplementedError(
            "grouped-query attention is not ported yet (ROADMAP queue 2, K5)")


def flash_attention_ref_with_lse(q, k, v, scale: float):
    """Plain PyTorch version of the kernel: (out, natural-log lse).

    The cast chain of ops/attention_xla.py: fp32 logits, fp32 softmax,
    probabilities cast to v's dtype before PV, fp32 accumulation, output in
    q's dtype. Loops over the batch so that the (H, Sq, Sk) fp32 scores of
    one sequence are the largest temporary.
    """
    outs, lses = [], []
    for i in range(q.shape[0]):
        qi, ki, vi = (x[i].transpose(0, 1) for x in (q, k, v))  # (H, S, D)
        logits = torch.matmul(qi.float(), ki.float().transpose(1, 2)) * scale
        lse = torch.logsumexp(logits, dim=-1)
        probs = torch.exp(logits - lse[..., None]).to(v.dtype)
        out = torch.matmul(probs.float(), vi.float())
        outs.append(out.to(q.dtype).transpose(0, 1))
        lses.append(lse)
    return torch.stack(outs), torch.stack(lses)


def flash_attention_ref(q, k, v, scale: float):
    return flash_attention_ref_with_lse(q, k, v, scale)[0]


def _flash_fwd_cuda(q, k, v, scale: float):
    """Launch csrc/flash_fwd.cu on CUDA tensors; returns (out, lse)."""
    global _launches
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError(f"q, k, v on different devices: {dev}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise NotImplementedError(
            f"flash kernel takes float32 or bfloat16 q/k/v, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} / heads {h} exceed the kernel grid's 65535 limit")
    if d not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"head dim {d} is not instantiated in csrc/flash_fwd.cu {KERNEL_HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on the head dim, got {x.stride()}")
        if q.dtype == torch.bfloat16 and (
                any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16):
            raise ValueError(
                f"{name}: the bf16 kernel loads 16-byte rows, so batch/seq/head "
                f"strides must be multiples of 8 and the base 16-byte aligned "
                f"(strides {x.stride()}, ptr {x.data_ptr():#x})")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse
    lib = _build.load_library()
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ivt_flash_fwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, sq, sk, h, d, strides,
            float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError_t {rc}")
    _launches += 1
    return out, lse


def flash_attention_with_lse(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, H, D)
    v: torch.Tensor,
    *,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    window: Optional[int] = None,
    q_position_offset: int = 0,
    layout: str = "bshd",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out (B, Sq, H, D), lse (B, H, Sq) natural log, float32)."""
    _check_supported(q, k, v, causal=causal, q_segment_ids=q_segment_ids,
                     kv_segment_ids=kv_segment_ids, window=window,
                     q_position_offset=q_position_offset, layout=layout)
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, scale)
    if q.device.type != "cpu":
        raise NotImplementedError(f"no flash attention for device {q.device}")
    return flash_attention_ref_with_lse(q, k, v, scale)


def flash_attention(q, k, v, **kwargs) -> torch.Tensor:
    """Flash attention over (B, S, H, D) inputs; see flash_attention_with_lse."""
    return flash_attention_with_lse(q, k, v, **kwargs)[0]
