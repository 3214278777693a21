"""Flash attention, small-S attention and the fused qkv + QK-RMSNorm op:
the Hopper CUDA kernels and their plain versions.

Counterpart of internvideo_tpu/ops/flash_attention.py `flash_attention`
(:2037), `flash_attention_with_lse` (:1188), `_small_s_attention` (:1606),
`_fused_qkv_small_s` (:1730), `fused_qkv_eligible` (:1784),
`fused_qkv_rmsnorm_attention` (:1801), `_fused_qkv_large` (:1961) and
`fused_qkv_large_eligible` (:2026) with their custom VJPs, for the case
the InternVideo2 encoder, its teachers and the InternVideo3 vision tower
run (non-causal, d_v == d_qk), for the one the M2LA LLM's prefill and
packed SFT training run (causal, a query position offset, d_v != d_qk,
packed-sequence segment ids) and for the dense-GQA LLM's prefill and RL
training (grouped-query heads, Hq a multiple of Hkv, and the sliding
window, causal or not), in layout (B, S, H, D) or its permuted view
(B, H, S, D).

Four autograd Functions, each owning a kernel route (CUDA tensors: the
kernel, or raise) and a plain route (CPU tensors); there is no fallback
from one to the other:

  * `FlashAttention` (K1 forward `csrc/flash_fwd.cu`, K4a backward
    `csrc/flash_bwd.cu`), differentiable in out and LSE; causal, narrow-v
    or segmented calls take K5 (forward `csrc/flash_fwd_causal.cu`,
    backward `csrc/flash_bwd_causal_dq.cu` / `flash_bwd_causal_dkv.cu`),
    with segment ids K8 (the same kernels' `kSeg` instantiations), and so
    do grouped-query and windowed calls, forward and backward (the dk/dv
    kernel sums over a group's q heads);
  * `SmallSAttention` (K2 forward `csrc/small_s_fwd.cu`, K4b backward
    `csrc/small_s_bwd.cu`) for 0 < Sq, Sk <= 1024, the route
    `flash_attention` takes there, as the JAX package's does (:2080-2094);
  * `FusedQKVAttention` (K3 `csrc/fused_qkv.cu`: a row-statistics
    pre-pass and the attention kernel), whose backward differentiates the
    unfused composition slice -> rms_norm -> SmallSAttention, as
    `_fused_qkv_bwd_rule` (:1770-1778) does;
  * `FusedQKVLargeAttention` (K11 `csrc/fused_qkv_large.cu`: K3's pre-pass,
    then K1's blocked-K online-softmax body on the normalized tiles) for
    1024 < S <= 8192, whose backward differentiates slice -> rms_norm ->
    FlashAttention (K1 / K4a), as `_fused_large_bwd_rule` (:2012-2020).

The JAX package's TPU-only routing conditions (`_ss_fits`, a VMEM budget;
W % 128, Mosaic lane alignment) are replaced by the Hopper kernels' own:
an instantiated head dim, 16-byte bf16 rows and the grid limits. At every
shape of the ported paths both packages pick the same kernel.

The LSE is the natural-log softmax normaliser, (B, H, Sq) float32; a row
that sees no key (a causal row before the first key, a window with no key
in its band) gets out 0 and LSE -inf. Segment ids mask by equality, as
the JAX kernels' `q_seg == k_seg` (:62-64) and `attention_xla` do: the pad
id -1 that `pack_mllm_items` gives both q and kv meets itself, so pad rows
attend to each other (causally).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from internvideo_tpu_torch.ops import _build
from internvideo_tpu_torch.ops.rmsnorm import rms_norm

# Head dims the kernels are instantiated for: K1 / K4a (csrc/flash_fwd.cu,
# flash_bwd.cu; their bf16 kernels in flash_fwd_causal.cu's flash_fwd_wgmma
# and flash_bwd_causal_{dq,dkv}.cu; 128 for Intern-S1's InternViT-6B at S
# 1025), K2 / K4b / K3 (csrc/small_s_fwd.cu, small_s_bwd.cu, fused_qkv.cu;
# K2's and K4b's bf16 kernels also in those wgmma bodies; 128 for the
# CLIP-6B teacher) and K11 (csrc/fused_qkv_large.cu).
KERNEL_HEAD_DIMS = (64, 88, 128)
SMALL_S_HEAD_DIMS = (64, 72, 88, 128)
FUSED_LARGE_HEAD_DIMS = (64, 88)
# (d_qk, d_v) pairs of the K5 forward (csrc/flash_fwd_causal.cu):
# qwen3_8b_mla, qwen3_2b_mla / deepseek_v3, qwen3_8b_dense, qwen3_moe_text,
# gpt_oss_moe_text, and small pairs for the parity checks; and of its
# backward (csrc/flash_bwd_causal_*.cu): the training pairs of qwen3_8b_mla,
# qwen3_8b_dense and qwen3_moe_text (Intern-S1's text) and the small ones
CAUSAL_HEAD_DIMS = ((256, 128), (192, 128), (128, 128), (128, 64), (64, 64), (64, 32),
                    (32, 32))
CAUSAL_BWD_HEAD_DIMS = ((256, 128), (128, 128), (128, 64), (64, 64), (64, 32), (32, 32))
SMALL_S_MAX = 1024  # the JAX package's _SMALL_S_MAX
FUSED_LARGE_MAX = 8192  # the JAX package's _FUSED_LARGE_MAX
_FUSED_LARGE_MAX_HEADS = 128  # fused_qkv_large_eligible (:2032)
_GRID_MAX = 65535  # grid y (heads) and z (batch) of every attention kernel
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LOG2E = 1.0 / math.log(2.0)

# One launch count per kernel; "fused_qkv_rstd" is K3's row-statistics
# pre-pass, launched once per "fused_qkv_fwd" (K3) and once per
# "fused_qkv_large_fwd" (K11; in bf16 it also writes the normed k rows);
# "flash_fwd_causal" and
# "flash_bwd_causal_{dq,dkv}" are K5; their "_seg" names count the launches
# with segment ids (K8), which the plain names do not. A K5 launch, forward
# or backward, counts under one name: "..._window" with a window, "..._gqa"
# with grouped-query heads and no window, "..._seg" with segment ids and
# neither, else the plain name.
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
           "small_s_fwd", "small_s_bwd_dq", "small_s_bwd_dkv",
           "fused_qkv_rstd", "fused_qkv_fwd", "fused_qkv_large_fwd", "flash_fwd_causal",
           "flash_bwd_causal_dq", "flash_bwd_causal_dkv", "flash_fwd_causal_seg",
           "flash_bwd_causal_dq_seg", "flash_bwd_causal_dkv_seg", "flash_fwd_causal_gqa",
           "flash_fwd_causal_window", "flash_bwd_causal_dq_gqa", "flash_bwd_causal_dkv_gqa",
           "flash_bwd_causal_dq_window", "flash_bwd_causal_dkv_window")
_launches = dict.fromkeys(KERNELS, 0)
# K3's and K11's launches by sequence length, counted with "fused_qkv_fwd" /
# "fused_qkv_large_fwd": one model step may run them at several S (the UMT
# student's and its CLIP teacher's).
_fused_launches_by_len: dict = {}


def launch_count(kernel: str = "flash_fwd") -> int:
    """How many times `kernel` (one of KERNELS) has been launched on the
    card in this process."""
    return _launches[kernel]


def fused_launch_counts(kernel: str = "fused_qkv_fwd") -> dict:
    """{S: launches of `kernel` ("fused_qkv_fwd" or "fused_qkv_large_fwd")
    at sequence length S} since the counts were last reset."""
    return {s: n for (name, s), n in _fused_launches_by_len.items() if name == kernel}


def reset_launch_count() -> None:
    """Set every kernel's launch count to 0."""
    for name in KERNELS:
        _launches[name] = 0
    _fused_launches_by_len.clear()


def _check_supported(q, k, v, *, q_segment_ids, kv_segment_ids, window, layout):
    """Raise on what no route of this module takes; `q`, `k`, `v` are
    (B, S, H, D) (after a "bhsd" layout is permuted), the segment ids
    (B, Sq) / (B, Sk) integers."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both q_segment_ids and kv_segment_ids")
    if q_segment_ids is not None and (
            tuple(q_segment_ids.shape) != (q.shape[0], q.shape[1])
            or tuple(kv_segment_ids.shape) != (k.shape[0], k.shape[1])):
        raise ValueError(f"segment ids {tuple(q_segment_ids.shape)} / "
                         f"{tuple(kv_segment_ids.shape)} do not match q {tuple(q.shape)} / "
                         f"k {tuple(k.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive int or None, got {window}")
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"unknown layout {layout!r}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected (B, S, H, D) inputs, got {q.shape}, {k.shape}, {v.shape}")
    if (k.shape[:3] != v.shape[:3] or q.shape[0] != k.shape[0]
            or q.shape[3] != k.shape[3]):
        raise ValueError(
            f"q {tuple(q.shape)} / k {tuple(k.shape)} / v {tuple(v.shape)} do not form "
            "one attention")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"query heads {q.shape[2]} not divisible by kv heads {k.shape[2]}")


def _to_bshd(layout: str, *xs):
    """(B, H, S, D) views -> (B, S, H, D) views (no copy) for layout "bhsd"."""
    return xs if layout == "bshd" else tuple(x.transpose(1, 2) for x in xs)


def _visible(i: int, sq: int, sk: int, device, causal: bool, q_position_offset: int,
             q_segment_ids, kv_segment_ids, window: Optional[int] = None):
    """(Sq, Sk) bool mask of batch row i (None: every key is visible): query
    row r at position p = r + q_position_offset sees key j iff j <= p
    (causal), p - j < window and, without causal, j - p < window (a window),
    and q_segment_ids[i, r] == kv_segment_ids[i, j]."""
    mask = None
    if causal or window is not None:
        rel = (torch.arange(sq, device=device)[:, None] + q_position_offset
               - torch.arange(sk, device=device)[None, :])  # p - j
    if causal:
        mask = rel >= 0
    if window is not None:
        band = (rel < window) if causal else (rel.abs() < window)
        mask = band if mask is None else mask & band
    if q_segment_ids is not None:
        seg = q_segment_ids[i][:, None] == kv_segment_ids[i][None, :]
        mask = seg if mask is None else mask & seg
    return mask


def _head_chunks(h: int, sq: int, sk: int):
    """Slices of the head axis whose (heads, Sq, Sk) fp32 scores stay under
    about 2 GB (the plain versions at the LLM's S = 8192)."""
    step = max(1, (1 << 29) // max(sq * sk, 1))
    return [slice(h0, min(h, h0 + step)) for h0 in range(0, h, step)]


def flash_attention_ref_with_lse(q, k, v, scale: float, causal: bool = False,
                                 q_position_offset: int = 0, q_segment_ids=None,
                                 kv_segment_ids=None, window: Optional[int] = None):
    """Plain PyTorch version of the kernels: (out, natural-log lse).

    The cast chain of ops/attention_xla.py: fp32 logits, fp32 softmax,
    probabilities cast to v's dtype before PV, fp32 accumulation, output in
    q's dtype (with v's head dim). Query row i sits at position p = i +
    q_position_offset; with `causal` it sees key j iff j <= p, with a
    `window` iff p - j < window (and j - p < window without causal), with
    segment ids iff their ids are equal. Query head h reads K/V head
    h // (Hq / Hkv) (grouped-query attention). A row that sees no key gets
    out 0 and LSE -inf. Loops over the batch so that the (H, Sq, Sk) fp32
    scores of one sequence are the largest temporary.
    """
    sq, sk = q.shape[1], k.shape[1]
    group = q.shape[2] // k.shape[2]
    outs, lses = [], []
    for i in range(q.shape[0]):
        mask = _visible(i, sq, sk, q.device, causal, q_position_offset, q_segment_ids,
                        kv_segment_ids, window)
        out_i, lse_i = [], []
        for hs in _head_chunks(q.shape[2], sq, sk):
            kv_heads = torch.arange(hs.start, hs.stop, device=q.device) // group
            qi = q[i, :, hs].transpose(0, 1)  # (h, S, D)
            ki, vi = (x[i].index_select(1, kv_heads).transpose(0, 1) for x in (k, v))
            logits = torch.matmul(qi.float(), ki.float().transpose(1, 2)) * scale
            if mask is not None:
                logits = logits.masked_fill(~mask, float("-inf"))
            lse = torch.logsumexp(logits, dim=-1)
            probs = torch.exp(logits - lse[..., None])
            if mask is not None:
                probs = torch.where(torch.isinf(lse)[..., None], 0.0, probs)
            out = torch.matmul(probs.to(v.dtype).float(), vi.float())
            out_i.append(out.to(q.dtype).transpose(0, 1))
            lse_i.append(lse)
        outs.append(torch.cat(out_i, dim=1))
        lses.append(torch.cat(lse_i, dim=0))
    return torch.stack(outs), torch.stack(lses)


def flash_attention_ref(q, k, v, scale: float):
    return flash_attention_ref_with_lse(q, k, v, scale)[0]


def flash_attention_bwd_ref(q, k, v, out, lse, do, scale: float, lse_ct=None,
                            causal: bool = False, q_position_offset: int = 0,
                            q_segment_ids=None, kv_segment_ids=None,
                            window: Optional[int] = None):
    """Plain PyTorch version of the backward kernels: (dq, dk, dv).

    The explicit formulas in fp32 with the JAX kernels' cast chain
    (flash_attention.py:1316-1333): p = exp(s - lse) on the visible (causal,
    in-window, same-segment: the forward's `_visible`) keys and 0 elsewhere,
    dp = dO v^T and delta = rowsum(dO * O) over v's head dim, minus the LSE
    cotangent `lse_ct` (B, H, Sq) if given, ds = p * (dp - delta) rounded to
    k's dtype before the ds k and ds^T q products, p rounded to dO's dtype
    before p^T dO; each gradient in its input's dtype. With grouped-query
    heads (Hq = group * Hkv) q head h reads K/V head h // group, and dk / dv
    of a K/V head sum its group's q heads in fp32 before the one rounding,
    as the JAX dk/dv kernel's accumulator does (:619-620). Loops over the
    batch, as the forward's plain version does.
    """
    f32 = torch.float32
    sq, sk = q.shape[1], k.shape[1]
    hq, hkv = q.shape[2], k.shape[2]
    group = hq // hkv
    dqs, dks, dvs = [], [], []
    for i in range(q.shape[0]):
        mask = _visible(i, sq, sk, q.device, causal, q_position_offset, q_segment_ids,
                        kv_segment_ids, window)
        grads = []
        for hs in _head_chunks(hq, sq, sk):
            kv_heads = torch.arange(hs.start, hs.stop, device=q.device) // group
            qi, oi, doi = (x[i, :, hs].transpose(0, 1).to(f32) for x in (q, out, do))
            ki, vi = (x[i].index_select(1, kv_heads).transpose(0, 1).to(f32) for x in (k, v))
            lse_i = lse[i, hs][..., None]
            s = torch.matmul(qi, ki.transpose(1, 2)) * scale
            # a row that saw no key (lse -inf) has p = 0
            p = torch.where(torch.isinf(lse_i), 0.0, torch.exp(s - lse_i))
            if mask is not None:
                p = p.masked_fill(~mask, 0.0)
            dp = torch.matmul(doi, vi.transpose(1, 2))
            delta = (doi * oi).sum(-1)
            if lse_ct is not None:
                delta = delta - lse_ct[i, hs].to(f32)
            ds = (p * (dp - delta[..., None])).to(k.dtype).to(f32)
            grads.append((
                (scale * torch.matmul(ds, ki)).to(q.dtype),  # (h, Sq, D)
                scale * torch.matmul(ds.transpose(1, 2), qi),  # (h, Sk, D) fp32
                torch.matmul(p.to(do.dtype).to(f32).transpose(1, 2), doi)))
        dq_i, dk_i, dv_i = (torch.cat(g, dim=0) for g in zip(*grads))
        dqs.append(dq_i.transpose(0, 1))
        # (Hq, Sk, D) -> sum over each group's q heads -> (Sk, Hkv, D)
        dks.append(dk_i.unflatten(0, (hkv, group)).sum(1).to(k.dtype).transpose(0, 1))
        dvs.append(dv_i.unflatten(0, (hkv, group)).sum(1).to(v.dtype).transpose(0, 1))
    return torch.stack(dqs), torch.stack(dks), torch.stack(dvs)


def _check_kernel_inputs(tensors, what: str, head_dims=KERNEL_HEAD_DIMS,
                         source: str = "csrc/flash_fwd.cu") -> None:
    """Raise unless `tensors` (name -> (B, S, H, D) tensor) can go to the
    kernels: one device and dtype (fp32 or bf16), a head dim in
    `head_dims` (those `source` instantiates), a unit head-dim stride, and
    for bf16 16-byte rows."""
    (n0, x0), *rest = tensors.items()
    dev, dt = x0.device, x0.dtype
    for name, x in rest:
        if x.device != dev:
            raise ValueError(f"{what}: {n0} on {dev} but {name} on {x.device}")
        if x.dtype != dt:
            raise NotImplementedError(
                f"{what}: mixed dtypes {n0} {dt} and {name} {x.dtype}")
    if dt not in _DTYPE_CODES:
        raise NotImplementedError(
            f"flash kernel takes float32 or bfloat16 q/k/v, got {dt}")
    b, _, h, d = x0.shape
    if b > _GRID_MAX or h > _GRID_MAX:
        raise ValueError(f"batch {b} / heads {h} exceed the kernel grid's {_GRID_MAX} limit")
    if d not in head_dims:
        raise NotImplementedError(f"head dim {d} is not instantiated in {source} {head_dims}")
    for name, x in tensors.items():
        if x.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on the head dim, got {x.stride()}")
        if dt == torch.bfloat16 and (any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16):
            raise ValueError(
                f"{name}: the bf16 kernel loads 16-byte rows, so batch/seq/head "
                f"strides must be multiples of 8 and the base 16-byte aligned "
                f"(strides {x.stride()}, ptr {x.data_ptr():#x})")


# kernel family -> (head dims its sources instantiate, sources)
_SOURCES = {"flash": (KERNEL_HEAD_DIMS, "csrc/flash_fwd.cu"),
            "small_s": (SMALL_S_HEAD_DIMS, "csrc/small_s_fwd.cu / small_s_bwd.cu")}


def _flash_fwd_cuda(q, k, v, scale: float, kernel: str = "flash_fwd"):
    """Launch `kernel` ("flash_fwd": csrc/flash_fwd.cu, K1; "small_s_fwd":
    csrc/small_s_fwd.cu, K2; same C signature) on CUDA tensors; returns
    (out, lse)."""
    _check_kernel_inputs({"q": q, "k": k, "v": v}, kernel, *_SOURCES[kernel.rsplit("_", 1)[0]])
    dev = q.device
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse
    lib = _build.load_library()
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"ivt_{kernel}")(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, sq, sk, h, d, strides,
            float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t {rc}")
    _launches[kernel] += 1
    return out, lse


def _seg_ptrs(q_seg, kv_seg):
    """(int32 contiguous segment ids or None, their device pointers or None)."""
    if q_seg is None:
        return (None, None), (None, None)
    segs = tuple(x.to(torch.int32).contiguous() for x in (q_seg, kv_seg))
    return segs, tuple(x.data_ptr() for x in segs)


def _check_causal_dims(d: int, dv: int, pairs, source: str) -> None:
    if (d, dv) not in pairs:
        raise NotImplementedError(
            f"head dims (d_qk, d_v) = {(d, dv)} are not instantiated in {source} {pairs} "
            "(ROADMAP queue 2, K5)")


def _flash_fwd_causal_cuda(q, k, v, scale: float, causal: bool, q_position_offset: int,
                           q_seg=None, kv_seg=None, window: Optional[int] = None):
    """Launch K5 (csrc/flash_fwd_causal.cu; with segment ids its K8
    instantiation) on CUDA (B, S, H, D) tensors, q/k at d_qk and v at d_v,
    k/v with Hkv heads (Hq a multiple of Hkv): causal (query row i sees key
    j iff j <= i + q_position_offset) or not, with a sliding `window` or
    not; returns (out (B, Sq, Hq, d_v), lse)."""
    b, sq, h, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    _check_causal_dims(d, dv, CAUSAL_HEAD_DIMS, "csrc/flash_fwd_causal.cu")
    _check_kernel_inputs({"q": q, "k": k, "v": v}, "flash_fwd_causal", head_dims=(d,),
                         source="csrc/flash_fwd_causal.cu")
    dev = q.device
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse
    (q_seg, kv_seg), seg_ptrs = _seg_ptrs(q_seg, kv_seg)  # int32 copies kept to the launch
    lib = _build.load_library()
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ivt_flash_fwd_causal(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), *seg_ptrs, b, sq, sk, h, d, dv, strides,
            float(scale), int(causal), int(q_position_offset), k.shape[2],
            int(window) if window is not None else 0, stream)
    name = ("flash_fwd_causal_window" if window is not None
            else "flash_fwd_causal_gqa" if k.shape[2] != h
            else "flash_fwd_causal_seg" if q_seg is not None else "flash_fwd_causal")
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")
    _launches[name] += 1
    return out, lse


def _bwd_delta(out, do, lse_ct=None) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32 minus the LSE cotangent, (B, H, Sq)
    contiguous; computed in torch, as the JAX package leaves it to XLA
    (:792-797)."""
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    if lse_ct is not None:
        delta = delta - lse_ct.float()
    return delta.contiguous()


def _launch_bwd(name: str, q, k, v, do, lse, delta, outs, scale: float) -> None:
    """Launch one backward kernel ("flash_bwd_dq" / "small_s_bwd_dq" into
    outs = (dq,), "flash_bwd_dkv" / "small_s_bwd_dkv" into outs = (dk, dv);
    csrc/flash_bwd.cu, csrc/small_s_bwd.cu) on the current stream of q's
    device."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    lib = _build.load_library()
    strides = (ctypes.c_longlong * 18)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *outs[0].stride()[:3], *outs[-1].stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, f"ivt_{name}")(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
            b, sq, sk, h, d, strides, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")
    _launches[name] += 1


def _flash_bwd_cuda(q, k, v, out, lse, do, scale: float, lse_ct=None, prefix: str = "flash"):
    """Launch the dq and dk/dv kernels of csrc/flash_bwd.cu (prefix
    "flash", K4a) or csrc/small_s_bwd.cu ("small_s", K4b); returns
    (dq, dk, dv)."""
    if do.stride(-1) != 1 or any(s % 8 for s in do.stride()[:3]) or do.data_ptr() % 16:
        do = do.contiguous()
    _check_kernel_inputs({"q": q, "k": k, "v": v, "dout": do}, f"{prefix}_bwd",
                         *_SOURCES[prefix])
    delta, lse = _bwd_delta(out, do, lse_ct), lse.contiguous()
    dq, dk, dv = (torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in (q, k, v))
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    _launch_bwd(f"{prefix}_bwd_dq", q, k, v, do, lse, delta, (dq,), scale)
    _launch_bwd(f"{prefix}_bwd_dkv", q, k, v, do, lse, delta, (dk, dv), scale)
    return dq, dk, dv


def _launch_bwd_causal(kind: str, q, k, v, do, lse, delta, seg_ptrs, grads, scale: float,
                       causal: bool, q_position_offset: int,
                       window: Optional[int] = None) -> None:
    """Launch one K5 backward kernel, `kind` "dq" (csrc/flash_bwd_causal_dq.cu,
    writes grads[0]) or "dkv" (flash_bwd_causal_dkv.cu, writes grads[1:]);
    `grads` = (dq, dk, dv), `seg_ptrs` the segment ids' pointers or Nones;
    k / v (and dk / dv) may have fewer heads than q (grouped-query)."""
    b, sq, h, d = q.shape
    dq, dk, dv = grads
    lib = _build.load_library()
    strides = (ctypes.c_longlong * 21)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, f"ivt_flash_bwd_causal_{kind}")(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *seg_ptrs, dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, sq, k.shape[1], h, d, v.shape[-1], strides, float(scale),
            int(causal), int(q_position_offset), k.shape[2],
            int(window) if window is not None else 0, stream)
    name = f"flash_bwd_causal_{kind}" + (
        "_window" if window is not None else "_gqa" if k.shape[2] != h
        else "_seg" if seg_ptrs[0] is not None else "")
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")
    _launches[name] += 1


def _flash_bwd_causal_cuda(q, k, v, out, lse, do, scale: float, causal: bool,
                           q_position_offset: int, q_seg=None, kv_seg=None, lse_ct=None,
                           window: Optional[int] = None):
    """Launch the K5 backward kernels (dq, then dk/dv; with segment ids their
    K8 instantiations) on CUDA tensors, k / v with Hkv heads (Hq a multiple
    of Hkv), with a sliding `window` or not; returns (dq, dk, dv)."""
    d, dv_dim = q.shape[-1], v.shape[-1]
    _check_causal_dims(d, dv_dim, CAUSAL_BWD_HEAD_DIMS, "csrc/flash_bwd_causal_*.cu")
    if do.stride(-1) != 1 or any(s % 8 for s in do.stride()[:3]) or do.data_ptr() % 16:
        do = do.contiguous()
    _check_kernel_inputs({"q": q, "k": k, "v": v, "dout": do}, "flash_bwd_causal",
                         head_dims=(d,), source="csrc/flash_bwd_causal_*.cu")
    delta, lse = _bwd_delta(out, do, lse_ct), lse.contiguous()
    grads = tuple(torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in (q, k, v))
    if grads[0].numel() == 0 or grads[1].numel() == 0:
        return tuple(g.zero_() for g in grads)
    segs, seg_ptrs = _seg_ptrs(q_seg, kv_seg)  # `segs` keeps the int32 copies alive
    for kind in ("dq", "dkv"):
        _launch_bwd_causal(kind, q, k, v, do, lse, delta, seg_ptrs, grads, scale, causal,
                           q_position_offset, window)
    del segs
    return grads


class FlashAttention(torch.autograd.Function):
    """(q, k, v) -> (out, lse) with the kernels on CUDA, the plain versions
    on the CPU; differentiable in both outputs. Causal, narrow-v (d_v !=
    d_qk), segmented, grouped-query (Hkv < Hq) or windowed calls run K5
    (with segment ids its K8 kernels), forward and backward; the rest K1 /
    K4a."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool = False, q_position_offset: int = 0,
                q_seg=None, kv_seg=None, window: Optional[int] = None):
        gqa = k.shape[2] != q.shape[2]
        k5 = (causal or v.shape[-1] != q.shape[-1] or q_seg is not None or gqa
              or window is not None)
        if q.is_cuda:
            out, lse = (_flash_fwd_causal_cuda(q, k, v, scale, causal, q_position_offset,
                                               q_seg, kv_seg, window)
                        if k5 else _flash_fwd_cuda(q, k, v, scale))
        elif q.device.type == "cpu":
            out, lse = flash_attention_ref_with_lse(q, k, v, scale, causal, q_position_offset,
                                                    q_seg, kv_seg, window)
        else:
            raise NotImplementedError(f"no flash attention for device {q.device}")
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, out, lse, q_seg, kv_seg)
        ctx.scale, ctx.k5, ctx.causal, ctx.q_off = scale, k5, causal, q_position_offset
        ctx.window = window
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse, q_seg, kv_seg = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        if q.is_cuda:
            if ctx.k5:
                dq, dk, dv = _flash_bwd_causal_cuda(q, k, v, out, lse, dout, ctx.scale,
                                                    ctx.causal, ctx.q_off, q_seg, kv_seg,
                                                    lse_ct=dlse, window=ctx.window)
            else:
                dq, dk, dv = _flash_bwd_cuda(q, k, v, out, lse, dout, ctx.scale, lse_ct=dlse)
        else:
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, out, lse, dout, ctx.scale, lse_ct=dlse,
                                                 causal=ctx.causal,
                                                 q_position_offset=ctx.q_off,
                                                 q_segment_ids=q_seg, kv_segment_ids=kv_seg,
                                                 window=ctx.window)
        return dq, dk, dv, None, None, None, None, None, None


def small_s_attention_ref(q, k, v, scale: float):
    """Plain PyTorch version of the K2 kernel on (B, S, H, D) inputs:
    (out, natural-log lse).

    The JAX kernel's cast chain (flash_attention.py:1505-1521): fp32
    scores in the base-2 domain, unnormalised probabilities exp2(s - max)
    cast to v's dtype before PV, fp32 accumulation, divided by the fp32 row
    sum, output in q's dtype. Loops over the batch, as the flash plain
    version does.
    """
    outs, lses = [], []
    for i in range(q.shape[0]):
        qi, ki, vi = (x[i].transpose(0, 1) for x in (q, k, v))  # (H, S, D)
        s = torch.matmul(qi.float(), ki.float().transpose(1, 2)) * (scale * _LOG2E)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
        denom = p.sum(dim=-1, keepdim=True)
        out = torch.matmul(p.to(v.dtype).float(), vi.float()) / denom
        outs.append(out.to(q.dtype).transpose(0, 1))
        lses.append(((m + torch.log2(denom)) / _LOG2E).squeeze(-1))
    return torch.stack(outs), torch.stack(lses)


def small_s_attention_bwd_ref(q, k, v, out, lse, do, scale: float):
    """Plain PyTorch version of the K4b kernels: (dq, dk, dv).

    The JAX small-S backward (:1524-1603) computes the same formulas, with
    the same casts, as the flash backward: p = exp(s - lse), delta =
    rowsum(dO * O), ds = p * (dp - delta) rounded to k's dtype, p rounded to
    dO's dtype before p^T dO. So this is `flash_attention_bwd_ref`."""
    return flash_attention_bwd_ref(q, k, v, out, lse, do, scale)


class SmallSAttention(torch.autograd.Function):
    """(q, k, v) (B, S, H, D), 0 < Sq, Sk <= 1024 -> out: the K2 kernel
    forward and the K4b kernels backward on CUDA, the plain versions on
    the CPU. The forward keeps its LSE for the backward (the JAX dq kernel
    recomputes it; the gradients are the same)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        if q.is_cuda:
            out, lse = _flash_fwd_cuda(q, k, v, scale, kernel="small_s_fwd")
        elif q.device.type == "cpu":
            out, lse = small_s_attention_ref(q, k, v, scale)
        else:
            raise NotImplementedError(f"no small-S attention for device {q.device}")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.is_cuda:
            dq, dk, dv = _flash_bwd_cuda(q, k, v, out, lse, dout, ctx.scale, prefix="small_s")
        else:
            dq, dk, dv = small_s_attention_bwd_ref(q, k, v, out, lse, dout, ctx.scale)
        return dq, dk, dv, None


def small_s_attention(q, k, v, num_heads: int, scale: float) -> torch.Tensor:
    """`_small_s_attention` (:1606) in its layout: q/k/v (B, S, H*D), the
    free reshape of the projection, -> (B, Sq, H*D)."""
    heads = (num_heads, q.shape[-1] // num_heads)
    out = SmallSAttention.apply(*(x.unflatten(-1, heads) for x in (q, k, v)), scale)
    return out.flatten(-2)


def _small_s_kernel_takes(x: torch.Tensor, num_heads: int, head_dim: int,
                          head_dims=SMALL_S_HEAD_DIMS) -> bool:
    """The Hopper conditions of the small-S kernels (K2, K4b, K3; K11 with
    its `head_dims`) for a (B, S, ...) tensor: dtype, an instantiated head
    dim, the grid limits, and for bf16 16-byte rows (unit last stride,
    strides multiples of 8, a 16-byte aligned base)."""
    if x.dtype not in _DTYPE_CODES or head_dim not in head_dims:
        return False
    if x.shape[0] > _GRID_MAX or num_heads > _GRID_MAX or x.stride(-1) != 1:
        return False
    return x.dtype == torch.float32 or not (
        any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16)


def takes_small_s(q, k, v, *, causal=False, q_segment_ids=None, kv_segment_ids=None,
                  window=None, layout: str = "bshd") -> bool:
    """Does `flash_attention` take the small-S route? The JAX package's
    condition (:2080-2086) without its VMEM budget `_ss_fits`, and for CUDA
    tensors the kernels' own conditions in its place. q/k/v are (B, S, H,
    D) with layout "bshd", (B, H, S, D) with "bhsd" (which the JAX small-S
    route never takes)."""
    if not (layout == "bshd" and q_segment_ids is None and kv_segment_ids is None
            and not causal and window is None):
        return False
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hq != hkv or v.shape[-1] != d or not (0 < sq <= SMALL_S_MAX and 0 < sk <= SMALL_S_MAX):
        return False
    return not q.is_cuda or all(_small_s_kernel_takes(x, hq, d) for x in (q, k, v))


def _fused_qkv_unfused(qkv, q_weight, k_weight, num_heads: int, scale: float, eps: float,
                       plain: bool = False):
    """slice -> rms_norm -> small-S attention on (B, S, 3W) `qkv`, (B, S, W):
    the composition K3's backward differentiates (`_fused_qkv_unfused_ref`
    :1755; K2 / K4b on CUDA), or with `plain` the small-S plain version."""
    w = qkv.shape[-1] // 3
    q = rms_norm(qkv[..., :w], q_weight, eps=eps)
    k = rms_norm(qkv[..., w:2 * w], k_weight, eps=eps)
    if not plain:
        return small_s_attention(q, k, qkv[..., 2 * w:], num_heads, scale)
    heads = (num_heads, w // num_heads)
    out, _ = small_s_attention_ref(*(x.unflatten(-1, heads) for x in (q, k, qkv[..., 2 * w:])),
                                   scale)
    return out.flatten(-2)


def fused_qkv_ref(qkv, q_weight, k_weight, num_heads: int, scale: float, eps: float = 1e-6):
    """Plain PyTorch version of K3: rms_norm of the q and k slices of
    (B, S, 3W) `qkv` with the (W,) weights, then the small-S plain
    attention; (B, S, W)."""
    return _fused_qkv_unfused(qkv, q_weight, k_weight, num_heads, scale, eps, plain=True)


# fused kernel -> (head dims its source instantiates, source, (lo, hi]: its S range)
_FUSED = {"fused_qkv_fwd": (SMALL_S_HEAD_DIMS, "csrc/fused_qkv.cu", (0, SMALL_S_MAX)),
          "fused_qkv_large_fwd": (FUSED_LARGE_HEAD_DIMS, "csrc/fused_qkv_large.cu",
                                  (SMALL_S_MAX, FUSED_LARGE_MAX))}


def fused_qkv_large_prepass_ref(qkv, k_weight, eps: float = 1e-6):
    """Plain PyTorch version of K11's pre-pass on (B, S, 3W) `qkv`: (q_rstd,
    k_rstd, k_normed), the 1/rms of every q and k row over the whole W,
    (B, S) fp32, and the k slice normed with the (W,) weight, (B, S, W) in
    qkv's dtype: `rms_norm` of the k slice, the cast chain of `_norm`
    (:1905-1910)."""
    w = qkv.shape[-1] // 3
    q_rstd, k_rstd = (torch.rsqrt(x.float().square().mean(dim=-1) + eps)
                      for x in (qkv[..., :w], qkv[..., w:2 * w]))
    return q_rstd, k_rstd, rms_norm(qkv[..., w:2 * w], k_weight, eps=eps)


def _fused_prepass_cuda(qkv, k_weight, eps: float, normed_k: bool = False):
    """The row-statistics pre-pass of K3 / K11 on a CUDA (B, S, 3W) tensor
    (csrc/fused_qkv.cu), counted as "fused_qkv_rstd": (q_rstd, k_rstd,
    k_normed). With `normed_k` (K11, bf16 only) it also writes the k slice
    normed with the (W,) fp32 `k_weight` (16-byte aligned) into a (B, S, W)
    buffer it allocates; else k_normed is None. The caller has checked the
    shapes and strides."""
    b, s, w3 = qkv.shape
    w = w3 // 3
    dev = qkv.device
    q_rstd = torch.empty((b, s), dtype=torch.float32, device=dev)
    k_rstd = torch.empty((b, s), dtype=torch.float32, device=dev)
    k_normed = torch.empty((b, s, w), dtype=qkv.dtype, device=dev) if normed_k else None
    lib = _build.load_library()
    s_b, s_s = qkv.stride()[:2]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if normed_k:
            rc = lib.ivt_fused_qkv_rstd_normed_k(
                qkv.data_ptr(), q_rstd.data_ptr(), k_rstd.data_ptr(), k_weight.data_ptr(),
                k_normed.data_ptr(), b, s, w, s_b, s_s, float(eps), stream)
        else:
            rc = lib.ivt_fused_qkv_rstd(_DTYPE_CODES[qkv.dtype], qkv.data_ptr(), q_rstd.data_ptr(),
                                        k_rstd.data_ptr(), b, s, w, s_b, s_s, float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"fused_qkv_rstd kernel launch failed: cudaError_t {rc}")
    _launches["fused_qkv_rstd"] += 1
    return q_rstd, k_rstd, k_normed


def _fused_qkv_cuda(qkv, q_weight, k_weight, num_heads: int, scale: float, eps: float,
                    kernel: str = "fused_qkv_fwd"):
    """Launch K3 (`kernel` "fused_qkv_fwd", csrc/fused_qkv.cu) or K11
    ("fused_qkv_large_fwd", csrc/fused_qkv_large.cu) on a CUDA (B, S, 3W)
    tensor: the row-statistics pre-pass (for K11 in bf16 it also writes the
    normed k rows), then the attention kernel; (B, S, W)."""
    head_dims, source, (lo, hi) = _FUSED[kernel]
    b, s, w3 = qkv.shape
    w = w3 // 3
    d = w // num_heads
    if w3 != 3 * w or w != num_heads * d:
        raise ValueError(f"qkv {tuple(qkv.shape)} is not (B, S, 3 * {num_heads} * D)")
    if qkv.dtype not in _DTYPE_CODES:
        raise NotImplementedError(f"fused qkv kernel takes float32 or bfloat16, got {qkv.dtype}")
    if d not in head_dims:
        raise NotImplementedError(
            f"head dim {d} is not instantiated in {source} {head_dims} (ROADMAP queue 2)")
    if not lo < s <= hi:
        raise ValueError(f"{kernel} kernel takes {lo} < S <= {hi}, got {s}")
    if not _small_s_kernel_takes(qkv, num_heads, d, head_dims):
        raise ValueError(
            f"qkv: the kernel needs a unit last stride, batch {b} / heads {num_heads} within "
            f"{_GRID_MAX}, and for bf16 16-byte rows (strides {qkv.stride()}, "
            f"ptr {qkv.data_ptr():#x})")
    dev = qkv.device
    # the kernel reads the weights as float4: contiguous fp32, 16-byte aligned
    qw, kw = (x.to(device=dev, dtype=torch.float32).contiguous() for x in (q_weight, k_weight))
    qw, kw = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (qw, kw))
    if qw.shape != (w,) or kw.shape != (w,):
        raise ValueError(f"q/k weights {tuple(qw.shape)} / {tuple(kw.shape)}, expected ({w},)")
    out = torch.empty((b, s, w), dtype=qkv.dtype, device=dev)
    if out.numel() == 0:
        return out
    large = kernel == "fused_qkv_large_fwd"
    q_rstd, k_rstd, k_normed = _fused_prepass_cuda(
        qkv, kw, eps, normed_k=large and qkv.dtype == torch.bfloat16)
    # K11's entry also takes the normed k rows (null for fp32)
    normed = (None if k_normed is None else k_normed.data_ptr(),) if large else ()
    lib = _build.load_library()
    code, (s_b, s_s) = _DTYPE_CODES[qkv.dtype], qkv.stride()[:2]
    with torch.cuda.device(dev):
        rc = getattr(lib, f"ivt_{kernel}")(
            code, qkv.data_ptr(), *normed, q_rstd.data_ptr(), k_rstd.data_ptr(), qw.data_ptr(),
            kw.data_ptr(), out.data_ptr(), b, s, num_heads, d, s_b, s_s, s * w, w, d,
            float(scale), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError_t {rc}")
    _launches[kernel] += 1
    _fused_launches_by_len[kernel, s] = _fused_launches_by_len.get((kernel, s), 0) + 1
    return out


class FusedQKVAttention(torch.autograd.Function):
    """(qkv (B, S, 3W), q_weight, k_weight) -> (B, S, W): K3 on CUDA, its
    plain version on the CPU; the backward is autograd through the unfused
    composition, as `_fused_qkv_bwd_rule` (:1770-1778), so the gradients
    are the production path's (on CUDA: K2 recompute, then K4b)."""

    @staticmethod
    def forward(ctx, qkv, q_weight, k_weight, num_heads: int, scale: float, eps: float):
        if qkv.is_cuda:
            out = _fused_qkv_cuda(qkv, q_weight, k_weight, num_heads, scale, eps)
        elif qkv.device.type == "cpu":
            out = fused_qkv_ref(qkv, q_weight, k_weight, num_heads, scale, eps)
        else:
            raise NotImplementedError(f"no fused qkv attention for device {qkv.device}")
        ctx.save_for_backward(qkv, q_weight, k_weight)
        ctx.args = (num_heads, scale, eps)
        return out

    @staticmethod
    def backward(ctx, g):
        leaves = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            out = _fused_qkv_unfused(*leaves, *ctx.args)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None)


def fused_qkv_eligible(s: int, num_heads: int, head_dim: int, itemsize: int) -> bool:
    """Can (B, S, 3W) self-attention take K3? The JAX condition (:1784)
    without its TPU-only parts (W % 128 lane alignment, the `_ss_fits` VMEM
    budget) and with the kernel's own: an instantiated head dim (all are
    multiples of 8, so bf16 rows and the three column views are 16-byte
    aligned), fp32 or bf16, the grid's head limit."""
    return (0 < s <= SMALL_S_MAX and head_dim in SMALL_S_HEAD_DIMS
            and itemsize in (2, 4) and num_heads <= _GRID_MAX)


def _fused_large_unfused(qkv, q_weight, k_weight, num_heads: int, scale: float, eps: float,
                         plain: bool = False):
    """slice -> rms_norm -> flash attention on (B, S, 3W) `qkv`, (B, S, W):
    the composition K11's backward differentiates (`_fused_large_unfused_ref`
    :1995; K1 / K4a on CUDA), or with `plain` the flash plain version."""
    w = qkv.shape[-1] // 3
    heads = (num_heads, w // num_heads)
    q = rms_norm(qkv[..., :w], q_weight, eps=eps).unflatten(-1, heads)
    k = rms_norm(qkv[..., w:2 * w], k_weight, eps=eps).unflatten(-1, heads)
    v = qkv[..., 2 * w:].unflatten(-1, heads)
    if plain:
        return flash_attention_ref(q, k, v, scale).flatten(-2)
    return FlashAttention.apply(q, k, v, scale)[0].flatten(-2)


def fused_qkv_large_ref(qkv, q_weight, k_weight, num_heads: int, scale: float,
                        eps: float = 1e-6):
    """Plain PyTorch version of K11: rms_norm of the q and k slices of
    (B, S, 3W) `qkv` with the (W,) weights, then the flash plain version;
    (B, S, W)."""
    return _fused_large_unfused(qkv, q_weight, k_weight, num_heads, scale, eps, plain=True)


class FusedQKVLargeAttention(torch.autograd.Function):
    """(qkv (B, S, 3W), q_weight, k_weight) -> (B, S, W) for 1024 < S <=
    8192: K11 on CUDA, its plain version on the CPU; the backward is
    autograd through the unfused composition, as `_fused_large_bwd_rule`
    (:2012-2020), so the gradients are the production path's (on CUDA: K1
    recompute, then K4a)."""

    @staticmethod
    def forward(ctx, qkv, q_weight, k_weight, num_heads: int, scale: float, eps: float):
        if qkv.is_cuda:
            out = _fused_qkv_cuda(qkv, q_weight, k_weight, num_heads, scale, eps,
                                  kernel="fused_qkv_large_fwd")
        elif qkv.device.type == "cpu":
            out = fused_qkv_large_ref(qkv, q_weight, k_weight, num_heads, scale, eps)
        else:
            raise NotImplementedError(f"no fused qkv attention for device {qkv.device}")
        ctx.save_for_backward(qkv, q_weight, k_weight)
        ctx.args = (num_heads, scale, eps)
        return out

    @staticmethod
    def backward(ctx, g):
        leaves = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            out = _fused_large_unfused(*leaves, *ctx.args)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None)


def fused_qkv_large_eligible(s: int, num_heads: int, head_dim: int, itemsize: int) -> bool:
    """Can (B, S, 3W) self-attention take K11? The JAX condition (:2026-2034):
    1024 < S <= 8192 and at most 128 heads, without its TPU-only parts (W %
    128 lane alignment, the `_fused_large_block` VMEM fit) and with the
    kernel's own: a head dim csrc/fused_qkv_large.cu instantiates, fp32 or
    bf16."""
    return (SMALL_S_MAX < s <= FUSED_LARGE_MAX and num_heads <= _FUSED_LARGE_MAX_HEADS
            and head_dim in FUSED_LARGE_HEAD_DIMS and itemsize in (2, 4))


def fused_qkv_rmsnorm_attention(
    qkv: torch.Tensor,  # (B, S, 3W): one flat projection GEMM output
    q_weight: torch.Tensor,  # (W,) fp32 RMSNorm weight over the flattened dim
    k_weight: torch.Tensor,
    *,
    num_heads: int,
    eps: float = 1e-6,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused qkv slice + whole-dim QK-RMSNorm + attention; returns (B, S, W)
    in the projection layout. Routes as the JAX op (:1820-1838): S <= 1024
    takes K3 (`FusedQKVAttention`), 1024 < S <= 8192 K11
    (`FusedQKVLargeAttention`). The caller checks `fused_qkv_eligible` /
    `fused_qkv_large_eligible` (the CUDA wrappers raise on what the kernels
    cannot take)."""
    b, s, w3 = qkv.shape
    w = w3 // 3
    if w3 != 3 * w or w % num_heads:
        raise ValueError(f"qkv {tuple(qkv.shape)} does not split into 3 x {num_heads} heads")
    d = w // num_heads
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    if s <= SMALL_S_MAX:
        return FusedQKVAttention.apply(qkv, q_weight, k_weight, num_heads, scale, eps)
    if s <= FUSED_LARGE_MAX:
        return FusedQKVLargeAttention.apply(qkv, q_weight, k_weight, num_heads, scale, eps)
    raise ValueError(f"fused qkv attention takes S <= {FUSED_LARGE_MAX}, got {s}")


def flash_attention_with_lse(
    q: torch.Tensor,  # (B, Sq, H, D), or (B, H, Sq, D) with layout="bhsd"
    k: torch.Tensor,  # (B, Sk, H, D)
    v: torch.Tensor,  # (B, Sk, H, D_v)
    *,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    window: Optional[int] = None,
    q_position_offset: int = 0,
    layout: str = "bshd",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out (B, Sq, H, D_v) in q's layout, lse (B, H, Sq) natural log,
    float32), differentiable in both. Non-causal calls with D_v == D and no
    segment ids run K1 / K4a; causal, narrow-v, segmented, grouped-query (k
    / v with fewer heads than q) and windowed calls run K5 forward and
    backward (K8 with segment ids). With causal or a window, query row i
    sits at key index i + q_position_offset."""
    q, k, v = _to_bshd(layout, q, k, v)
    _check_supported(q, k, v, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                     window=window, layout=layout)
    scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
    positioned = causal or window is not None
    out, lse = FlashAttention.apply(q, k, v, scale, bool(causal),
                                    int(q_position_offset) if positioned else 0,
                                    q_segment_ids, kv_segment_ids,
                                    None if window is None else int(window))
    return _to_bshd(layout, out)[0], lse


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D), or (B, H, Sq, D) with layout="bhsd"
    k: torch.Tensor,  # (B, Sk, H, D)
    v: torch.Tensor,  # (B, Sk, H, D_v)
    *,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    softmax_scale: Optional[float] = None,
    window: Optional[int] = None,
    q_position_offset: int = 0,
    layout: str = "bshd",
) -> torch.Tensor:
    """Flash attention. Short non-causal sequences (0 < Sq, Sk <= 1024, see
    `takes_small_s`) take the small-S route (K2 / K4b), as in the JAX
    package; the rest `flash_attention_with_lse` (K1 / K4a, or K5 for
    causal, narrow-v, segmented, grouped-query and windowed calls)."""
    kw = dict(causal=causal, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              window=window, layout=layout)
    if takes_small_s(q, k, v, **kw):
        scale = softmax_scale if softmax_scale is not None else q.shape[-1] ** -0.5
        return SmallSAttention.apply(q, k, v, scale)
    return flash_attention_with_lse(q, k, v, softmax_scale=softmax_scale,
                                    q_position_offset=q_position_offset, **kw)[0]
