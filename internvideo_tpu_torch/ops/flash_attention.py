"""Flash attention, forward and backward: the Hopper CUDA kernels and their
plain versions.

Counterpart of internvideo_tpu/ops/flash_attention.py `flash_attention`
(:2037) and `flash_attention_with_lse` (:1188) with their custom VJPs, for
the case the InternVideo2 encoder runs: non-causal, no segment ids, no
window, one K/V head per query head, d_v == d_qk, layout (B, S, H, D).
Every other argument raises NotImplementedError naming the ROADMAP item
that brings it.

`FlashAttention` is the autograd Function. On a CUDA tensor its forward
launches `csrc/flash_fwd.cu` and its backward the dq and dk/dv kernels of
`csrc/flash_bwd.cu` (built by `_build`), or raises; on a CPU tensor they
run the plain versions `flash_attention_ref_with_lse` and
`flash_attention_bwd_ref`. There is no fallback from one to the other.
Both outputs are differentiable: an LSE cotangent folds into delta.

The LSE is the natural-log softmax normaliser, (B, H, Sq) float32; a row
that sees no key gets out 0 and LSE -inf.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from internvideo_tpu_torch.ops import _build

# Head dims the kernels are instantiated for (csrc/flash_fwd.cu IVT_CASE,
# csrc/flash_bwd.cu IVT_BWD_DISPATCH).
KERNEL_HEAD_DIMS = (64, 88)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
_launches = dict.fromkeys(KERNELS, 0)


def launch_count(kernel: str = "flash_fwd") -> int:
    """How many times `kernel` (one of KERNELS) has been launched on the
    card in this process."""
    return _launches[kernel]


def reset_launch_count() -> None:
    """Set every kernel's launch count to 0."""
    for name in KERNELS:
        _launches[name] = 0


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


def flash_attention_bwd_ref(q, k, v, out, lse, do, scale: float, lse_ct=None):
    """Plain PyTorch version of the backward kernels: (dq, dk, dv).

    The explicit formulas in fp32 with the JAX kernels' cast chain
    (flash_attention.py:1316-1333): p = exp(s - lse), delta = rowsum(dO * O)
    minus the LSE cotangent `lse_ct` (B, H, Sq) if given, ds = p * (dp -
    delta) rounded to k's dtype before the ds k and ds^T q products, p
    rounded to dO's dtype before p^T dO; each gradient in its input's dtype.
    Loops over the batch, as the forward's plain version does.
    """
    f32 = torch.float32
    dqs, dks, dvs = [], [], []
    for i in range(q.shape[0]):
        qi, ki, vi, oi, doi = (x[i].transpose(0, 1).to(f32) for x in (q, k, v, out, do))
        lse_i = lse[i][..., None]
        s = torch.matmul(qi, ki.transpose(1, 2)) * scale
        # a row that saw no key (lse -inf) has p = 0
        p = torch.where(torch.isinf(lse_i), 0.0, torch.exp(s - lse_i))
        dp = torch.matmul(doi, vi.transpose(1, 2))
        delta = (doi * oi).sum(-1)
        if lse_ct is not None:
            delta = delta - lse_ct[i].to(f32)
        ds = (p * (dp - delta[..., None])).to(k.dtype).to(f32)
        dqs.append((scale * torch.matmul(ds, ki)).to(q.dtype).transpose(0, 1))
        dks.append((scale * torch.matmul(ds.transpose(1, 2), qi)).to(k.dtype).transpose(0, 1))
        dvs.append(torch.matmul(p.to(do.dtype).to(f32).transpose(1, 2), doi)
                   .to(v.dtype).transpose(0, 1))
    return torch.stack(dqs), torch.stack(dks), torch.stack(dvs)


def _check_kernel_inputs(tensors, what: str) -> None:
    """Raise unless `tensors` (name -> (B, S, H, D) tensor) can go to the
    kernels: one device and dtype (fp32 or bf16), an instantiated head dim,
    a unit head-dim stride, and for bf16 16-byte rows."""
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
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} / heads {h} exceed the kernel grid's 65535 limit")
    if d not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"head dim {d} is not instantiated in csrc/flash_fwd.cu {KERNEL_HEAD_DIMS}")
    for name, x in tensors.items():
        if x.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit stride on the head dim, got {x.stride()}")
        if dt == torch.bfloat16 and (any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16):
            raise ValueError(
                f"{name}: the bf16 kernel loads 16-byte rows, so batch/seq/head "
                f"strides must be multiples of 8 and the base 16-byte aligned "
                f"(strides {x.stride()}, ptr {x.data_ptr():#x})")


def _flash_fwd_cuda(q, k, v, scale: float):
    """Launch csrc/flash_fwd.cu on CUDA tensors; returns (out, lse)."""
    _check_kernel_inputs({"q": q, "k": k, "v": v}, "flash_fwd")
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
        rc = lib.ivt_flash_fwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, sq, sk, h, d, strides,
            float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError_t {rc}")
    _launches["flash_fwd"] += 1
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
    """Launch one backward kernel of csrc/flash_bwd.cu ("flash_bwd_dq" into
    outs = (dq,), "flash_bwd_dkv" into outs = (dk, dv)) on the current
    stream of q's device."""
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


def _flash_bwd_cuda(q, k, v, out, lse, do, scale: float, lse_ct=None):
    """Launch the two kernels of csrc/flash_bwd.cu; returns (dq, dk, dv)."""
    if do.stride(-1) != 1 or any(s % 8 for s in do.stride()[:3]) or do.data_ptr() % 16:
        do = do.contiguous()
    _check_kernel_inputs({"q": q, "k": k, "v": v, "dout": do}, "flash_bwd")
    delta, lse = _bwd_delta(out, do, lse_ct), lse.contiguous()
    dq, dk, dv = (torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in (q, k, v))
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    _launch_bwd("flash_bwd_dq", q, k, v, do, lse, delta, (dq,), scale)
    _launch_bwd("flash_bwd_dkv", q, k, v, do, lse, delta, (dk, dv), scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """(q, k, v) -> (out, lse) with the kernels on CUDA, the plain versions
    on the CPU; differentiable in both outputs."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        if q.is_cuda:
            out, lse = _flash_fwd_cuda(q, k, v, scale)
        elif q.device.type == "cpu":
            out, lse = flash_attention_ref_with_lse(q, k, v, scale)
        else:
            raise NotImplementedError(f"no flash attention for device {q.device}")
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        bwd = _flash_bwd_cuda if q.is_cuda else flash_attention_bwd_ref
        dq, dk, dv = bwd(q, k, v, out, lse, dout, ctx.scale, lse_ct=dlse)
        return dq, dk, dv, None


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
    return FlashAttention.apply(q, k, v, scale)


def flash_attention(q, k, v, **kwargs) -> torch.Tensor:
    """Flash attention over (B, S, H, D) inputs; see flash_attention_with_lse."""
    return flash_attention_with_lse(q, k, v, **kwargs)[0]
