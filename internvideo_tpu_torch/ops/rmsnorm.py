"""RMSNorm in plain PyTorch, and the fused add + RMSNorm kernels K9 and K10.

Port of internvideo_tpu/ops/rmsnorm.py:

  * `rms_norm` (:27), which the JAX package leaves to XLA. Variance math is
    fp32 whatever the input dtype; the normed value is cast to x's dtype,
    multiplied by the (fp32) weight, and cast to x's dtype again: two
    roundings in bf16, as in JAX.
  * `fused_add_rms_norm` (:60, K9 `_fused_kernel` :52): (x + residual) ->
    RMSNorm, returning (normed, x + residual). Its own cast chain, not
    `rms_norm`'s: the sum is taken in fp32, the output rounds once to x's
    dtype and the sum once to the residual's (bf16 x with an fp32 residual
    stream is the case it is for). JAX gives it no VJP and nothing
    differentiates it, so on the card it is inference-only (it raises when
    autograd would need a gradient); the plain version on the CPU
    differentiates through autograd.
  * `fused_ls_add_rms_norm` (`_fused_ls_add_rms_norm` :147, K10
    `_fused_ls_kernel` :127): LayerScale(h) + residual -> RMSNorm with the
    encoder Block's cast chain; its backward differentiates the unfused
    composition `_ls_add_norm_ref` (:140), as `_fused_ls_bwd` (:183-189)
    does.

A CUDA tensor runs the kernel (csrc/rmsnorm.cu) or raises; a CPU tensor runs
the plain version. No model calls K9 or K10, in JAX or here (the JAX Block
measured them slower on the TPU, nn/transformer.py:225-230).
"""

from __future__ import annotations

from typing import Optional

import torch

from internvideo_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNELS = ("fused_add_rms_norm", "fused_ls_add_rms_norm")
_launches = dict.fromkeys(KERNELS, 0)


def launch_count(kernel: str = "fused_add_rms_norm") -> int:
    """How many times `kernel` (one of KERNELS) has been launched on the
    card in this process."""
    return _launches[kernel]


def reset_launch_count() -> None:
    for name in KERNELS:
        _launches[name] = 0


def rms_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    *,
    eps: float = 1e-6,
    residual: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """RMSNorm over the last dim; optionally adds `residual` into x first."""
    if residual is not None:
        x = x + residual
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (weight * normed.to(x.dtype)).to(x.dtype)


def fused_add_rms_norm_ref(x, residual, weight, eps: float = 1e-6):
    """Plain PyTorch version of K9: (y in x's dtype, x + residual in the
    residual's dtype), the sum and the variance in fp32."""
    xs = x.float() + residual.float()
    var = xs.square().mean(dim=-1, keepdim=True)
    y = (xs * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)
    return y, xs.to(residual.dtype)


def ls_add_norm_ref(h, residual, gamma, weight, eps: float = 1e-6):
    """The unfused composition `_ls_add_norm_ref` (:140-143): LayerScale in
    fp32 rounded to h's dtype, the residual add in the promoted dtype, then
    `rms_norm`; (normed, x + LayerScale(h))."""
    ls = (h.float() * gamma.float()).to(h.dtype)
    xs = residual + ls
    return rms_norm(xs, weight, eps=eps), xs


def fused_ls_add_rms_norm_ref(h, residual, gamma, weight, eps: float = 1e-6):
    """Plain PyTorch version of K10: the kernel's cast chain (:129-137), y in
    h's dtype and the new residual in the residual's."""
    y, xs = ls_add_norm_ref(h, residual, gamma, weight, eps)
    return y.to(h.dtype), xs.to(residual.dtype)


def _check_rows(what: str, a, b, params) -> int:
    """Raise unless (a, b) are same-shape CUDA tensors on one device in
    fp32 / bf16 and `params` (name -> (D,) tensor) fp32 / bf16 vectors;
    returns D."""
    if a.shape != b.shape or a.dim() == 0:
        raise ValueError(f"{what}: shapes {tuple(a.shape)} and {tuple(b.shape)} differ")
    d = a.shape[-1]
    for name, t in (("residual", b), *params.items()):
        if t.device != a.device:
            raise ValueError(f"{what}: input on {a.device} but {name} on {t.device}")
    for name, t in (("input", a), ("residual", b), *params.items()):
        if t.dtype not in _DTYPE_CODES:
            raise NotImplementedError(f"{what} kernel takes float32 or bfloat16, {name} is {t.dtype}")
    for name, t in params.items():
        if t.shape != (d,):
            raise ValueError(f"{what}: {name} {tuple(t.shape)}, expected ({d},)")
    return d


def _launch(name: str, tensors, params, eps: float):
    """Launch K9 or K10 on CUDA `tensors` (x or h, residual) with the (D,)
    `params` (weight, or gamma and weight); returns (y, newres) shaped as
    the input."""
    a, b = tensors
    d = a.shape[-1]
    rows = a.numel() // d if d else 0
    a2, b2 = (t.reshape(rows, d).contiguous() for t in (a, b))
    ps = [t.contiguous() for t in params]
    y = torch.empty((rows, d), dtype=a.dtype, device=a.device)
    newres = torch.empty((rows, d), dtype=b.dtype, device=a.device)
    if rows and d:
        lib = _build.load_library()
        codes = [_DTYPE_CODES[t.dtype] for t in (a2, b2, *ps)]
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            rc = getattr(lib, f"ivt_{name}")(
                *codes, a2.data_ptr(), b2.data_ptr(), *(t.data_ptr() for t in ps),
                y.data_ptr(), newres.data_ptr(), rows, d, float(eps), stream)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: cudaError_t {rc}")
        _launches[name] += 1
    return y.reshape(a.shape), newres.reshape(a.shape)


def fused_add_rms_norm(
    x: torch.Tensor,  # (..., D)
    residual: torch.Tensor,  # (..., D)
    weight: torch.Tensor,  # (D,)
    *,
    eps: float = 1e-6,
    block_rows: int = 512,  # the TPU tile: accepted for signature parity, unused
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused (x + residual) -> RMSNorm, returning (normed, x + residual):
    K9 on CUDA tensors (inference-only), the plain version on CPU ones."""
    del block_rows
    if x.is_cuda:
        _check_rows("fused_add_rms_norm", x, residual, {"weight": weight})
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, residual, weight)):
            raise RuntimeError(
                "the fused add + RMSNorm kernel is inference-only (the JAX op has no VJP): "
                "run it under torch.no_grad()")
        return _launch("fused_add_rms_norm", (x, residual), (weight,), eps)
    if x.device.type != "cpu":
        raise NotImplementedError(f"no fused add + RMSNorm for device {x.device}")
    return fused_add_rms_norm_ref(x, residual, weight, eps)


class FusedLSAddRMSNorm(torch.autograd.Function):
    """(h, residual, gamma, weight) -> (y, newres): K10 on CUDA, its plain
    version on the CPU; the backward is autograd through the unfused
    composition, as `_fused_ls_bwd` (:183-189)."""

    @staticmethod
    def forward(ctx, h, residual, gamma, weight, eps: float):
        if h.is_cuda:
            _check_rows("fused_ls_add_rms_norm", h, residual, {"gamma": gamma, "weight": weight})
            y, newres = _launch("fused_ls_add_rms_norm", (h, residual), (gamma, weight), eps)
        elif h.device.type == "cpu":
            y, newres = fused_ls_add_rms_norm_ref(h, residual, gamma, weight, eps)
        else:
            raise NotImplementedError(f"no fused LayerScale + add + RMSNorm for device {h.device}")
        ctx.save_for_backward(h, residual, gamma, weight)
        ctx.eps = eps
        return y, newres

    @staticmethod
    def backward(ctx, gy, gres):
        leaves = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ls_add_norm_ref(*leaves, ctx.eps)
            grads = torch.autograd.grad(
                outs, leaves, [g.to(o.dtype) for g, o in zip((gy, gres), outs)],
                allow_unused=True)
        return (*grads, None)


def fused_ls_add_rms_norm(h, residual, gamma, weight, eps: float = 1e-6):
    """LayerScale(h) + residual -> RMSNorm (the encoder Block's chain);
    returns (normed in h's dtype, the new residual in the residual's)."""
    return FusedLSAddRMSNorm.apply(h, residual, gamma, weight, eps)
