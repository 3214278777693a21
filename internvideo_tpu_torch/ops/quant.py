"""Low-precision matmuls: int8 quantization and the int8 serving layers.

Port of internvideo_tpu/ops/quant.py. `quantize_int8` is the absmax
quantizer (fp32 absmax, scale max(amax, 1e-8) / 127, a true division,
round half to even, clip +-127). `int8_matmul` with dynamic activations is
K7 (`ops/int8_gemm.py`: the kernel on a CUDA tensor, the plain `auto`
composition on a CPU tensor); its weight-only branch is a plain GEMM.

Layers, with torch's (out, in) weights:

  * `QuantDense`: the QAT layer, a master weight fake-quantized per call
    with straight-through weights (and activations in dynamic mode); plain
    torch, no kernel.
  * `Int8Dense`: serving, `weight_q` (N, K) int8 and `scale` (N,) fp32,
    activations quantized per row (K7), the product stored in `dtype`, then
    `+ bias` in fp32 and `.to(dtype)` (quant.py:168-182).
  * `Int8WoDense`: weight-only serving, x @ w_q in `dtype` with an fp32
    result, `* scale`, `+ bias`, `.to(dtype)` (quant.py:274-293); with
    `dyn_m_threshold` (the "int8_mix" mode) a call with at least that many
    flattened rows takes K7 off the same params instead.

`quantize_params_like(int8_model, dense_state_dict)` maps a dense model's
state_dict onto an int8 model's. The int8 tensors are Parameters with
`requires_grad=False`: the serving layers take no gradient.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from internvideo_tpu_torch.nn.dense import Dense, lecun_normal_std, trunc_normal_

# "int8_mix" serving mode: rows at/above this take the dynamic-int8 GEMM
# (prefill dispatches are >= 2048 tokens; decode batches are << this)
INT8_MIX_DYN_M = 1024


def quantize_int8(x: torch.Tensor, dim: int):
    """absmax int8 quantization along `dim`; returns (q int8, scale fp32),
    the scale keeping `dim` as a size-1 axis."""
    xf = x.float()
    amax = torch.clamp(xf.abs().amax(dim=dim, keepdim=True), min=1e-8)
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, one ulp off amax / 127 on some rows
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _linear_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (N, K)^T in their shared dtype with an fp32 result
    (JAX's `preferred_element_type=float32`): a bf16 product is not rounded
    to bf16 before what follows. On the card a bf16 / fp16 product runs as
    one GEMM with an fp32 output; elsewhere, and where autograd needs it,
    on fp32 copies (bf16 inputs are exact in fp32)."""
    if x.dtype == torch.float32:
        return F.linear(x, w.float())
    needs_grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16) and not needs_grad:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[0])
    return F.linear(x.float(), w.float())


def int8_matmul(
    x: torch.Tensor,  # (..., K) activations
    w_q: torch.Tensor,  # (N, K) int8 weights
    w_scale: torch.Tensor,  # (N,) fp32 per-out-channel scales
    *,
    dynamic_activations: bool = True,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    if dynamic_activations:
        from internvideo_tpu_torch.ops import int8_gemm

        return int8_gemm.int8_matmul_fused(x, w_q, w_scale, out_dtype)
    # weight-only: dequantized weights in x's dtype, fp32 accumulation
    w = (w_q.float() * w_scale.reshape(-1, 1).float()).to(x.dtype)
    return _linear_f32(x, w).to(out_dtype)


class QuantDense(nn.Module):
    """QAT linear (quant.py:76-122): the master `weight` (out, in) in
    `param_dtype`, quantized per output channel each call; the forward uses
    the dequantized weights (and, with dynamic activations, the per-row
    dequantized activations), the gradient reaches the master copy
    straight through."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = True,
                 dynamic_activations: bool = True, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype, self.dynamic_activations = dtype, dynamic_activations
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, dtype=param_dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=param_dtype, device=device))
                     if bias else None)

    def init_weights(self, generator: torch.Generator) -> None:
        """flax `lecun_normal()` weight, zero bias."""
        trunc_normal_(self.weight, lecun_normal_std(self.weight.shape[1]), generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        w_q, w_scale = quantize_int8(w, 1)
        w_deq = w_q.float() * w_scale
        w_ste = w + (w_deq.to(w.dtype) - w).detach()
        if self.dynamic_activations:
            x_q, x_scale = quantize_int8(x, -1)
            x_deq = (x_q.float() * x_scale).to(x.dtype)
            x = x + (x_deq - x).detach()
        y = _linear_f32(x.to(self.dtype), w_ste.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)

    def inference_weights(self):
        """Export path: (int8 (out, in) weights, (out, 1) fp32 scales)."""
        return quantize_int8(self.weight, 1)


class _Int8Linear(nn.Module):
    """`weight_q` (out, in) int8 and `scale` (out,) fp32, as JAX's zeros /
    ones init (the real values come from `quantize_params_like`), and an
    optional bias in `param_dtype`."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight_q = nn.Parameter(
            torch.zeros(out_features, in_features, dtype=torch.int8, device=device),
            requires_grad=False)
        self.scale = nn.Parameter(torch.ones(out_features, dtype=torch.float32, device=device),
                                  requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=param_dtype, device=device))
                     if bias else None)

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> None:
        """Back to JAX's init (zero codes, unit scales, zero bias); draws
        nothing from `generator`."""
        self.weight_q.zero_()
        self.scale.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()

    def _finish(self, y: torch.Tensor) -> torch.Tensor:
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)


class Int8Dense(_Int8Linear):
    """Serving int8 linear (quant.py:125-182): activations quantized per row
    and the int8 x int8 product (K7) stored in `dtype`, then `+ bias`."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = True, **kw):
        super().__init__(in_features, out_features, bias=bias, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._finish(int8_matmul(x, self.weight_q, self.scale, dynamic_activations=True,
                                        out_dtype=self.dtype))


class Int8WoDense(_Int8Linear):
    """Weight-only serving int8 linear (quant.py:220-293). With
    `dyn_m_threshold`, a call of at least that many flattened rows (prefill)
    takes the dynamic-int8 GEMM (K7) off the same params; below it (decode)
    the math is the weight-only product, the same code as without a
    threshold."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = False,
                 dyn_m_threshold: Optional[int] = None, **kw):
        super().__init__(in_features, out_features, bias=bias, **kw)
        self.dyn_m_threshold = dyn_m_threshold

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = x.numel() // x.shape[-1] if x.dim() > 1 else 1
        if self.dyn_m_threshold is not None and m >= self.dyn_m_threshold:
            y = int8_matmul(x, self.weight_q, self.scale, dynamic_activations=True,
                            out_dtype=self.dtype)
        else:
            y = _linear_f32(x.to(self.dtype), self.weight_q.to(self.dtype)) * self.scale
        return self._finish(y)


def serving_dense(quant: Optional[str], in_features: int, out_features: int, **kw) -> nn.Module:
    """The linear layer of a model built with `quant`: a Dense (None), an
    Int8Dense ("int8"), an Int8WoDense ("int8_wo") or one that takes K7 at
    >= INT8_MIX_DYN_M flattened rows ("int8_mix")."""
    if quant is None:
        return Dense(in_features, out_features, **kw)
    if quant == "int8":
        return Int8Dense(in_features, out_features, **kw)
    if quant in ("int8_wo", "int8_mix"):
        return Int8WoDense(in_features, out_features, **kw, dyn_m_threshold=(
            INT8_MIX_DYN_M if quant == "int8_mix" else None))
    raise ValueError(f"unknown quant {quant!r}; None, 'int8', 'int8_wo' or 'int8_mix'")


def quantize_params_like(int8_model: nn.Module,
                         dense_state_dict: Mapping[str, torch.Tensor]) -> dict:
    """A dense model's state_dict -> the int8 model's (quant.py:185-212).

    For each `weight_q` / `scale` pair the int8 model holds, the dense
    `weight` at the same path is quantized per output channel; every other
    tensor is copied, cast to the int8 model's dtype, onto its device. Load
    the result with `int8_model.load_state_dict(..., strict=True)`."""
    target = int8_model.state_dict()
    out = {}
    for key, ref in target.items():
        prefix, _, leaf = key.rpartition(".")
        pre = f"{prefix}." if prefix else ""
        if leaf == "weight_q":
            q, s = quantize_int8(dense_state_dict[pre + "weight"], 1)
            out[key] = q.to(ref.device)
            out[pre + "scale"] = s.reshape(-1).to(ref.device)
        elif not (leaf == "scale" and pre + "weight_q" in target):
            out[key] = dense_state_dict[key].to(device=ref.device, dtype=ref.dtype)
    return out
