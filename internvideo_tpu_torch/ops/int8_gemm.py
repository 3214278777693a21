"""Dynamic-int8 GEMM (K7): the Hopper CUDA kernel and its plain version.

Counterpart of internvideo_tpu/ops/int8_gemm.py:106 `int8_matmul_fused`
(the Pallas `_kernel` :68): per-row absmax quantization of the activations
over the full K, an int8 x int8 -> int32 product and the f32 rescale by
x_scale * w_scale. A CUDA tensor runs the kernel (`csrc/int8_gemm.cu`) or
raises; a CPU tensor runs the plain version, `ops/quant.py:int8_matmul`'s
`auto` composition (quant.py:64-70), which the kernel matches bit for bit
in its codes and int32 sums. The kernel is two launches, counted as one
call: a row quantizer that writes the codes and scales to a scratch the
wrapper allocates, then the int8 GEMM (the TPU kernel quantizes in VMEM
instead; csrc/int8_gemm.cu says why Hopper takes the HBM pass).

The weights are torch's (N, K) int8 (K contiguous) with (N,) f32 scales,
where JAX keeps (K, N) and (1, N). The JAX module's block policy
(`pick_blocks`, `fused_eligible`, `_MAX_K`, K % 128) is TPU VMEM and lane
bookkeeping and is not ported; the kernel's own limits are K % 4 == 0 and
K <= 133,143 (int32 headroom).

The kernel is inference-only: on a CUDA tensor it raises when autograd
would need a gradient through it (the TPU kernel's custom VJP returns a
straight-through dx and a zero scale cotangent, which differs from the
`auto` route's gradient). The plain version differentiates as the `auto`
route does.
"""

from __future__ import annotations

import torch

from internvideo_tpu_torch.ops import _build
from internvideo_tpu_torch.ops.quant import quantize_int8

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_K = 133_143  # csrc/int8_gemm.cu: K * 127^2 must fit int32
_launches = {"int8_gemm": 0}


def launch_count(kernel: str = "int8_gemm") -> int:
    """How many times K7 has been launched on the card in this process."""
    return _launches[kernel]


def reset_launch_count() -> None:
    _launches["int8_gemm"] = 0


def int8_matmul_reference(x, w_q, w_scale, out_dtype=torch.float32):
    """Plain PyTorch version: quantize_int8 over the last dim, the exact
    integer product (in float64, exact while |acc| < 2^53; torch has no
    int32 matmul on the card and an int8 one wraps), its rounding to f32,
    then `* x_scale * w_scale` in f32. x (..., K), w_q (N, K) int8,
    w_scale (N,) -> (..., N) in `out_dtype`."""
    x_q, x_scale = quantize_int8(x, -1)
    acc = torch.matmul(x_q.double(), w_q.double().t())
    return (acc.float() * x_scale * w_scale.reshape(-1).float()).to(out_dtype)


def _int8_gemm_cuda(x, w_q, w_scale, out_dtype):
    n, k = w_q.shape
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise NotImplementedError(
            f"int8 GEMM kernel takes float32 or bfloat16 x and out, got {x.dtype} -> {out_dtype}")
    if w_q.dtype != torch.int8 or x.shape[-1] != k or w_scale.numel() != n:
        raise ValueError(f"x {tuple(x.shape)}, w_q {tuple(w_q.shape)} {w_q.dtype}, w_scale "
                         f"{tuple(w_scale.shape)} do not form one int8 GEMM")
    if k % 4 or k > _MAX_K:
        raise NotImplementedError(
            f"int8 GEMM kernel takes K a multiple of 4 and <= {_MAX_K}, got K = {k}")
    if torch.is_grad_enabled() and (x.requires_grad or w_scale.requires_grad):
        raise RuntimeError(
            "the int8 GEMM kernel is inference-only: run it under torch.no_grad() (a "
            "gradient needs the plain route on the CPU)")
    for name, t in (("w_q", w_q), ("w_scale", w_scale)):
        if t.device != x.device:
            raise ValueError(f"int8 GEMM: x on {x.device} but {name} on {t.device}")
    lead = x.shape[:-1]
    m = x.numel() // k if k else 0
    x2 = x.reshape(m, k).contiguous()
    w = w_q.contiguous()
    if k % 16:  # the kernel reads weight rows in 16-byte chunks: pad the pitch (off the path)
        w = torch.nn.functional.pad(w, (0, -k % 16))
    ws = w_scale.reshape(n).to(torch.float32).contiguous()
    x2, w, ws = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x2, w, ws))
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out.reshape(*lead, n)
    kp = -(-k // 128) * 128  # the codes' row pitch: whole 128-byte k-tiles, zero filled
    x_codes = torch.empty((m, kp), dtype=torch.int8, device=x.device)
    x_scales = torch.empty((m,), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ivt_int8_gemm(_DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype], x2.data_ptr(),
                               w.data_ptr(), w.shape[1], ws.data_ptr(), x_codes.data_ptr(),
                               x_scales.data_ptr(), kp, out.data_ptr(), m, n, k, stream)
    if rc != 0:
        raise RuntimeError(f"int8_gemm kernel launch failed: cudaError_t {rc}")
    _launches["int8_gemm"] += 1
    return out.reshape(*lead, n)


def int8_matmul_fused(
    x: torch.Tensor,  # (..., K) float32 / bfloat16 activations
    w_q: torch.Tensor,  # (N, K) int8 weights
    w_scale: torch.Tensor,  # (N,) float32 per-out-channel scales
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """-> (..., N) in `out_dtype`: K7 on CUDA tensors, the plain version on
    CPU tensors."""
    if x.is_cuda:
        return _int8_gemm_cuda(x, w_q, w_scale, out_dtype)
    if x.device.type != "cpu":
        raise NotImplementedError(f"no int8 GEMM for device {x.device}")
    return int8_matmul_reference(x, w_q, w_scale, out_dtype)
