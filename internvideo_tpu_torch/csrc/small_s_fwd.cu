// Small-S attention forward (K2) for Hopper (sm_90a): exact softmax
// attention for 0 < Sq, Sk <= 1024, non-causal, one K/V head per query head,
// d_v == d_qk, q/k/v read in the (B, S, H*D) projection layout through
// explicit strides (views into one (B, S, 3W) qkv tensor, no copy).
//
// Replaces internvideo_tpu/ops/flash_attention.py:1505 `_small_s_fwd_kernel`
// (launched by `_small_s_attention` :1606, reached from `flash_attention`
// :2080-2094 and, inside the backward of the fused qkv op K3, from
// `_fused_qkv_unfused_ref` :1759).
//
// What does not carry over: the TPU kernel holds the whole K and V of a
// batch row in VMEM and runs one exact softmax pass per head. On Hopper one
// head's K and V at S = 833, d 88 padded to 96, bf16 are ~320 KB, over the
// 227 KB of shared memory a block can have. An online softmax over K/V
// tiles of 64 keys computes the same function, so this kernel runs the
// attention body of attn_fwd.cuh (also K1's): one CTA per (64-query tile,
// head, batch), K/V double-buffered with cp.async, mma.sync.m16n8k16.
//
// Design choice for the backward: unlike the TPU kernel, this one also
// writes the natural-log LSE, (B, H, Sq) fp32, which the K4b dq and dk/dv
// kernels read (small_s_bwd.cu). The JAX dq kernel recomputes it instead;
// both give the same gradients, and this way the dq kernel does no extra
// Q K^T pass.
//
// What bounds it: 4 * B * H * S^2 * d operations against reading q, k, v
// once and writing out once; at the student's (32, 833, 16, 88) that is
// ~0.13 ms of tensor-core work against ~0.09 ms of traffic, so it is bound by
// the tensor cores and the exp2 work between the two products.
//
// Head dims: 64, 72 (the InternVideo3 vision tower, zero-padded to 80 in
// shared memory for the QK^T k-steps, as 88 is to 96), 88, 128.
//
// Build: compiled alone by ops/_build.py (one nvcc per source, in parallel).

#include "attn_fwd.cuh"

namespace {

using namespace ivt;

template <int D>
__global__ void __launch_bounds__(kFwdThreads)
    small_s_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int Sq, int Sk, int H, FwdStrides st,
                            float scale_log2) {
  attn_fwd_bf16<D, false>(q, k, v, o, lse, Sq, Sk, H, st, scale_log2, QkNorm{});
}

template <int D>
__global__ void __launch_bounds__(kFwdF32Rows)
    small_s_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int Sq, int Sk, int H, FwdStrides st,
                           float scale_log2) {
  attn_fwd_f32<D, false>(q, k, v, o, lse, Sq, Sk, H, st, scale_log2, QkNorm{});
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int Sq, int Sk, int H, const FwdStrides& st, float scale_log2,
                   cudaStream_t stream) {
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    return launch_fwd(small_s_fwd_bf16_kernel<D>, true, FwdTile<D>::kSmemBytes, B, Sq, H, stream,
                      static_cast<const bf*>(q), static_cast<const bf*>(k),
                      static_cast<const bf*>(v), static_cast<bf*>(o), lse, Sq, Sk, H, st,
                      scale_log2);
  }
  return launch_fwd(small_s_fwd_f32_kernel<D>, false, 0, B, Sq, H, stream,
                    static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk, H, st,
                    scale_log2);
}

}  // namespace

// C entry bound with ctypes. dtype: 0 = float32, 1 = bfloat16. `strides`
// holds 12 int64: (batch, seq, head) element strides of q, k, v, o. `lse`
// receives the natural-log LSE, (B, H, Sq) fp32 contiguous. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for an unsupported head
// dim or dtype). Launches on `stream`; does not synchronise.
extern "C" int ivt_small_s_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                               float* lse, int B, int Sq, int Sk, int H, int D,
                               const long long* strides, float scale, void* stream) {
  const FwdStrides st{strides[0], strides[1], strides[2],  strides[3],
                      strides[4], strides[5], strides[6],  strides[7],
                      strides[8], strides[9], strides[10], strides[11]};
  const float scale_log2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<64>(dtype, q, k, v, o, lse, B, Sq, Sk, H, st, scale_log2, s);
    case 72:
      return launch<72>(dtype, q, k, v, o, lse, B, Sq, Sk, H, st, scale_log2, s);
    case 88:
      return launch<88>(dtype, q, k, v, o, lse, B, Sq, Sk, H, st, scale_log2, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, lse, B, Sq, Sk, H, st, scale_log2, s);
    default:
      return cudaErrorInvalidValue;
  }
}
