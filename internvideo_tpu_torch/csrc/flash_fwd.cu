// Flash-attention forward for Hopper (sm_90a): non-causal, no segment ids,
// one K/V head per query head, d_v == d_qk, inputs in (B, S, H, D).
//
// Replaces internvideo_tpu/ops/flash_attention.py:153 `_fwd_kernel` (launched
// by `_fwd` :322 and reached from `flash_attention` :2037 and
// `flash_attention_with_lse` :1188) for the encoder's case. The TPU kernel's
// ragged-tail decomposition, ones-column denominator and (8, 128) tiling are
// not carried over: the last K/V tile masks keys >= Sk to -inf and query rows
// >= Sq are never stored, so S = 4097 runs as one kernel.
//
// What bounds it: per 64-query tile the kernel reads all of K and V once, and
// does 4 * 64 * d FLOPs per key for 2 * 2 * d bytes of K/V, about 64 FLOPs
// per byte from L2; K/V of one head (4097 x 88 x 2 x 2 B = 1.4 MB) stays in
// the 50 MB L2 across the 65 query tiles that share it. So it is bound by the
// tensor cores and by the softmax's exp2 work between the two products, not
// by device memory.
//
// Design (right and simple first), in attn_fwd.cuh, which K2 and K3 share:
// one CTA per (64-query tile, head, batch); 4 warps of 16 query rows; K/V
// tiles of 64 keys double-buffered in shared memory with cp.async; QK^T and
// PV on mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with P kept in
// registers between the two; online softmax in the base-2 domain. Head dim
// 88 is zero-padded to 96 in shared memory for the QK^T k-steps; PV runs
// 88 / 8 = 11 n-tiles with no pad. fp32 inputs take a CUDA-core FMA kernel
// (used by the parity checks, not by the bf16 main path). wgmma, TMA and
// warp specialisation are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC, linked with the other sources into one shared
//        library (internvideo_tpu_torch/ops/_build.py).

#include "attn_fwd.cuh"

namespace {

using namespace ivt;

template <int D>
__global__ void __launch_bounds__(kFwdThreads)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int Sq, int Sk, int H, FwdStrides st,
                          float scale_log2) {
  attn_fwd_bf16<D, false>(q, k, v, o, lse, Sq, Sk, H, st, scale_log2, QkNorm{});
}

template <int D>
__global__ void __launch_bounds__(kFwdF32Rows)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
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
    return launch_fwd(flash_fwd_bf16_kernel<D>, true, FwdTile<D>::kSmemBytes, B, Sq, H, stream,
                      static_cast<const bf*>(q), static_cast<const bf*>(k),
                      static_cast<const bf*>(v), static_cast<bf*>(o), lse, Sq, Sk, H, st,
                      scale_log2);
  }
  return launch_fwd(flash_fwd_f32_kernel<D>, false, 0, B, Sq, H, stream,
                    static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk, H, st,
                    scale_log2);
}

}  // namespace

// C entry bound with ctypes. dtype: 0 = float32, 1 = bfloat16. `strides`
// holds 12 int64: (batch, seq, head) element strides of q, k, v, o. Returns
// the cudaError_t of the launch (cudaErrorInvalidValue for an unsupported
// head dim or dtype). Launches on `stream`; does not synchronise.
extern "C" int ivt_flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                             float* lse, int B, int Sq, int Sk, int H, int D,
                             const long long* strides, float scale, void* stream) {
  const FwdStrides st{strides[0], strides[1], strides[2],  strides[3],
                      strides[4], strides[5], strides[6],  strides[7],
                      strides[8], strides[9], strides[10], strides[11]};
  const float scale_log2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IVT_CASE(DIM)                                                              \
  case DIM:                                                                        \
    return launch<DIM>(dtype, q, k, v, o, lse, B, Sq, Sk, H, st, scale_log2, s);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (D) {
    IVT_CASE(64)
    IVT_CASE(88)
    default:
      return cudaErrorInvalidValue;
  }
#undef IVT_CASE
}
