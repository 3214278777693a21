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
// tiles of 64 keys computes the same function.
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
// Design: the bf16 kernel is K5's warp-specialised wgmma + TMA forward body
// (flash_fwd_causal.cu; its design notes are there), as K1's is
// (flash_fwd.cu), instantiated at (D, D) under this kernel's own __global__
// name (small_s_fwd_wgmma_kernel) and launched from that file, non-causal,
// without segments, window or groups: 128 query rows a CTA (two consumer
// warpgroups), a TMA producer warp filling K and V rings of 64-key stages.
// Head dims 64, 72 (the InternVideo3 vision tower), 88 and 128; 72 and 88
// are stored as three 32-column panels (96 columns, 64-byte swizzle), the
// TMA maps at the true width zero-filling the rest, the stores writing the
// true width. fp32 inputs take the CUDA-core FMA body of attn_fwd.cuh (the
// parity route). The earlier bf16 design, attn_fwd.cuh's mma.sync body,
// stays behind K3 and K11.
//
// Build: compiled alone by ops/_build.py (one nvcc per source, in parallel).

#include "attn_fwd.cuh"

namespace ivt {

// The bf16 launch (flash_fwd_causal.cu), with the C entries' arguments;
// small_s selects this kernel (K2) instead of K1's.
cudaError_t flash_fwd_wgmma(bool small_s, const void* q, const void* k, const void* v, void* o,
                            float* lse, int B, int Sq, int Sk, int H, int D,
                            const long long* strides, float scale, void* stream);

}  // namespace ivt

namespace {

using namespace ivt;

template <int D>
__global__ void __launch_bounds__(kFwdF32Rows)
    small_s_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int Sq, int Sk, int H, FwdStrides st,
                           float scale_log2) {
  attn_fwd_f32<D, false>(q, k, v, o, lse, Sq, Sk, H, st, scale_log2, QkNorm{});
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int Sq, int Sk, int H, const FwdStrides& st, float scale_log2,
                       cudaStream_t stream) {
  return launch_fwd(small_s_fwd_f32_kernel<D>, false, 0, B, Sq, H, stream,
                    static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk, H, st,
                    scale_log2);
}

}  // namespace

// C entry bound with ctypes. dtype: 0 = float32, 1 = bfloat16. `strides`
// holds 12 int64: (batch, seq, head) element strides of q, k, v, o (bf16:
// multiples of 8, and 16-byte aligned bases, as TMA needs). `lse` receives
// the natural-log LSE, (B, H, Sq) fp32 contiguous. Returns the cudaError_t
// of the launch (cudaErrorInvalidValue for an unsupported head dim or
// dtype, or a bf16 tensor cuTensorMapEncodeTiled refuses a TMA map for).
// Launches on `stream`; does not synchronise.
extern "C" int ivt_small_s_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                               float* lse, int B, int Sq, int Sk, int H, int D,
                               const long long* strides, float scale, void* stream) {
  if (dtype == 1)
    return flash_fwd_wgmma(true, q, k, v, o, lse, B, Sq, Sk, H, D, strides, scale, stream);
  if (dtype != 0) return cudaErrorInvalidValue;
  const FwdStrides st{strides[0], strides[1], strides[2],  strides[3],
                      strides[4], strides[5], strides[6],  strides[7],
                      strides[8], strides[9], strides[10], strides[11]};
  const float sl2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_f32<64>(q, k, v, o, lse, B, Sq, Sk, H, st, sl2, s);
    case 72:
      return launch_f32<72>(q, k, v, o, lse, B, Sq, Sk, H, st, sl2, s);
    case 88:
      return launch_f32<88>(q, k, v, o, lse, B, Sq, Sk, H, st, sl2, s);
    case 128:
      return launch_f32<128>(q, k, v, o, lse, B, Sq, Sk, H, st, sl2, s);
    default:
      return cudaErrorInvalidValue;
  }
}
