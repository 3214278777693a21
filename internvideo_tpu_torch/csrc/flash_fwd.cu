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
// What bounds it: per 128-query tile the kernel reads all of K and V once,
// and does 4 * 128 * d FLOPs per key for 2 * 2 * d bytes of K/V, about 128
// FLOPs per byte from L2; K/V of one head (4097 x 88 x 2 x 2 B = 1.4 MB)
// stays in the 50 MB L2 across the 33 query tiles that share it. So it is bound by the
// tensor cores and by the softmax's exp2 work between the two products, not
// by device memory.
//
// Design: the bf16 kernel is K5's warp-specialised wgmma + TMA forward body
// (flash_fwd_causal.cu; its design notes are there), instantiated at (D, D)
// for D = 64 and 88 under this kernel's own __global__ name
// (flash_fwd_wgmma_kernel) and launched from that file, non-causal, without
// segments, window or groups: one CTA of a TMA producer warp and two
// consumer warpgroups of 64 query rows per (128-query tile, head, batch);
// K and V rings of 64-key stages; S = Q K^T as wgmma from shared memory, the
// online softmax in base 2 on the accumulator fragments, O += P V with P in
// registers; the two warpgroups take turns to issue (ping-pong). Head dim
// 88 is stored as three 32-column panels (96 columns, 64-byte swizzle); the
// TMA maps keep the true width, so columns 88-95 load as zeros and add
// nothing to S, P V accumulates 96 columns (one m64n96 wgmma a k-step) and
// the stores write 88. fp32 inputs take the CUDA-core FMA body of
// attn_fwd.cuh (one thread per query row; the parity route, not the bf16
// main path).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC, linked with the other sources into one shared
//        library (internvideo_tpu_torch/ops/_build.py).

#include "attn_fwd.cuh"

namespace ivt {

// The bf16 launch (flash_fwd_causal.cu), with the C entries' arguments;
// small_s selects K2's kernel instead of this one's.
cudaError_t flash_fwd_wgmma(bool small_s, const void* q, const void* k, const void* v, void* o,
                            float* lse, int B, int Sq, int Sk, int H, int D,
                            const long long* strides, float scale, void* stream);

}  // namespace ivt

namespace {

using namespace ivt;

template <int D>
__global__ void __launch_bounds__(kFwdF32Rows)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int Sq, int Sk, int H, FwdStrides st,
                         float scale_log2) {
  attn_fwd_f32<D, false>(q, k, v, o, lse, Sq, Sk, H, st, scale_log2, QkNorm{});
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int Sq, int Sk, int H, const FwdStrides& st, float scale_log2,
                       cudaStream_t stream) {
  return launch_fwd(flash_fwd_f32_kernel<D>, B, Sq, H, stream,
                    static_cast<const float*>(q), static_cast<const float*>(k),
                    static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk, H, st,
                    scale_log2);
}

}  // namespace

// C entry bound with ctypes. dtype: 0 = float32, 1 = bfloat16. `strides`
// holds 12 int64: (batch, seq, head) element strides of q, k, v, o (bf16:
// multiples of 8, and 16-byte aligned bases, as TMA needs). Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for an unsupported head
// dim or dtype, or a bf16 tensor cuTensorMapEncodeTiled refuses a TMA map
// for). Launches on `stream`; does not synchronise.
extern "C" int ivt_flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                             float* lse, int B, int Sq, int Sk, int H, int D,
                             const long long* strides, float scale, void* stream) {
  if (dtype == 1)
    return flash_fwd_wgmma(false, q, k, v, o, lse, B, Sq, Sk, H, D, strides, scale, stream);
  if (dtype != 0) return cudaErrorInvalidValue;
  const FwdStrides st{strides[0], strides[1], strides[2],  strides[3],
                      strides[4], strides[5], strides[6],  strides[7],
                      strides[8], strides[9], strides[10], strides[11]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_f32<64>(q, k, v, o, lse, B, Sq, Sk, H, st, scale * kLog2e, s);
  if (D == 88) return launch_f32<88>(q, k, v, o, lse, B, Sq, Sk, H, st, scale * kLog2e, s);
  return cudaErrorInvalidValue;
}
