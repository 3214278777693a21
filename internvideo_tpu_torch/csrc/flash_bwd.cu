// Flash-attention backward for Hopper (sm_90a): non-causal, no segment ids,
// one K/V head per query head, d_v == d_qk, inputs in (B, S, H, D).
//
// Replaces internvideo_tpu/ops/flash_attention.py:468 `_bwd_dq_kernel` and
// :613 `_bwd_dkv_kernel` (driven by `_bwd` :782, and at the encoder's ragged
// S = 2049 / 4097 by `_ragged_bwd_rule` :1374) for the encoder's case. As in
// the JAX package the backward is two kernels without atomics:
//
//   dq kernel,  one CTA per (query tile, head, batch), loops over K/V:
//     s = q k^T * scale, p = exp(s - lse), dp = dO v^T,
//     ds = p * (dp - delta), dq += ds k; writes scale * dq.
//   dkv kernel, one CTA per (key tile, head, batch), loops over Q/dO:
//     dv += p^T dO, dk += ds^T q; writes scale * dk and dv.
//
// p is recomputed from the forward's natural-log LSE (turned into base 2
// here, so p = exp2(s * scale * log2(e) - lse * log2(e))). delta =
// rowsum(dO * O) in fp32, minus any LSE cotangent, is computed by the
// wrapper. Casts follow the JAX kernels: ds is rounded to k's dtype before
// the ds k and ds^T q products, p to dO's dtype before p^T dO; every product
// accumulates in fp32; outputs are in the inputs' dtype.
//
// Ragged S runs as one launch: keys >= Sk get p = 0 in the dq kernel; in the
// dkv kernel query rows >= Sq load as zeros (q, dO) and get lse = +inf, so
// p = 0 there and the contractions over query rows see no garbage (0 * NaN
// would poison them). The TPU path's aligned-region + XLA-tails
// decomposition is not carried over.
//
// What bounds it: 5 products of 2 * S^2 * d FLOPs per (batch, head) across
// the two kernels (10 B H S^2 d in all, 2.5x the forward) against reading
// q, k, v, dO once (+ L2 re-reads per tile), so the tensor cores and the
// exp2 work between products bound it, not device memory.
//
// Design: the bf16 kernels are K5's warp-specialised wgmma + TMA bodies
// (flash_bwd_causal_dq.cu, flash_bwd_causal_dkv.cu; their design notes are
// there), instantiated at (D, D) for D = 64, 88 and 128 under this kernel's own
// __global__ names (flash_bwd_{dq,dkv}_wgmma_kernel) and launched from those
// files, non-causal, without segments, window or groups. Head dim 88 is
// stored as three 32-column panels (96 columns, 64-byte swizzle); the TMA
// maps keep the true width, so the columns past 88 load as zeros and add
// nothing to the products that reduce over d, and the stores write 88. The
// dq kernel holds 128 query rows a CTA and dq of all columns in registers,
// and walks pipelined (the next key tile's S / dP issued before this one's
// dQ; at d 128, the InternViT-6B tower's, it waits for each product, as K4b
// does there). The dk/dv kernel holds 128 keys a CTA and dk and dv in
// registers; at d 88 it walks each 64-row step in two halves of 32 rows, so
// S^T / dP^T fit beside the two accumulators; at d 128 it holds 64 keys a
// CTA, each warpgroup half of dk's and dv's columns, with P^T / dS^T
// through shared memory (K4b's d-128 form). fp32 inputs take the
// CUDA-core kernels of attn_bwd.cuh (one thread per row; the parity route,
// not the bf16 main path).

#include "attn_bwd.cuh"

namespace ivt {

// The bf16 launches (flash_bwd_causal_dq.cu / flash_bwd_causal_dkv.cu), with
// this file's C entries' arguments.
cudaError_t flash_bwd_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, void* dq, int B, int Sq,
                               int Sk, int H, int D, const long long* strides, float scale,
                               void* stream);
cudaError_t flash_bwd_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, void* dk, void* dv, int B,
                                int Sq, int Sk, int H, int D, const long long* strides,
                                float scale, void* stream);

}  // namespace ivt

namespace {

using namespace ivt;

IVT_BWD_F32_KERNELS(flash_bwd)

}  // namespace

// C entries bound with ctypes. dtype: 0 = float32, 1 = bfloat16. `strides`
// holds 18 int64: (batch, seq, head) element strides of q, k, v, dO, dq and
// dk/dv (dk and dv share a layout). lse and delta are (B, H, Sq) fp32,
// contiguous; lse is natural-log, delta = rowsum(dO * O) - dLSE. Each
// returns the cudaError_t of its launch (cudaErrorInvalidValue for an
// unsupported head dim or dtype, or a bf16 tensor cuTensorMapEncodeTiled
// refuses a TMA map for); launches on `stream`; does not synchronise.
extern "C" int ivt_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                const void* dout, const float* lse, const float* delta, void* dq,
                                int B, int Sq, int Sk, int H, int D, const long long* strides,
                                float scale, void* stream) {
  if (dtype == 1)
    return flash_bwd_dq_wgmma(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, D, strides, scale,
                              stream);
  if (dtype != 0) return cudaErrorInvalidValue;
  const BwdArgs a = make_bwd_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, Sq, Sk, H,
                                  strides, scale, stream);
  if (D == 64) return launch_bwd_dq_f32(flash_bwd_dq_f32_kernel<64>, a);
  if (D == 88) return launch_bwd_dq_f32(flash_bwd_dq_f32_kernel<88>, a);
  if (D == 128) return launch_bwd_dq_f32(flash_bwd_dq_f32_kernel<128>, a);
  return cudaErrorInvalidValue;
}

extern "C" int ivt_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* delta,
                                 void* dk, void* dv, int B, int Sq, int Sk, int H, int D,
                                 const long long* strides, float scale, void* stream) {
  if (dtype == 1)
    return flash_bwd_dkv_wgmma(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, D, strides,
                               scale, stream);
  if (dtype != 0) return cudaErrorInvalidValue;
  const BwdArgs a = make_bwd_args(q, k, v, dout, lse, delta, nullptr, dk, dv, B, Sq, Sk, H,
                                  strides, scale, stream);
  if (D == 64) return launch_bwd_dkv_f32(flash_bwd_dkv_f32_kernel<64>, a);
  if (D == 88) return launch_bwd_dkv_f32(flash_bwd_dkv_f32_kernel<88>, a);
  if (D == 128) return launch_bwd_dkv_f32(flash_bwd_dkv_f32_kernel<128>, a);
  return cudaErrorInvalidValue;
}
