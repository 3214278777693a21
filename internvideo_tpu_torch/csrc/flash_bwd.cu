// Flash-attention backward for Hopper (sm_90a): non-causal, no segment ids,
// one K/V head per query head, d_v == d_qk, inputs in (B, S, H, D).
//
// Replaces internvideo_tpu/ops/flash_attention.py:468 `_bwd_dq_kernel` and
// :613 `_bwd_dkv_kernel` (driven by `_bwd` :782, and at the encoder's ragged
// S = 2049 / 4097 by `_ragged_bwd_rule` :1374) for the encoder's case. As in
// the JAX package the backward is two kernels without atomics:
//
//   dq kernel,  one CTA per (64-query tile, head, batch), loops over K/V:
//     s = q k^T * scale, p = exp(s - lse), dp = dO v^T,
//     ds = p * (dp - delta), dq += ds k; writes scale * dq.
//   dkv kernel, one CTA per (64-key tile, head, batch), loops over Q/dO:
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
// Design (right and simple first, as the forward; the bodies are in
// attn_bwd.cuh, which K4b shares): 4 warps of 16 rows on
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate); the streamed tiles are
// double-buffered in shared memory with cp.async; the accumulator fragments
// of p / ds become A operands in registers; the transposed B operands come
// from ldmatrix.trans. Head dim 88 is zero-padded to 96 in shared memory for
// the products that reduce over d (q k^T, dO v^T); the products with d as
// their n dimension (ds k, p^T dO, ds^T q) run 88 / 8 = 11 n-tiles, no pad.
// fp32 inputs take CUDA-core kernels (one thread per row; used by the
// parity checks, not by the bf16 main path). wgmma, TMA and warp
// specialisation are later work.

#include "attn_bwd.cuh"

namespace {

using namespace ivt;

IVT_BWD_KERNELS(flash_bwd)

}  // namespace

// C entries bound with ctypes. dtype: 0 = float32, 1 = bfloat16. `strides`
// holds 18 int64: (batch, seq, head) element strides of q, k, v, dO, dq and
// dk/dv (dk and dv share a layout). lse and delta are (B, H, Sq) fp32,
// contiguous; lse is natural-log, delta = rowsum(dO * O) - dLSE. Each
// returns the cudaError_t of its launch (cudaErrorInvalidValue for an
// unsupported head dim or dtype); launches on `stream`; does not synchronise.
#define IVT_BWD_DISPATCH(LAUNCH, KIND)                       \
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue; \
  switch (D) {                                           \
    case 64:                                             \
      return LAUNCH<64>(flash_bwd_##KIND##_bf16_kernel<64>, flash_bwd_##KIND##_f32_kernel<64>, dtype, a); \
    case 88:                                             \
      return LAUNCH<88>(flash_bwd_##KIND##_bf16_kernel<88>, flash_bwd_##KIND##_f32_kernel<88>, dtype, a); \
    default:                                             \
      return cudaErrorInvalidValue;                      \
  }

extern "C" int ivt_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                const void* dout, const float* lse, const float* delta, void* dq,
                                int B, int Sq, int Sk, int H, int D, const long long* strides,
                                float scale, void* stream) {
  const BwdArgs a = make_bwd_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, Sq, Sk, H,
                              strides, scale, stream);
  IVT_BWD_DISPATCH(launch_bwd_dq, dq)
}

extern "C" int ivt_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* delta,
                                 void* dk, void* dv, int B, int Sq, int Sk, int H, int D,
                                 const long long* strides, float scale, void* stream) {
  const BwdArgs a = make_bwd_args(q, k, v, dout, lse, delta, nullptr, dk, dv, B, Sq, Sk, H, strides,
                              scale, stream);
  IVT_BWD_DISPATCH(launch_bwd_dkv, dkv)
}
#undef IVT_BWD_DISPATCH
