// Small-S attention backward (K4b) for Hopper (sm_90a): the dq kernel and
// the dk/dv kernel of exact softmax attention for 0 < Sq, Sk <= 1024,
// non-causal, one K/V head per query head, d_v == d_qk, operands in the
// (B, S, H*D) projection layout through explicit strides.
//
// Replaces internvideo_tpu/ops/flash_attention.py:1524 `_small_s_dq_kernel`
// and :1553 `_small_s_dkdv_kernel`, launched by `_small_s_bwd_rule`
// :1632-1676. As in the JAX package the backward is two kernels without
// atomics, and delta = rowsum(dO * O) is computed outside them (in torch,
// where JAX leaves it to XLA, :1641-1645).
//
// What does not carry over: the TPU kernels hold a whole (S, H*D) K/V slab
// in VMEM per grid step and accumulate dk/dv across query blocks in the
// output dtype. Here the dq kernel (one CTA per 64-query tile, head, batch)
// streams 64-key tiles of K and V, and the dk/dv kernel (one CTA per 64-key
// tile) streams 64-row tiles of q and dO, each double-buffered in shared
// memory, with fp32 accumulation over every row until the one final store.
// Both run the bodies of attn_bwd.cuh (also K4a's). The dq kernel reads the
// LSE the K2 forward wrote (small_s_fwd.cu) instead of recomputing it, as
// the JAX dq kernel does; the gradients are the same.
//
// S = 833 is ragged against every tile size. Rows >= Sq in the dk/dv kernel
// load as zeros in q and dO and get lse = +inf, so p = 0 there, before every
// contraction over rows: 0 * NaN through a contraction is NaN (the reason
// of the JAX kernel's masking, :1577-1579); keys >= Sk get p = 0 in the dq
// kernel.
//
// What bounds it: 6 * B * H * S^2 * d (dq) and 8 * B * H * S^2 * d (dk/dv)
// operations against reading q, k, v, dO once: at (32, 833, 16, 88) the
// tensor cores, ~0.19 and ~0.25 ms at the bf16 peak.
//
// Head dims: 64, 72 (the InternVideo3 vision tower; padded to 80 in shared
// memory for the products that reduce over d), 88, 128.
//
// Build: compiled alone by ops/_build.py (one nvcc per source, in parallel).

#include "attn_bwd.cuh"

namespace {

using namespace ivt;

IVT_BWD_KERNELS(small_s)

}  // namespace

// C entries bound with ctypes, with the signatures of ivt_flash_bwd_dq and
// ivt_flash_bwd_dkv (flash_bwd.cu): dtype 0 = float32, 1 = bfloat16;
// `strides` holds 18 int64, the (batch, seq, head) element strides of q, k,
// v, dO, dq and dk/dv; lse (natural log) and delta are (B, H, Sq) fp32
// contiguous. Each returns the cudaError_t of its launch
// (cudaErrorInvalidValue for an unsupported head dim or dtype); launches on
// `stream`; does not synchronise.
#define IVT_SMALL_S_BWD_DISPATCH(LAUNCH, KIND)                                              \
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;                               \
  switch (D) {                                                                              \
    case 64:                                                                                \
      return LAUNCH<64>(small_s_##KIND##_bf16_kernel<64>, small_s_##KIND##_f32_kernel<64>,  \
                        dtype, a);                                                          \
    case 72:                                                                                \
      return LAUNCH<72>(small_s_##KIND##_bf16_kernel<72>, small_s_##KIND##_f32_kernel<72>,  \
                        dtype, a);                                                          \
    case 88:                                                                                \
      return LAUNCH<88>(small_s_##KIND##_bf16_kernel<88>, small_s_##KIND##_f32_kernel<88>,  \
                        dtype, a);                                                          \
    case 128:                                                                               \
      return LAUNCH<128>(small_s_##KIND##_bf16_kernel<128>,                                 \
                         small_s_##KIND##_f32_kernel<128>, dtype, a);                       \
    default:                                                                                \
      return cudaErrorInvalidValue;                                                         \
  }

extern "C" int ivt_small_s_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* delta,
                                  void* dq, int B, int Sq, int Sk, int H, int D,
                                  const long long* strides, float scale, void* stream) {
  const BwdArgs a = make_bwd_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, Sq, Sk,
                                  H, strides, scale, stream);
  IVT_SMALL_S_BWD_DISPATCH(launch_bwd_dq, dq)
}

extern "C" int ivt_small_s_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* delta,
                                   void* dk, void* dv, int B, int Sq, int Sk, int H, int D,
                                   const long long* strides, float scale, void* stream) {
  const BwdArgs a = make_bwd_args(q, k, v, dout, lse, delta, nullptr, dk, dv, B, Sq, Sk, H,
                                  strides, scale, stream);
  IVT_SMALL_S_BWD_DISPATCH(launch_bwd_dkv, dkv)
}
#undef IVT_SMALL_S_BWD_DISPATCH
