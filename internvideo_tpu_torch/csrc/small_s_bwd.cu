// Small-S attention backward (K4b) for Hopper (sm_90a): the dq kernel and
// the dk/dv kernel of exact softmax attention for 0 < Sq, Sk <= 1024,
// non-causal, one K/V head per query head, d_v == d_qk, operands in the
// (B, S, H*D) projection layout through explicit strides.
//
// Replaces internvideo_tpu/ops/flash_attention.py:1524 `_small_s_dq_kernel`
// and :1553 `_small_s_dkdv_kernel`, launched by `_small_s_bwd_rule`
// :1632-1676. As in the JAX package the backward is two kernels without
// atomics, and delta = rowsum(dO * O) is computed outside them (in torch,
// where JAX leaves it to XLA, :1641-1645). The dq kernel reads the LSE the
// K2 forward wrote (small_s_fwd.cu) instead of recomputing it, as the JAX
// dq kernel does; the gradients are the same.
//
// What does not carry over: the TPU kernels hold a whole (S, H*D) K/V slab
// in VMEM per grid step and accumulate dk/dv across query blocks in the
// output dtype. Here each CTA streams the other side's tiles through a TMA
// ring and accumulates in fp32 registers until one final store.
//
// What bounds it: 6 * B * H * S^2 * d (dq) and 8 * B * H * S^2 * d (dk/dv)
// operations against reading q, k, v, dO once: at (32, 833, 16, 88) the
// tensor cores, ~0.19 and ~0.25 ms at the bf16 peak.
//
// Design: K4a's (flash_bwd.cu): the bf16 kernels are K5's warp-specialised
// wgmma + TMA bodies (flash_bwd_causal_dq.cu, flash_bwd_causal_dkv.cu; the
// design notes are there), instantiated at (D, D) for D = 64, 72, 88, 128
// under this kernel's own __global__ names (small_s_bwd_{dq,dkv}_wgmma_
// kernel) and launched from those files, non-causal, without segments,
// window or groups. The dq kernel holds 128 query rows a CTA and walks
// pipelined (at d 128 it waits for each product: the pipelined walk spilled
// there); the dk/dv kernel holds 128 keys a CTA (in half steps of 32
// rows at d 72 / 88), or at d 128 64 keys with P^T / dS^T through shared
// memory. Head dims 72 and 88 are three 32-column panels (96 columns): the
// TMA maps keep the true width, so the columns past it load as zeros, add
// nothing to the products that reduce over d, and are not stored. S = 833
// is ragged against every tile: rows past Sq / keys past Sk are TMA's zero
// fill, rows past Sq get lse = +inf (p = 0) before every contraction over
// rows (0 * NaN would poison them: the reason of the JAX kernel's masking,
// :1577-1579), and neither is stored. fp32 inputs take the CUDA-core
// kernels of attn_bwd.cuh (one thread per row; the parity route).
//
// Build: compiled alone by ops/_build.py (one nvcc per source, in parallel).

#include "attn_bwd.cuh"

namespace ivt {

// The bf16 launches (flash_bwd_causal_dq.cu / flash_bwd_causal_dkv.cu), with
// this file's C entries' arguments.
cudaError_t small_s_bwd_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dq, int B, int Sq,
                                 int Sk, int H, int D, const long long* strides, float scale,
                                 void* stream);
cudaError_t small_s_bwd_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* delta, void* dk, void* dv, int B,
                                  int Sq, int Sk, int H, int D, const long long* strides,
                                  float scale, void* stream);

}  // namespace ivt

namespace {

using namespace ivt;

IVT_BWD_F32_KERNELS(small_s)

}  // namespace

// C entries bound with ctypes, with the signatures of ivt_flash_bwd_dq and
// ivt_flash_bwd_dkv (flash_bwd.cu): dtype 0 = float32, 1 = bfloat16;
// `strides` holds 18 int64, the (batch, seq, head) element strides of q, k,
// v, dO, dq and dk/dv; lse (natural log) and delta are (B, H, Sq) fp32
// contiguous. Each returns the cudaError_t of its launch
// (cudaErrorInvalidValue for an unsupported head dim or dtype, or a bf16
// tensor cuTensorMapEncodeTiled refuses a TMA map for); launches on
// `stream`; does not synchronise.
#define IVT_SMALL_S_F32_DISPATCH(LAUNCH, KERNEL)  \
  switch (D) {                                    \
    case 64: return LAUNCH(KERNEL<64>, a);        \
    case 72: return LAUNCH(KERNEL<72>, a);        \
    case 88: return LAUNCH(KERNEL<88>, a);        \
    case 128: return LAUNCH(KERNEL<128>, a);      \
    default: return cudaErrorInvalidValue;        \
  }

extern "C" int ivt_small_s_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* delta,
                                  void* dq, int B, int Sq, int Sk, int H, int D,
                                  const long long* strides, float scale, void* stream) {
  if (dtype == 1)
    return small_s_bwd_dq_wgmma(q, k, v, dout, lse, delta, dq, B, Sq, Sk, H, D, strides, scale,
                                stream);
  if (dtype != 0) return cudaErrorInvalidValue;
  const BwdArgs a = make_bwd_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, Sq, Sk,
                                  H, strides, scale, stream);
  IVT_SMALL_S_F32_DISPATCH(launch_bwd_dq_f32, small_s_dq_f32_kernel)
}

extern "C" int ivt_small_s_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* delta,
                                   void* dk, void* dv, int B, int Sq, int Sk, int H, int D,
                                   const long long* strides, float scale, void* stream) {
  if (dtype == 1)
    return small_s_bwd_dkv_wgmma(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, D, strides,
                                 scale, stream);
  if (dtype != 0) return cudaErrorInvalidValue;
  const BwdArgs a = make_bwd_args(q, k, v, dout, lse, delta, nullptr, dk, dv, B, Sq, Sk, H,
                                  strides, scale, stream);
  IVT_SMALL_S_F32_DISPATCH(launch_bwd_dkv_f32, small_s_dkv_f32_kernel)
}
#undef IVT_SMALL_S_F32_DISPATCH
