// Shared parts of the causal / narrow-v / segmented / grouped-query /
// windowed flash-attention backward (K5 backward + K8) for Hopper (sm_90a):
// its argument block, the warp-specialised CTA's shape, the base-2 LSE and
// the visibility tests. The dq kernel is in flash_bwd_causal_dq.cu, the
// dk/dv kernel in flash_bwd_causal_dkv.cu; each keeps its own __global__
// names, C entry and launch count. The design is described in
// flash_bwd_causal_dq.cu.
#pragma once

#include "hopper.cuh"
#include "segments.cuh"

namespace ivt {

struct CausalBwdArgs {
  const void *q, *k, *v, *dout;  // q, k (B, S, H, Dqk); v (B, Sk, H, Dv); dO (B, Sq, H, Dv)
  const float *lse, *delta;      // (B, H, Sq) fp32: natural-log LSE, rowsum(dO O) - dLSE
  const int *q_seg, *kv_seg;     // (B, Sq) / (B, Sk) int32, or null
  void *dq, *dk, *dv;            // outputs in the layouts of q, k, v
  int Sq, Sk, H;
  // element strides of (batch, sequence, head) of q, k, v, dO, dq, dk, dv
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, do_b, do_s, do_h, dq_b, dq_s, dq_h,
      dk_b, dk_s, dk_h, dv_b, dv_s, dv_h;
  float scale, scale_log2;
  int causal, q_off;  // query row i sees key j iff j <= i + q_off (with causal)
  int group;          // q heads per K/V head: q head h reads K/V head h / group
  int window;         // > 0: |i + q_off - j| < window (j <= i + q_off with causal); 0: none
};

// The bf16 kernels' CTA: a producer warpgroup (one warp walks the tiles and
// issues the TMA loads, the other three leave at once) and two consumer
// warpgroups; setmaxnreg moves registers to the consumers: 128 x 40 +
// 256 x 232 <= 384 x 168 (the walk's look-ahead spilled at 24).
constexpr int kBwdThreads = 384;
constexpr int kBwdProducerRegs = 40;
constexpr int kBwdConsumerRegs = 232;

inline CausalBwdArgs make_causal_bwd_args(const void* q, const void* k, const void* v,
                                          const void* dout, const float* lse, const float* delta,
                                          const int* q_seg, const int* kv_seg, void* dq, void* dk,
                                          void* dv, int Sq, int Sk, int H, const long long* s,
                                          float scale, int causal, int q_off, int group,
                                          int window) {
  return CausalBwdArgs{q,     k,     v,     dout,  lse,   delta, q_seg, kv_seg, dq,    dk,
                       dv,    Sq,    Sk,    H,     s[0],  s[1],  s[2],  s[3],   s[4],  s[5],
                       s[6],  s[7],  s[8],  s[9],  s[10], s[11], s[12], s[13],  s[14], s[15],
                       s[16], s[17], s[18], s[19], s[20], scale, scale * kLog2e, causal, q_off,
                       group, window > 0 ? window : 0};
}

// Does query position p (= row + q_off) see key j, causality and the
// window alone (segments and the Sk tail are the callers')?
__device__ __forceinline__ bool band_sees(const CausalBwdArgs& a, int p, int j) {
  if (a.causal && j > p) return false;
  return a.window == 0 || (p - j < a.window && (a.causal || j - p < a.window));
}

// Keys [lo, hi) that some query row of [m0, row_end) can see, causality and
// the window alone: the key tiles a dq CTA walks.
__device__ __forceinline__ int2 band_keys(const CausalBwdArgs& a, int m0, int row_end) {
  const int lo = a.window > 0 ? max(0, m0 + a.q_off - a.window + 1) : 0;
  int hi = a.causal ? min(a.Sk, row_end + a.q_off) : a.Sk;
  if (a.window > 0 && !a.causal) hi = min(hi, row_end - 1 + a.q_off + a.window);
  return make_int2(lo, max(hi, lo));
}

// Query rows [lo, hi) that can see some key of [n0, key_end): the query
// tiles a dk/dv CTA walks (the transpose of band_keys).
__device__ __forceinline__ int2 band_rows(const CausalBwdArgs& a, int n0, int key_end) {
  int lo = a.causal ? n0 - a.q_off : a.window > 0 ? n0 - a.q_off - a.window + 1 : 0;
  int hi = a.window > 0 ? key_end - 1 - a.q_off + a.window : a.Sq;
  lo = min(a.Sq, max(0, lo));
  return make_int2(lo, max(lo, min(a.Sq, hi)));
}

// natural-log LSE -> base 2; a row that saw no key (-inf) gets +inf, so p = 0
__device__ __forceinline__ float lse_to_base2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * kLog2e;
}

}  // namespace ivt
