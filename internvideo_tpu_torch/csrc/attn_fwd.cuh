// The fp32 device body of the attention forward kernels (sm_90a): K1's,
// K2's, K3's and K11's fp32 route (flash_fwd.cu, small_s_fwd.cu,
// fused_qkv.cu, fused_qkv_large.cu), the parity checks. Their bf16 kernels
// run K5's wgmma + TMA body (flash_fwd_causal.cu). Each of those files
// defines its own __global__ kernels, which call this body, so every TPU
// kernel keeps its own symbol, entry point and launch count.
//
// With kNorm = true the body applies K3's / K11's whole-dim QK-RMSNorm
// (mma.cuh QkNorm) to q and each k tile as it loads them, from per-row 1/rms
// factors a pre-pass wrote (fused_qkv.cu): x -> w * (x * rstd) in fp32, the
// cast chain of internvideo_tpu/ops/flash_attention.py:1706-1710 at fp32
// (no rounding between the two products).
#pragma once

#include "mma.cuh"

namespace ivt {

struct FwdStrides {  // element strides of (batch, sequence, head); last dim is unit
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

// fp32: one thread per query row, K/V tiles of 32 keys in shared memory,
// CUDA-core FMAs, the online softmax in the base-2 domain (scale * log2(e)
// folded into the score scale). Keys >= Sk are masked to -inf, query rows
// >= Sq are never stored. With kNorm, q and k are normed on load, x -> w *
// (x * rstd), from QkNorm's 1/rms factors and weights (K3's and K11's fp32
// route).
constexpr int kFwdF32Rows = 64;
constexpr int kFwdF32Keys = 32;

template <int D, bool kNorm>
__device__ __forceinline__ void attn_fwd_f32(const float* __restrict__ q,
                                             const float* __restrict__ k,
                                             const float* __restrict__ v, float* __restrict__ o,
                                             float* __restrict__ lse, int Sq, int Sk, int H,
                                             const FwdStrides& st, float scale_log2,
                                             const QkNorm& nrm) {
  __shared__ float sK[kFwdF32Keys][D];
  __shared__ float sV[kFwdF32Keys][D];
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kFwdF32Rows + tid;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* kb = k + b * st.k_b + h * st.k_h;
  const float* vb = v + b * st.v_b + h * st.v_h;
  const bool valid = row < Sq;

  float qr[D], acc[D];
  const float* qp = q + b * st.q_b + (long long)(valid ? row : 0) * st.q_s + h * st.q_h;
  float rq = 1.f;
  if constexpr (kNorm) rq = valid ? nrm.q_rstd[(long long)b * Sq + row] : 0.f;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    float x = valid ? qp[c] : 0.f;
    if constexpr (kNorm) x = nrm.q_w[h * D + c] * (x * rq);
    qr[c] = x;
    acc[c] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kFwdF32Keys) {
    __syncthreads();
    for (int i = tid; i < kFwdF32Keys * D; i += kFwdF32Rows) {
      const int r = i / D, c = i - r * D;
      const bool ok = k0 + r < Sk;
      float x = ok ? kb[(long long)(k0 + r) * st.k_s + c] : 0.f;
      if constexpr (kNorm) {
        if (ok) x = nrm.k_w[h * D + c] * (x * nrm.k_rstd[(long long)b * Sk + k0 + r]);
      }
      sK[r][c] = x;
      sV[r][c] = ok ? vb[(long long)(k0 + r) * st.v_s + c] : 0.f;
    }
    __syncthreads();
    float s[kFwdF32Keys];
    float mx = m_run;
#pragma unroll
    for (int j = 0; j < kFwdF32Keys; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) dot = fmaf(qr[c], sK[j][c], dot);
      s[j] = k0 + j < Sk ? dot * scale_log2 : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float m_use = mx == -INFINITY ? 0.f : mx;
    const float alpha = exp2f(m_run - m_use);
    m_run = mx;
    l_run *= alpha;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kFwdF32Keys; ++j) {
      const float p = exp2f(s[j] - m_use);
      l_run += p;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(p, sV[j][c], acc[c]);
    }
  }
  if (!valid) return;
  const float inv = l_run > 0.f ? 1.f / l_run : 0.f;
  float* op = o + b * st.o_b + (long long)row * st.o_s + h * st.o_h;
#pragma unroll
  for (int c = 0; c < D; ++c) op[c] = acc[c] * inv;
  if (lse != nullptr) {
    lse[((long long)b * H + h) * Sq + row] =
        l_run > 0.f ? (m_run + log2f(l_run)) * kLn2 : -INFINITY;
  }
}

// Launch fp32 `kern` on grid (ceil(Sq / 64), H, B), 64 threads a CTA and
// only static shared memory.
template <typename Kern, typename... Args>
cudaError_t launch_fwd(Kern kern, int B, int Sq, int H, cudaStream_t stream, Args... args) {
  const dim3 grid((Sq + kFwdF32Rows - 1) / kFwdF32Rows, H, B);
  kern<<<grid, kFwdF32Rows, 0, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace ivt
