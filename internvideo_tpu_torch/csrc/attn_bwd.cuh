// The fp32 attention backward (CUDA-core FMAs, one thread per row: the
// parity route, not the bf16 main path) and the argument block of the
// 18-stride C entries of flash_bwd.cu (K4a) and small_s_bwd.cu (K4b), whose
// bf16 kernels run the wgmma + TMA bodies of flash_bwd_causal_{dq,dkv}.cu.
// Each file defines its own fp32 __global__ kernels over these bodies
// (IVT_BWD_F32_KERNELS), so every TPU kernel keeps its own symbol, entry
// point and launch count.
#pragma once

#include "mma.cuh"

namespace ivt {

struct BwdStrides {  // element strides of (batch, sequence, head); last dim is unit
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, do_b, do_s, do_h, dq_b, dq_s, dq_h,
      dkv_b, dkv_s, dkv_h;
};

// natural-log LSE -> base 2; a row that saw no key (-inf) gets +inf, so p = 0
__device__ __forceinline__ float lse_base2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * kLog2e;
}

// fp32: one thread per row, the streamed rows in shared memory, CUDA-core
// FMAs. Numerics as the bf16 kernels (base-2 p from the base-2 LSE).
constexpr int kBwdF32Rows = 64;
constexpr int kBwdF32Cols = 32;

template <int D>
__device__ __forceinline__ void attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, int Sq, int Sk, int H, BwdStrides st,
                            float scale, float scale_log2) {
  __shared__ float sK[kBwdF32Cols][D];
  __shared__ float sV[kBwdF32Cols][D];
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kBwdF32Rows + tid;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* kb = k + b * st.k_b + h * st.k_h;
  const float* vb = v + b * st.v_b + h * st.v_h;
  const bool valid = row < Sq;
  const int r = valid ? row : 0;

  float qr[D], dor[D], acc[D];
  const float* qp = q + b * st.q_b + (long long)r * st.q_s + h * st.q_h;
  const float* dop = dout + b * st.do_b + (long long)r * st.do_s + h * st.do_h;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = valid ? qp[c] : 0.f;
    dor[c] = valid ? dop[c] : 0.f;
    acc[c] = 0.f;
  }
  const long long li = ((long long)b * H + h) * Sq + r;
  const float lse2 = valid ? lse_base2(lse[li]) : INFINITY;
  const float dlt = valid ? delta[li] : 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kBwdF32Cols) {
    __syncthreads();
    for (int i = tid; i < kBwdF32Cols * D; i += kBwdF32Rows) {
      const int j = i / D, c = i - j * D;
      const bool ok = k0 + j < Sk;
      sK[j][c] = ok ? kb[(long long)(k0 + j) * st.k_s + c] : 0.f;
      sV[j][c] = ok ? vb[(long long)(k0 + j) * st.v_s + c] : 0.f;
    }
    __syncthreads();
    const int n = min(kBwdF32Cols, Sk - k0);
    for (int j = 0; j < n; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        s = fmaf(qr[c], sK[j][c], s);
        dp = fmaf(dor[c], sV[j][c], dp);
      }
      const float ds = exp2f(s * scale_log2 - lse2) * (dp - dlt);
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(ds, sK[j][c], acc[c]);
    }
  }
  if (!valid) return;
  float* out = dq + b * st.dq_b + (long long)row * st.dq_s + h * st.dq_h;
#pragma unroll
  for (int c = 0; c < D; ++c) out[c] = acc[c] * scale;
}

template <int D>
__device__ __forceinline__ void attn_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
                             BwdStrides st, float scale, float scale_log2) {
  __shared__ float sQ[kBwdF32Cols][D];
  __shared__ float sDO[kBwdF32Cols][D];
  __shared__ float sL[kBwdF32Cols], sD[kBwdF32Cols];
  const int tid = threadIdx.x;
  const int key = blockIdx.x * kBwdF32Rows + tid;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * st.q_b + h * st.q_h;
  const float* dob = dout + b * st.do_b + h * st.do_h;
  const long long lrow = ((long long)b * H + h) * Sq;
  const bool valid = key < Sk;
  const int r = valid ? key : 0;

  float kr[D], vr[D], ak[D], av[D];
  const float* kp = k + b * st.k_b + (long long)r * st.k_s + h * st.k_h;
  const float* vp = v + b * st.v_b + (long long)r * st.v_s + h * st.v_h;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    kr[c] = valid ? kp[c] : 0.f;
    vr[c] = valid ? vp[c] : 0.f;
    ak[c] = av[c] = 0.f;
  }

  for (int q0 = 0; q0 < Sq; q0 += kBwdF32Cols) {
    __syncthreads();
    for (int i = tid; i < kBwdF32Cols * D; i += kBwdF32Rows) {
      const int j = i / D, c = i - j * D;
      const bool ok = q0 + j < Sq;
      sQ[j][c] = ok ? qb[(long long)(q0 + j) * st.q_s + c] : 0.f;
      sDO[j][c] = ok ? dob[(long long)(q0 + j) * st.do_s + c] : 0.f;
    }
    if (tid < kBwdF32Cols) {
      const bool ok = q0 + tid < Sq;
      sL[tid] = ok ? lse_base2(lse[lrow + q0 + tid]) : INFINITY;
      sD[tid] = ok ? delta[lrow + q0 + tid] : 0.f;
    }
    __syncthreads();
    const int n = min(kBwdF32Cols, Sq - q0);
    for (int j = 0; j < n; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        s = fmaf(kr[c], sQ[j][c], s);
        dp = fmaf(vr[c], sDO[j][c], dp);
      }
      const float p = exp2f(s * scale_log2 - sL[j]);
      const float ds = p * (dp - sD[j]);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        av[c] = fmaf(p, sDO[j][c], av[c]);
        ak[c] = fmaf(ds, sQ[j][c], ak[c]);
      }
    }
  }
  if (!valid) return;
  const long long off = b * st.dkv_b + (long long)key * st.dkv_s + h * st.dkv_h;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    dk[off + c] = ak[c] * scale;
    dv[off + c] = av[c];
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, Sq, Sk, H;
  BwdStrides st;
  float scale, scale_log2;
  cudaStream_t stream;
};

inline BwdArgs make_bwd_args(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dq, void* dk, void* dv,
                             int B, int Sq, int Sk, int H, const long long* s, float scale,
                             void* stream) {
  return BwdArgs{q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H,
                 BwdStrides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10],
                            s[11], s[12], s[13], s[14], s[15], s[16], s[17]},
                 scale, scale * kLog2e, static_cast<cudaStream_t>(stream)};
}

// Launch an fp32 dq kernel (static shared memory) on grid
// (ceil(Sq / kBwdF32Rows), H, B).
template <typename KF32>
cudaError_t launch_bwd_dq_f32(KF32 kf32, const BwdArgs& a) {
  const dim3 g32((a.Sq + kBwdF32Rows - 1) / kBwdF32Rows, a.H, a.B);
  kf32<<<g32, kBwdF32Rows, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dq), a.Sq, a.Sk, a.H, a.st, a.scale, a.scale_log2);
  return cudaGetLastError();
}

// The same for an fp32 dk/dv kernel, on grid (ceil(Sk / kBwdF32Rows), H, B).
template <typename KF32>
cudaError_t launch_bwd_dkv_f32(KF32 kf32, const BwdArgs& a) {
  const dim3 g32((a.Sk + kBwdF32Rows - 1) / kBwdF32Rows, a.H, a.B);
  kf32<<<g32, kBwdF32Rows, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq, a.Sk, a.H, a.st, a.scale,
      a.scale_log2);
  return cudaGetLastError();
}

// Declares the fp32 __global__ kernels of one backward (PREFIX##_dq_f32_kernel,
// PREFIX##_dkv_f32_kernel), each a thin wrapper of the bodies above, so that
// every TPU kernel ported onto them keeps kernels of its own name.
#define IVT_BWD_F32_KERNELS(PREFIX)                                                             \
  template <int D>                                                                            \
  __global__ void __launch_bounds__(kBwdF32Rows) PREFIX##_dq_f32_kernel(                      \
      const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, \
      const float* __restrict__ dout, const float* __restrict__ lse,                         \
      const float* __restrict__ delta, float* __restrict__ dq, int Sq, int Sk, int H,         \
      BwdStrides st, float scale, float scale_log2) {                                        \
    attn_bwd_dq_f32<D>(q, k, v, dout, lse, delta, dq, Sq, Sk, H, st, scale, scale_log2);     \
  }                                                                                          \
  template <int D>                                                                            \
  __global__ void __launch_bounds__(kBwdF32Rows) PREFIX##_dkv_f32_kernel(                     \
      const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, \
      const float* __restrict__ dout, const float* __restrict__ lse,                         \
      const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,       \
      int Sq, int Sk, int H, BwdStrides st, float scale, float scale_log2) {                 \
    attn_bwd_dkv_f32<D>(q, k, v, dout, lse, delta, dk, dv, Sq, Sk, H, st, scale, scale_log2); \
  }

}  // namespace ivt
