// Fused residual add + RMSNorm (K9) and fused LayerScale + residual add +
// RMSNorm (K10) for Hopper (sm_90a), forward only.
//
//   K9  ivt_fused_add_rms_norm     replaces internvideo_tpu/ops/rmsnorm.py:52
//       `_fused_kernel` (launched by `fused_add_rms_norm` :60 -> :84):
//         xs     = f32(x) + f32(residual)
//         y      = to_x(xs * rsqrt(mean(xs^2) + eps) * f32(w))   one rounding
//         newres = to_residual(xs)
//   K10 ivt_fused_ls_add_rms_norm  replaces :127 `_fused_ls_kernel` (launched
//       by `_fused_ls_add_rms_norm` :147 -> :156), the encoder Block's cast
//       chain; xs carries the promoted type of h and residual (fp32 if either
//       is, else bf16):
//         ls     = to_h(f32(h) * f32(gamma))
//         xs     = to_xs(f32(residual) + f32(ls))
//         normed = to_xs(f32(xs) * rsqrt(mean(f32(xs)^2) + eps))
//         y      = to_h(f32(w) * f32(normed))
//         newres = to_residual(xs)
//
// Every row is independent, so the TPU's (block_rows, D) VMEM tiles become
// one CTA per row: the CTA loads the row once into registers (16-byte
// vectors when D % 8 == 0 and every pointer is 16-byte aligned, else a
// scalar path with a masked tail), sums the squares in fp32 (warp shuffles,
// then one shared-memory pass over the warps' partials), and writes both
// outputs from the registers. x, residual and h take fp32 or bf16 each
// independently; the (D,) weight and gamma take fp32 or bf16 (a runtime
// flag: a warp-uniform branch on a vector that stays in L1).
//
// What bounds it: bytes. There are no tensor-core operations; a row is read
// once and written once. At the 1B encoder's residual stream (16 * 4097
// rows x 1408) K9 with bf16 x and an fp32 residual moves 1.11 GB (0.33 ms at
// 3.35 TB/s), K10 in bf16 0.74 GB (0.22 ms). A CTA of up to 1024 threads
// keeps 1, 2 or 4 8-element chunks a thread in registers (a template
// parameter, so a row of D <= 8192 costs 8 floats a thread), so D <= 32768.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC, linked with the other sources into one shared
//        library (internvideo_tpu_torch/ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kVec = 8;         // elements of one chunk: 16 bytes of bf16
constexpr int kMaxChunks = 4;   // chunks a thread keeps in registers
constexpr int kMaxThreads = 1024;

template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ static void load(const float* p, float* v, int n, bool vec) {
    if (vec) {
      const float4 a = *reinterpret_cast<const float4*>(p);
      const float4 b = *reinterpret_cast<const float4*>(p + 4);
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
      v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[i] = i < n ? p[i] : 0.f;
    }
  }
  __device__ static void store(float* p, const float* v, int n, bool vec) {
    if (vec) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        if (i < n) p[i] = v[i];
    }
  }
  __device__ static float round(float x) { return x; }
};

template <>
struct Io<bf16> {
  __device__ static void load(const bf16* p, float* v, int n, bool vec) {
    if (vec) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h2[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[i] = i < n ? __bfloat162float(p[i]) : 0.f;
    }
  }
  __device__ static void store(bf16* p, const float* v, int n, bool vec) {
    if (vec) {
      uint4 raw;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      *reinterpret_cast<uint4*>(p) = raw;
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        if (i < n) p[i] = __float2bfloat16(v[i]);
    }
  }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16(x)); }
};

// The (D,) weight or gamma, fp32 or bf16, as fp32 (columns past D read 0).
__device__ __forceinline__ void load_vec_param(const void* w, bool w_bf16, int c0, int n,
                                               float* v) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    v[i] = i >= n ? 0.f
           : w_bf16 ? __bfloat162float(static_cast<const bf16*>(w)[c0 + i])
                    : static_cast<const float*>(w)[c0 + i];
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The sum of `x` over the CTA, returned to every thread (blockDim.x a
// multiple of 32, at most 1024).
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float partial[32];
  x = warp_sum(x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = x;
  __syncthreads();
  x = lane < static_cast<int>(blockDim.x >> 5) ? partial[lane] : 0.f;
  return warp_sum(x);
}

template <typename TX, typename TR, int N>
__global__ void __launch_bounds__(kMaxThreads)
    fused_add_rms_norm_kernel(const TX* __restrict__ x, const TR* __restrict__ res,
                              const void* __restrict__ w, bool w_bf16, TX* __restrict__ y,
                              TR* __restrict__ newres, int D, float eps, bool vec) {
  const long long off = (long long)blockIdx.x * D;
  float xs[N][kVec];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c0 = (threadIdx.x + i * blockDim.x) * kVec;
    if (c0 < D) {
      const int n = min(kVec, D - c0);
      float a[kVec], b[kVec];
      Io<TX>::load(x + off + c0, a, n, vec);
      Io<TR>::load(res + off + c0, b, n, vec);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        xs[i][j] = a[j] + b[j];
        ss = fmaf(xs[i][j], xs[i][j], ss);
      }
    }
  }
  const float rstd = rsqrtf(block_sum(ss) / D + eps);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c0 = (threadIdx.x + i * blockDim.x) * kVec;
    if (c0 < D) {
      const int n = min(kVec, D - c0);
      float wv[kVec], out[kVec];
      load_vec_param(w, w_bf16, c0, n, wv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) out[j] = xs[i][j] * rstd * wv[j];
      Io<TX>::store(y + off + c0, out, n, vec);
      Io<TR>::store(newres + off + c0, xs[i], n, vec);
    }
  }
}

template <typename TH, typename TR, int N>
__global__ void __launch_bounds__(kMaxThreads)
    fused_ls_add_rms_norm_kernel(const TH* __restrict__ h, const TR* __restrict__ res,
                                 const void* __restrict__ g, bool g_bf16,
                                 const void* __restrict__ w, bool w_bf16, TH* __restrict__ y,
                                 TR* __restrict__ newres, int D, float eps, bool vec) {
  // xs is held in the promoted type of h and the residual
  using TS = std::conditional_t<std::is_same_v<TH, float> || std::is_same_v<TR, float>, float,
                                bf16>;
  const long long off = (long long)blockIdx.x * D;
  float xs[N][kVec];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c0 = (threadIdx.x + i * blockDim.x) * kVec;
    if (c0 < D) {
      const int n = min(kVec, D - c0);
      float a[kVec], b[kVec], gv[kVec];
      Io<TH>::load(h + off + c0, a, n, vec);
      Io<TR>::load(res + off + c0, b, n, vec);
      load_vec_param(g, g_bf16, c0, n, gv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        // __fmul_rn: the product rounds on its own (never contracted into an
        // FMA with the add), as the chain rounds LayerScale to h's dtype first
        const float ls = Io<TH>::round(__fmul_rn(a[j], gv[j]));
        xs[i][j] = Io<TS>::round(b[j] + ls);
        ss = fmaf(xs[i][j], xs[i][j], ss);
      }
    }
  }
  const float rstd = rsqrtf(block_sum(ss) / D + eps);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c0 = (threadIdx.x + i * blockDim.x) * kVec;
    if (c0 < D) {
      const int n = min(kVec, D - c0);
      float wv[kVec], out[kVec];
      load_vec_param(w, w_bf16, c0, n, wv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) out[j] = wv[j] * Io<TS>::round(__fmul_rn(xs[i][j], rstd));
      Io<TH>::store(y + off + c0, out, n, vec);
      Io<TR>::store(newres + off + c0, xs[i], n, vec);
    }
  }
}

// A row's CTA: `threads` (a whole number of warps, one 8-element chunk each
// where D allows) and `per`, the chunks a thread keeps in registers
// (1, 2 or 4); false when D is past 4 chunks a thread of 1024.
bool shape_for(int D, int* threads, int* per) {
  const int chunks = (D + kVec - 1) / kVec;
  *threads = std::min(kMaxThreads, (chunks + 31) / 32 * 32);
  const int need = (chunks + *threads - 1) / *threads;
  *per = need <= 1 ? 1 : need <= 2 ? 2 : 4;
  return D > 0 && need <= kMaxChunks;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Calls launch(TA{}, TB{}, std::integral_constant<int, N>{}) with the
// element types of two dtype codes and N = per.
template <typename Launch>
cudaError_t dispatch(int code_a, int code_b, int per, Launch&& launch) {
  auto with_types = [&](auto ta, auto tb) {
    if (per == 1) return launch(ta, tb, std::integral_constant<int, 1>{});
    if (per == 2) return launch(ta, tb, std::integral_constant<int, 2>{});
    return launch(ta, tb, std::integral_constant<int, 4>{});
  };
  if (code_a == 0 && code_b == 0) return with_types(float{}, float{});
  if (code_a == 0 && code_b == 1) return with_types(float{}, bf16{});
  if (code_a == 1 && code_b == 0) return with_types(bf16{}, float{});
  if (code_a == 1 && code_b == 1) return with_types(bf16{}, bf16{});
  return cudaErrorInvalidValue;
}

}  // namespace

// C entries bound with ctypes. dtype codes: 0 = float32, 1 = bfloat16. x /
// h, residual and both outputs are contiguous (rows, D); y has x's (h's)
// dtype, newres the residual's. w / gamma are contiguous (D,). Each returns
// the cudaError_t of its launch (cudaErrorInvalidValue for a dtype code or
// a D it does not take); launches on `stream`; does not synchronise.
extern "C" int ivt_fused_add_rms_norm(int x_dtype, int res_dtype, int w_dtype, const void* x,
                                      const void* res, const void* w, void* y, void* newres,
                                      long long rows, int D, float eps, void* stream) {
  int threads, per;
  if (!shape_for(D, &threads, &per) || rows <= 0 || rows > 0x7fffffffLL ||
      (w_dtype != 0 && w_dtype != 1))
    return cudaErrorInvalidValue;
  const bool vec = D % kVec == 0 && aligned16(x) && aligned16(res) && aligned16(y) &&
                   aligned16(newres);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(x_dtype, res_dtype, per, [&](auto tx, auto tr, auto n) {
    using TX = decltype(tx);
    using TR = decltype(tr);
    fused_add_rms_norm_kernel<TX, TR, decltype(n)::value><<<(unsigned)rows, threads, 0, st>>>(
        static_cast<const TX*>(x), static_cast<const TR*>(res), w, w_dtype == 1,
        static_cast<TX*>(y), static_cast<TR*>(newres), D, eps, vec);
    return cudaGetLastError();
  });
}

extern "C" int ivt_fused_ls_add_rms_norm(int h_dtype, int res_dtype, int g_dtype, int w_dtype,
                                         const void* h, const void* res, const void* g,
                                         const void* w, void* y, void* newres, long long rows,
                                         int D, float eps, void* stream) {
  int threads, per;
  if (!shape_for(D, &threads, &per) || rows <= 0 || rows > 0x7fffffffLL ||
      (g_dtype != 0 && g_dtype != 1) || (w_dtype != 0 && w_dtype != 1))
    return cudaErrorInvalidValue;
  const bool vec = D % kVec == 0 && aligned16(h) && aligned16(res) && aligned16(y) &&
                   aligned16(newres);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(h_dtype, res_dtype, per, [&](auto th, auto tr, auto n) {
    using TH = decltype(th);
    using TR = decltype(tr);
    fused_ls_add_rms_norm_kernel<TH, TR, decltype(n)::value><<<(unsigned)rows, threads, 0, st>>>(
        static_cast<const TH*>(h), static_cast<const TR*>(res), g, g_dtype == 1, w,
        w_dtype == 1, static_cast<TH*>(y), static_cast<TR*>(newres), D, eps, vec);
    return cudaGetLastError();
  });
}
