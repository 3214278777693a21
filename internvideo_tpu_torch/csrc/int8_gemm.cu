// Dynamic-int8 GEMM for Hopper (sm_90a): per-row absmax quantization of the
// activations, an int8 x int8 -> int32 product on the integer tensor cores,
// and the f32 rescale in the epilogue.
//
// Replaces internvideo_tpu/ops/int8_gemm.py:68 `_kernel` (launched by
// `int8_matmul_fused` :106 -> `_int8_matmul_fused` :121 -> pl.pallas_call
// :134), and with it what ops/quant.py:int8_matmul(dynamic_activations=True)
// computes on its `auto` route. Inputs: x (M, K) float32 or bfloat16, row
// major; w_q (N, K) int8 with a row pitch ldb (a multiple of 16, zero
// filled past K): torch's (out, in) weight, the column-major B operand of
// mma ...row.col...s8.s8; w_scale (N,) float32. Output (M, N) float32 or
// bfloat16:
//   s[m]   = max(max_k |f32(x[m, k])|, 1e-8) / 127            (IEEE division)
//   q[m,k] = clip(rint(f32(x[m, k]) / s[m]), -127, 127)        (half to even)
//   out    = (f32(sum_k q[m, k] * w_q[n, k]) * s[m]) * w_scale[n]
// exactly the JAX cast chain (quant.py:26-31, 64-70): the codes and the
// int32 sums are bit-identical, and so are f32 outputs.
//
// Limits of its own: K a multiple of 4 (4-element loads of x) and
// K <= 133,143 (|acc| <= K * 127^2 fits int32); M and N are any size.
//
// What bounds it: at the path's shapes, operations. (16384, 4096, 12288) is
// 1.65 TOP against 0.26 GB of unique bytes: 0.833 ms at 1,979 TOPS int8.
//
// Design (simple first), two launches counted as one call. The TPU kernel
// quantizes a (bm, K) activation block once into VMEM scratch and reuses it
// across the sequential n-steps of its grid, so no quantized copy of x
// reaches HBM. Hopper's blocks run in parallel and share nothing: a fused
// version requantizes the block once per N-tile (N / 128 times; 96 at the
// 8B gate projection, ~6e9 IEEE divisions, and as many rereads of x for
// the absmax), far more than one pass over HBM costs. So here launch 1 quantizes each row once (a warp a row: the absmax, then the
// codes) into an (M, Kp) int8 scratch (Kp = K rounded up to 128, zero
// filled) and an (M,) scale vector: 2MK + MK bytes more traffic, ~0.06 ms
// at that shape. Launch 2 is a plain int8 GEMM: 128 x 128 CTA tiles (8
// warps of 64 x 32), 128-byte k-tiles in a 3-stage cp.async ring (108 KB,
// two CTAs an SM at <= 128 registers), fragments by ldmatrix.x4 from a
// conflict-free 144-byte pitch, mma.sync.m16n8k32.s32.s8.s8.s32, tiles
// rastered in groups of 16 M-tiles so that a wave's A and B tiles stay in
// L2; the epilogue rescales in f32 and stores the output type.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC, linked with the other sources into one shared
//        library (internvideo_tpu_torch/ops/_build.py).

#include "mma.cuh"

namespace {

using namespace ivt;

constexpr int kBM = 128, kBN = 128, kBK = 128;  // CTA tile; kBK in bytes of K
constexpr int kThreads = 256;                   // 8 warps: 2 (M) x 4 (N), 64 x 32 each
constexpr int kStages = 3;                      // cp.async ring depth
constexpr int kPitch = kBK + 16;                // shared row pitch: conflict-free fragments
constexpr int kStageBytes = (kBM + kBN) * kPitch;
constexpr int kSmemBytes = kStages * kStageBytes;  // 108 KB: dynamic shared memory
constexpr int kGroupM = 16;                     // M-tiles per raster group
constexpr int kRowsPerBlock = kThreads / 32;    // quantize: a warp a row

// D(16x8, s32) += A(16x32, s8, row) * B(32x8, s8, col)
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 4 adjacent activations as fp32.
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  f[0] = lo.x, f[1] = lo.y, f[2] = hi.x, f[3] = hi.y;
}

// quant.py:30: clip(round(x / s), -127, 127) with an IEEE division and
// round half to even; four codes packed low byte first (the mma's k order).
__device__ __forceinline__ uint32_t quantize4(const float* f, float s) {
  uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(f[i], s)), -127.f), 127.f);
    packed |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xffu) << (8 * i);
  }
  return packed;
}

// Launch 1: row m of x -> its scale s[m] and its codes, zero filled to Kp.
template <typename TX>
__global__ void __launch_bounds__(kThreads)
int8_quantize_rows(const TX* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
                   int M, int K, int Kp) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;  // warp-uniform
  const TX* xr = x + static_cast<long long>(row) * K;
  const int k4 = K / 4;
  float amax = 0.f;
#pragma unroll 4
  for (int c = lane; c < k4; c += 32) {
    float f[4];
    load4(xr + 4 * c, f);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(f[0]), fabsf(f[1])), fmaxf(fabsf(f[2]), fabsf(f[3]))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  uint32_t* qr = reinterpret_cast<uint32_t*>(xq + static_cast<long long>(row) * Kp);
#pragma unroll 4
  for (int c = lane; c < Kp / 4; c += 32) {
    uint32_t packed = 0u;
    if (c < k4) {
      float f[4];
      load4(xr + 4 * c, f);
      packed = quantize4(f, s);
    }
    qr[c] = packed;
  }
  if (lane == 0) xs[row] = s;
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Four 8x8 b16 matrices (an 8-bit mma operand in 32-bit units); lanes
// 8i..8i+7 address the rows of matrix i, which lands in r[i].
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Launch 2: out = (f32(xq @ wq^T) * xs[m]) * ws[n].
template <typename TO>
__global__ void __launch_bounds__(kThreads, 2)
int8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs, int lda,
                 const int8_t* __restrict__ wq, int ldb, const float* __restrict__ ws,
                 TO* __restrict__ out, int M, int N, int tiles_m, int tiles_n) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // grouped raster: kGroupM M-tiles sweep the N-tiles together
  const int pid = blockIdx.x, width = kGroupM * tiles_n;
  const int first_m = (pid / width) * kGroupM;
  const int group = min(tiles_m - first_m, kGroupM);
  const int m0 = (first_m + (pid % width) % group) * kBM;
  const int n0 = ((pid % width) / group) * kBN;
  const int tiles_k = lda / kBK;

  // a k-tile of A (128 rows x 128 bytes) and of B: 1024 16-byte chunks each
  auto load_stage = [&](int stage, int kt) {
    uint8_t* sa = smem + stage * kStageBytes;
    uint8_t* sb = sa + kBM * kPitch;
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < kBK / 32; ++i) {
      const int ci = tid + i * kThreads, r = ci / (kBK / 16), c = (ci % (kBK / 16)) * 16;
      const bool pa = m0 + r < M;
      cp_async_16(sa + r * kPitch + c,
                  pa ? xq + static_cast<long long>(m0 + r) * lda + k0 + c : xq, pa);
      const bool pb = n0 + r < N && k0 + c < ldb;
      cp_async_16(sb + r * kPitch + c,
                  pb ? wq + static_cast<long long>(n0 + r) * ldb + k0 + c : wq, pb);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles_k) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < tiles_k; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt landed; the stage refilled below is no longer read
    const int nk = kt + kStages - 1;
    if (nk < tiles_k) load_stage(nk % kStages, nk);
    cp_async_commit();
    const uint8_t* a_t = smem + (kt % kStages) * kStageBytes;
    const uint8_t* b_t = a_t + kBM * kPitch;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      // A: (rows 0-7 | 8-15) x (bytes 0-15 | 16-31) are a0..a3; B: one x4
      // gives two n-tiles' (bytes 0-15, 16-31) pairs
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], a_t + (wm + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch
                                + ks * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, b_t + (wn + nj * 16 + (lane & 7) + (lane >> 4) * 8) * kPitch + ks * 32
                           + ((lane >> 3) & 1) * 16);
        bf[2 * nj][0] = r[0], bf[2 * nj][1] = r[1], bf[2 * nj + 1][0] = r[2];
        bf[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();

  // epilogue: (f32(acc) * s[m]) * w_scale[n], stored as TO
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mi * 16 + g + 8 * half;
      if (m >= M) continue;
      const float s = __ldg(xs + m);
      TO* orow = out + static_cast<long long>(m) * N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn + ni * 8 + 2 * t + j;
          if (n < N) {
            const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * half + j]), s),
                                      __ldg(ws + n));
            store_out(orow + n, v);
          }
        }
      }
    }
  }
}

template <typename TX, typename TO>
int launch(const void* x, const void* wq, int ldb, const float* ws, int8_t* xq, float* xs,
           int Kp, void* out, int M, int N, int K, cudaStream_t stream) {
  int8_quantize_rows<TX><<<(M + kRowsPerBlock - 1) / kRowsPerBlock, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), xq, xs, M, K, Kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(int8_gemm_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);  // the 108 KB ring is dynamic shared memory
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  const long long tiles = static_cast<long long>(tiles_m) * tiles_n;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  int8_gemm_kernel<TO><<<static_cast<unsigned>(tiles), kThreads, kSmemBytes, stream>>>(
      xq, xs, Kp, static_cast<const int8_t*>(wq), ldb, ws, static_cast<TO*>(out), M, N,
      tiles_m, tiles_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_dtype / out_dtype: 0 float32, 1 bfloat16. xq_scratch is (M, Kp) int8
// and xs_scratch (M,) float32, Kp = K rounded up to a multiple of 128; w_q's
// rows are ldb bytes apart (ldb >= K, a multiple of 16, zero filled past K).
// Returns the cudaError_t of the launches (0 on success).
extern "C" int ivt_int8_gemm(int x_dtype, int out_dtype, const void* x, const void* w_q,
                             int ldb, const float* w_scale, void* xq_scratch,
                             float* xs_scratch, int Kp, void* out, int M, int N, int K,
                             void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 4 != 0 || K > 133143 || Kp % kBK != 0 || Kp < K || ldb % 16 != 0 ||
      ldb < K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* xq = static_cast<int8_t*>(xq_scratch);
  if (x_dtype == 0 && out_dtype == 0)
    return launch<float, float>(x, w_q, ldb, w_scale, xq, xs_scratch, Kp, out, M, N, K, s);
  if (x_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w_q, ldb, w_scale, xq, xs_scratch, Kp, out, M, N,
                                        K, s);
  if (x_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w_q, ldb, w_scale, xq, xs_scratch, Kp, out, M, N,
                                        K, s);
  if (x_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w_q, ldb, w_scale, xq, xs_scratch, Kp, out,
                                                 M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
