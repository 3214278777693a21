// Dynamic-int8 GEMM for Hopper (sm_90a): per-row absmax quantization of the
// activations, an int8 x int8 -> int32 product on the integer tensor cores,
// and the f32 rescale in the epilogue.
//
// Replaces internvideo_tpu/ops/int8_gemm.py:68 `_kernel` (launched by
// `int8_matmul_fused` :106 -> `_int8_matmul_fused` :121 -> pl.pallas_call
// :134), and with it what ops/quant.py:int8_matmul(dynamic_activations=True)
// computes on its `auto` route. Inputs: x (M, K) float32 or bfloat16, row
// major; w_q (N, K) int8 with a row pitch ldb (a multiple of 16, zero
// filled past K): torch's (out, in) weight, K-major as wgmma's B operand;
// w_scale (N,) float32. Output (M, N) float32 or bfloat16:
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
// Design: two launches counted as one call. The TPU kernel quantizes a
// (bm, K) activation block once into VMEM scratch and reuses it across the
// sequential n-steps of its grid. Hopper's blocks run in parallel and share
// nothing, so a fused version would requantize each row once per N-tile.
// Launch 1 quantizes each row once (the absmax, then the codes, from the
// row's values kept in registers: x is read once) into an (M, Kp) int8
// scratch (Kp = K rounded up to 128, zero filled) and an (M,) scale vector:
// 3MK bytes more traffic, 0.02-0.7 ms at the path's shapes (PERF.md).
// Launch 2 is the GEMM, warp-specialised on hopper.cuh:
// - persistent CTAs, one an SM, each walking 128 x 256 output tiles in the
//   grouped raster (16 M-tiles sweep the N-tiles together, so a wave's A
//   and B k-tiles stay in L2);
// - a producer warp alone walks (tile, k-tile) and TMA-loads the 128-byte
//   k-tiles of the codes (128 rows) and of w_q (256 rows), 128-byte
//   swizzle, into a ring of 4 stages (48 KB each) with full / empty
//   mbarriers; it runs on into the next tile while the consumers store;
// - two consumer warpgroups of 64 rows x 256 columns each: four
//   wgmma.m64n256k32.s32.s8.s8 a k-tile from shared memory (both operands
//   K-major), 128 int32 accumulators a thread, one group in flight while
//   the next k-tile's is issued; the epilogue rescales in f32 with the
//   chain above and stores the output type from registers, bf16 pairs
//   transposed across each quad of threads first so that a warp store
//   writes 64 bytes a row (16 bytes, half a sector, without it).
// 128 x 128 tiles, and two co-resident CTAs an SM of one consumer on a
// 128 x 128 tile with 3 stages, were timed beside this design (PERF.md):
// each won at the encoder's and tower's short K by up to 16 % and lost at
// the 8B prefill's shapes by up to 23 %.
// M and N tails are TMA's zero fill; the K tail is zero in the codes (Kp)
// and in w_q past K, and w_q is mapped at its true ldb, so a k-tile past
// ldb reads zeros.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC, linked with the other sources into one shared
//        library (internvideo_tpu_torch/ops/_build.py).

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace ivt;
namespace hp = ivt::hopper;

constexpr int kQuantThreads = 256;                   // quantize: a CTA of 8 warps
constexpr int kCache = 12;  // quantize: groups of 4 a thread keeps in registers
constexpr int kBM = 128, kBN = 256, kBK = 128;       // CTA tile; kBK in bytes of K
constexpr int kStages = 4;                           // TMA ring depth
constexpr int kABytes = kBM * kBK, kBBytes = kBN * kBK;
constexpr int kStageBytes = kABytes + kBBytes;       // 48 KB
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + barriers, align
constexpr int kGemmThreads = 384;  // a producer warpgroup and two consumer warpgroups
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 x 40 + 256 x 232 <= 384 x 168
constexpr int kGroupM = 16;                          // M-tiles per raster group
static_assert(kSmemBytes <= 232448, "over the 227 KB a CTA may use");

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
// round half to even; four codes packed low byte first (their K order).
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
// kWarps warps take a row (1, or a CTA of 8 for rows past 32 x kCache
// groups of 4); each thread keeps its first kCache groups in registers, so
// x is read once (groups past them, K > 12,288 at kWarps 8, are read again).
template <typename TX, int kWarps>
__global__ void __launch_bounds__(kQuantThreads)
int8_quantize_rows(const TX* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
                   int M, int K, int Kp) {
  constexpr int kLanes = 32 * kWarps;  // threads a row
  __shared__ float part[kQuantThreads / 32];
  const int row = blockIdx.x * (kQuantThreads / kLanes) + threadIdx.x / kLanes;
  const int j = threadIdx.x % kLanes;  // the thread's first group of 4
  if (row >= M) return;  // uniform over the threads of a row (the CTA at kWarps 8)
  const TX* xr = x + static_cast<long long>(row) * K;
  const int k4 = K / 4;
  float f[kCache][4];
  float amax = 0.f;
  auto absmax4 = [](const float* v) {
    return fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3])));
  };
#pragma unroll
  for (int u = 0; u < kCache; ++u) {
    const int c = j + u * kLanes;
    if (c < k4) {
      load4(xr + 4 * c, f[u]);
      amax = fmaxf(amax, absmax4(f[u]));
    }
  }
  for (int c = j + kCache * kLanes; c < k4; c += kLanes) {
    float v[4];
    load4(xr + 4 * c, v);
    amax = fmaxf(amax, absmax4(v));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if constexpr (kWarps > 1) {
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = amax;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) amax = fmaxf(amax, part[w]);
  }
  const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  uint32_t* qr = reinterpret_cast<uint32_t*>(xq + static_cast<long long>(row) * Kp);
#pragma unroll
  for (int u = 0; u < kCache; ++u) {
    const int c = j + u * kLanes;
    if (c < Kp / 4) qr[c] = c < k4 ? quantize4(f[u], s) : 0u;
  }
  for (int c = j + kCache * kLanes; c < Kp / 4; c += kLanes) {
    uint32_t packed = 0u;
    if (c < k4) {
      float v[4];
      load4(xr + 4 * c, v);
      packed = quantize4(v, s);
    }
    qr[c] = packed;
  }
  if (j == 0) xs[row] = s;
}

// a[i] for a runtime i in [0, 4), as selects (no local memory)
__device__ __forceinline__ uint32_t pick4(const uint32_t (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// The grouped raster: tile -> its first row and column.
__device__ __forceinline__ int2 tile_origin(int tile, int tiles_m, int tiles_n) {
  const int width = kGroupM * tiles_n;
  const int first_m = (tile / width) * kGroupM;
  const int group = min(tiles_m - first_m, kGroupM);
  return make_int2((first_m + (tile % width) % group) * kBM, ((tile % width) / group) * kBN);
}

// Launch 2: out = (f32(xq @ wq^T) * xs[m]) * ws[n]; a_map holds the (M, Kp)
// codes, b_map w_q (N, ldb), both with 128-byte boxes (kBM / kBN rows).
template <typename TO>
__global__ void __launch_bounds__(kGemmThreads, 1)
    int8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                           const __grid_constant__ CUtensorMap b_map,
                           const float* __restrict__ xs, const float* __restrict__ ws,
                           TO* __restrict__ out, int M, int N, int tiles_m, int tiles_n,
                           int tiles_k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = tiles_m * tiles_n;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);   // the producer, with the bytes
      hp::mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    // Producer warpgroup: one thread walks (tile, k-tile) and issues every load.
    hp::setmaxnreg_dec<kProducerRegs>();
    if (tid != 0) return;
    hp::prefetch_map(&a_map);
    hp::prefetch_map(&b_map);
    int stage = 0;
    unsigned phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int2 o = tile_origin(tile, tiles_m, tiles_n);
      for (int kt = 0; kt < tiles_k; ++kt) {
        hp::mbar_wait(&empty[stage], phase ^ 1);
        hp::mbar_arrive_expect_tx(&full[stage], kStageBytes);
        unsigned char* sa = smem + stage * kStageBytes;
        hp::tma_load_2d(sa, &a_map, &full[stage], kt * kBK, o.x);
        hp::tma_load_2d(sa + kABytes, &b_map, &full[stage], kt * kBK, o.y);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumer warpgroup wg: rows [64 wg, 64 wg + 64) of each tile, all kBN
  // columns. Thread (warp w, lane l) holds rows 16 (w % 4) + l / 4 (+ 8)
  // and columns 8 i + 2 (l % 4) (+ 1) in acc[4 i .. 4 i + 3].
  hp::setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4 - 1;
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = N % 2 == 0, octets = N % 8 == 0;  // 8- / 16-byte aligned stores
  int acc[kBN / 2];
  int stage = 0;
  unsigned phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int2 o = tile_origin(tile, tiles_m, tiles_n);
    int prev = 0;
    for (int kt = 0; kt < tiles_k; ++kt) {
      hp::mbar_wait(&full[stage], phase);
      const unsigned char* sa = smem + stage * kStageBytes;
      const uint64_t da = hp::make_desc(sa + wg * 64 * kBK, kBK, 16, 8 * kBK);
      const uint64_t db = hp::make_desc(sa + kABytes, kBK, 16, 8 * kBK);
      hp::fence_regs(acc);
      hp::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 32; ++ks)
        hp::wgmma_s8(acc, hp::desc_add(da, 32 * ks), hp::desc_add(db, 32 * ks),
                     kt > 0 || ks > 0);
      hp::wgmma_commit();
      hp::wgmma_wait<1>();  // the previous k-tile's products are done
      hp::fence_regs(acc);
      if (kt > 0) {
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(&empty[prev]);  // this warp is done with it
      }
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[prev]);

    // epilogue: (f32(acc) * s[m]) * w_scale[n], stored as TO. A quad of
    // threads holds 8 consecutive columns of a row in an n-tile (a pair
    // each): f32 pairs make a whole 32-byte sector a row. bf16 pairs are
    // transposed across the quad, four n-tiles at a time, so that each
    // thread stores 8 columns (16 bytes) and a quad 64 bytes of a row.
    int rows[2];
    float sc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rows[r] = o.x + 64 * wg + 16 * (warp & 3) + g + 8 * r;
      sc[r] = rows[r] < M ? __ldg(xs + rows[r]) : 0.f;
    }
    auto rescale = [&](int r, int i, int e) {  // row r, column 8 i + 2 t + e of the tile
      const int n = o.y + 8 * i + 2 * t + e;
      return n < N ? __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * i + 2 * r + e]), sc[r]),
                               __ldg(ws + n))
                   : 0.f;
    };
    if constexpr (std::is_same<TO, float>::value) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] >= M) continue;
        float* orow = out + static_cast<long long>(rows[r]) * N;
#pragma unroll
        for (int i = 0; i < kBN / 8; ++i) {
          const int n = o.y + 8 * i + 2 * t;
          if (n + 1 < N && pairs) {
            *reinterpret_cast<float2*>(orow + n) =
                make_float2(rescale(r, i, 0), rescale(r, i, 1));
          } else {
            if (n < N) orow[n] = rescale(r, i, 0);
            if (n + 1 < N) orow[n + 1] = rescale(r, i, 1);
          }
        }
      }
    } else {
#pragma unroll
      for (int i0 = 0; i0 < kBN / 8; i0 += 4) {
        uint32_t pk[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            pk[r][j] = pack_bf16(rescale(r, i0 + j, 0), rescale(r, i0 + j, 1));
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t got[4], q[4];
          // round k: from quad lane t ^ k its pair of n-tile i0 + t
#pragma unroll
          for (int k = 0; k < 4; ++k)
            got[k] = k == 0 ? pick4(pk[r], t)
                            : __shfl_xor_sync(0xffffffffu, pick4(pk[r], t ^ k), k);
#pragma unroll
          for (int c = 0; c < 4; ++c) q[c] = pick4(got, c ^ t);  // columns 2 c, 2 c + 1
          const int n = o.y + 8 * (i0 + t);
          if (rows[r] >= M || n >= N) continue;
          __nv_bfloat16* dst = out + static_cast<long long>(rows[r]) * N + n;
          if (octets && n + 8 <= N) {
            *reinterpret_cast<uint4*>(dst) = make_uint4(q[0], q[1], q[2], q[3]);
          } else {
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              if (n + c < N)
                dst[c] = __ushort_as_bfloat16(
                    static_cast<unsigned short>(q[c / 2] >> (16 * (c % 2))));
            }
          }
        }
        asm volatile("" ::: "memory");  // one chunk's scale loads at a time (no spills)
      }
    }
  }
}

template <typename TX, typename TO>
int launch(const void* x, const void* wq, int ldb, const float* ws, int8_t* xq, float* xs,
           int Kp, void* out, int M, int N, int K, cudaStream_t stream) {
  if (K / 4 <= 32 * kCache)  // a warp a row, 8 rows a CTA
    int8_quantize_rows<TX, 1><<<(M + 7) / 8, kQuantThreads, 0, stream>>>(
        static_cast<const TX*>(x), xq, xs, M, K, Kp);
  else  // a CTA a row
    int8_quantize_rows<TX, 8><<<M, kQuantThreads, 0, stream>>>(static_cast<const TX*>(x), xq,
                                                                 xs, M, K, Kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  if (tiles_m * tiles_n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap maps[2];  // the codes, w_q
  err = hp::encode_2d_u8(&maps[0], xq, Kp, M, Kp, kBM);
  if (err == cudaSuccess) err = hp::encode_2d_u8(&maps[1], wq, ldb, N, ldb, kBN);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(int8_gemm_wgmma_kernel<TO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = static_cast<int>(tiles_m * tiles_n);
  int8_gemm_wgmma_kernel<TO><<<tiles < sms ? tiles : sms, kGemmThreads, kSmemBytes, stream>>>(
      maps[0], maps[1], xs, ws, static_cast<TO*>(out), M, N, static_cast<int>(tiles_m),
      static_cast<int>(tiles_n), Kp / kBK);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_dtype / out_dtype: 0 float32, 1 bfloat16. xq_scratch is (M, Kp) int8
// and xs_scratch (M,) float32, Kp = K rounded up to a multiple of 128; w_q's
// rows are ldb bytes apart (ldb >= K, a multiple of 16, zero filled past K).
// Returns the cudaError_t of the launches (0 on success; cudaErrorInvalidValue
// also when cuTensorMapEncodeTiled refuses a map of the codes or of w_q).
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
