// Flash-attention forward for Hopper (sm_90a): non-causal, no segment ids,
// one K/V head per query head, d_v == d_qk, inputs in (B, S, H, D).
//
// Replaces internvideo_tpu/ops/flash_attention.py:153 `_fwd_kernel` (launched
// by `_fwd` :322 and reached from `flash_attention` :2037 and
// `flash_attention_with_lse` :1188) for the encoder's case. The TPU kernel's
// ragged-tail decomposition, ones-column denominator and (8, 128) tiling are
// not carried over: the last K/V tile masks keys >= Sk to -inf and query rows
// >= Sq are never stored, so S = 4097 runs as one kernel.
//
// What bounds it: per 64-query tile the kernel reads all of K and V once, and
// does 4 * 64 * d FLOPs per key for 2 * 2 * d bytes of K/V, about 64 FLOPs
// per byte from L2; K/V of one head (4097 x 88 x 2 x 2 B = 1.4 MB) stays in
// the 50 MB L2 across the 65 query tiles that share it. So it is bound by the
// tensor cores and by the softmax's exp2 work between the two products, not
// by device memory.
//
// Design (right and simple first): one CTA per (64-query tile, head, batch);
// 4 warps of 16 query rows; K/V tiles of 64 keys double-buffered in shared
// memory with cp.async; QK^T and PV on mma.sync.m16n8k16 (bf16 in, fp32
// accumulate) with P kept in registers between the two; online softmax in
// the base-2 domain (scale * log2(e) folded into the score scale). Head dim 88
// is zero-padded to 96 in shared memory for the QK^T k-steps; PV runs 88 / 8
// = 11 n-tiles with no pad. fp32 inputs take a CUDA-core FMA kernel (used by
// the parity checks, not by the bf16 main path). wgmma, TMA and warp
// specialisation are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC, linked with the other sources into one shared
//        library (internvideo_tpu_torch/ops/_build.py).

#include "mma.cuh"

namespace {

using namespace ivt;

constexpr int kBlockM = 64;  // query rows per CTA (4 warps x 16)
constexpr int kBlockN = 64;  // keys per K/V tile
constexpr int kThreads = 128;

struct Strides {  // element strides of (batch, sequence, head); last dim is unit
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

template <int D>
struct Bf16Tile {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8 (16-byte rows)");
  static constexpr int kDPad = (D + 15) / 16 * 16;  // QK^T k-steps of 16
  static constexpr int kStride = kDPad + 8;         // smem row: +16 B avoids bank conflicts
  static constexpr int kChunks = D / 8;             // 16-byte chunks per row
  static constexpr int kKSteps = kDPad / 16;
  static constexpr int kNV = D / 8;                 // n-tiles of the PV product
  static constexpr int kTile = kBlockM * kStride;   // elements of one tile buffer
  static constexpr int kSmemBytes = 5 * kTile * 2;  // Q + 2 K + 2 V
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int Sq, int Sk, int H, Strides st,
                          float scale_log2) {
  using T = Bf16Tile<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + T::kTile;      // two buffers
  __nv_bfloat16* sV = sK + 2 * T::kTile;  // two buffers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int m0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qb = q + b * st.q_b + h * st.q_h;
  const __nv_bfloat16* kb = k + b * st.k_b + h * st.k_h;
  const __nv_bfloat16* vb = v + b * st.v_b + h * st.v_h;

  // Zero the pad columns [D, kDPad) of Q and both K buffers once; cp.async
  // never writes them, so they stay zero and add nothing to QK^T.
  if (T::kDPad > D) {
    for (int r = tid; r < 3 * kBlockM; r += kThreads) {
      __nv_bfloat16* row = (r < kBlockM ? sQ + r * T::kStride : sK + (r - kBlockM) * T::kStride);
#pragma unroll
      for (int c = D; c < T::kDPad; ++c) row[c] = __float2bfloat16(0.f);
    }
  }

  // Rows at or past `valid` are zero-filled (finite, so masked keys give p = 0).
  auto load_tile = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, long long s_stride, int row0,
                       int valid) {
    for (int i = tid; i < kBlockM * T::kChunks; i += kThreads) {
      const int r = i / T::kChunks, c = i - r * T::kChunks;
      const bool ok = row0 + r < valid;
      const __nv_bfloat16* p = ok ? src + (long long)(row0 + r) * s_stride + c * 8 : src;
      cp_async_16(dst + r * T::kStride + c * 8, p, ok);
    }
  };

  const int n_tiles = (Sk + kBlockN - 1) / kBlockN;
  load_tile(sQ, qb, st.q_s, m0, Sq);
  if (n_tiles > 0) {
    load_tile(sK, kb, st.k_s, 0, Sk);
    load_tile(sV, vb, st.v_s, 0, Sk);
  }
  cp_async_commit();

  const int qr = warp * 16;  // this warp's first row in the query tile
  uint32_t qf[T::kKSteps][4];
  float acc[T::kNV][4];
#pragma unroll
  for (int n = 0; n < T::kNV; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max of base-2 scores, rows g and g+8
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums

  for (int j = 0; j < n_tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(sK + (cur ^ 1) * T::kTile, kb, st.k_s, (j + 1) * kBlockN, Sk);
      load_tile(sV + (cur ^ 1) * T::kTile, vb, st.v_s, (j + 1) * kBlockN, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < T::kKSteps; ++ks) {
        const __nv_bfloat16* p0 = sQ + (qr + g) * T::kStride + ks * 16 + 2 * t;
        const __nv_bfloat16* p1 = p0 + 8 * T::kStride;
        qf[ks][0] = ld_u32(p0);
        qf[ks][1] = ld_u32(p1);
        qf[ks][2] = ld_u32(p0 + 8);
        qf[ks][3] = ld_u32(p1 + 8);
      }
    }
    const __nv_bfloat16* sKc = sK + cur * T::kTile;
    const __nv_bfloat16* sVc = sV + cur * T::kTile;

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys).
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < T::kKSteps; ++ks) {
        const __nv_bfloat16* kp = sKc + (nt * 8 + g) * T::kStride + ks * 16 + 2 * t;
        const uint32_t bf[2] = {ld_u32(kp), ld_u32(kp + 8)};
        mma_16816(s[nt], qf[ks], bf);
      }
    }

    // Online softmax. Fragment element e sits at row g + 8 * (e >> 1) and
    // key 8 * nt + 2 * t + (e & 1).
    const int key0 = j * kBlockN;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nt * 8 + 2 * t + (e & 1);
        const float x = key < Sk ? s[nt][e] * scale_log2 : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_use = mx[r] == -INFINITY ? 0.f : mx[r];  // row fully masked so far
      alpha[r] = exp2f(m_run[r] - m_use);
      m_run[r] = mx[r];
      mx[r] = m_use;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - mx[e >> 1]);
        s[nt][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < T::kNV; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P's accumulator fragments become the A operand (bf16) of
    // four k-steps of 16 keys; V's B fragments come transposed via ldmatrix.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vrow = sVc + (kk * 16 + (lane & 15)) * T::kStride;
#pragma unroll
      for (int n = 0; n < T::kNV; ++n) {
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, vrow + n * 8);
        mma_16816(acc[n], a, bf);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = m0 + qr + g + 8 * r;
    if (row >= Sq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;  // a row that sees no key gets 0
    __nv_bfloat16* op = o + b * st.o_b + (long long)row * st.o_s + h * st.o_h;
#pragma unroll
    for (int n = 0; n < T::kNV; ++n) {
      *reinterpret_cast<uint32_t*>(op + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
    if (t == 0) {
      lse[((long long)b * H + h) * Sq + row] = l > 0.f ? (m_run[r] + log2f(l)) * kLn2 : -INFINITY;
    }
  }
}

// fp32: one thread per query row, K/V tiles of 32 keys in shared memory,
// CUDA-core FMAs. Numerics as the bf16 kernel (base-2 online softmax).
constexpr int kF32Rows = 64;
constexpr int kF32Keys = 32;

template <int D>
__global__ void __launch_bounds__(kF32Rows)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int Sq, int Sk, int H, Strides st,
                         float scale_log2) {
  __shared__ float sK[kF32Keys][D];
  __shared__ float sV[kF32Keys][D];
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kF32Rows + tid;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* kb = k + b * st.k_b + h * st.k_h;
  const float* vb = v + b * st.v_b + h * st.v_h;
  const bool valid = row < Sq;

  float qr[D], acc[D];
  const float* qp = q + b * st.q_b + (long long)(valid ? row : 0) * st.q_s + h * st.q_h;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = valid ? qp[c] : 0.f;
    acc[c] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kF32Keys) {
    __syncthreads();
    for (int i = tid; i < kF32Keys * D; i += kF32Rows) {
      const int r = i / D, c = i - r * D;
      const bool ok = k0 + r < Sk;
      sK[r][c] = ok ? kb[(long long)(k0 + r) * st.k_s + c] : 0.f;
      sV[r][c] = ok ? vb[(long long)(k0 + r) * st.v_s + c] : 0.f;
    }
    __syncthreads();
    float s[kF32Keys];
    float mx = m_run;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
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
    for (int j = 0; j < kF32Keys; ++j) {
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
  lse[((long long)b * H + h) * Sq + row] =
      l_run > 0.f ? (m_run + log2f(l_run)) * kLn2 : -INFINITY;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int Sq, int Sk, int H, const Strides& st, float scale_log2,
                        cudaStream_t stream) {
  const auto kern = flash_fwd_bf16_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Bf16Tile<D>::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, H, B);
  kern<<<grid, kThreads, Bf16Tile<D>::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, H, st,
      scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int Sq, int Sk, int H, const Strides& st, float scale_log2,
                       cudaStream_t stream) {
  const dim3 grid((Sq + kF32Rows - 1) / kF32Rows, H, B);
  flash_fwd_f32_kernel<D><<<grid, kF32Rows, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, Sq, Sk, H, st, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// C entry bound with ctypes. dtype: 0 = float32, 1 = bfloat16. `strides`
// holds 12 int64: (batch, seq, head) element strides of q, k, v, o. Returns
// the cudaError_t of the launch (cudaErrorInvalidValue for an unsupported
// head dim or dtype). Launches on `stream`; does not synchronise.
extern "C" int ivt_flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                             float* lse, int B, int Sq, int Sk, int H, int D,
                             const long long* strides, float scale, void* stream) {
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  const float scale_log2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IVT_CASE(DIM)                                                              \
  case DIM:                                                                        \
    return dtype == 1 ? launch_bf16<DIM>(q, k, v, o, lse, B, Sq, Sk, H, st, scale_log2, s) \
                      : launch_f32<DIM>(q, k, v, o, lse, B, Sq, Sk, H, st, scale_log2, s);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (D) {
    IVT_CASE(64)
    IVT_CASE(88)
    default:
      return cudaErrorInvalidValue;
  }
#undef IVT_CASE
}
