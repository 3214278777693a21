// Device bodies of the attention forward kernels (sm_90a). The bf16
// mma.sync body is K11's (fused_qkv_large.cu, with its norm on load); the
// fp32 body is also K1's, K2's and K3's (flash_fwd.cu, small_s_fwd.cu,
// fused_qkv.cu), whose bf16 kernels run K5's wgmma + TMA body
// (flash_fwd_causal.cu) instead. Each of those files defines its own
// __global__ kernels, which call these bodies, so every TPU kernel keeps
// its own symbol, entry point and launch count.
//
// bf16: one CTA per (64-query tile, head, batch); 4 warps of 16 query rows;
// K/V tiles of 64 keys double-buffered in shared memory with cp.async; QK^T
// and PV on mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with P kept in
// registers between the two; online softmax in the base-2 domain (scale *
// log2(e) folded into the score scale). Head dims that are not a multiple of
// 16 (88) are zero-padded to the next one in shared memory for the QK^T
// k-steps; PV runs D / 8 n-tiles with no pad. Keys >= Sk are masked to
// -inf, query rows >= Sq are never stored. fp32 inputs take a CUDA-core FMA
// body (the parity checks, not the bf16 main path).
//
// The bf16 body, and the fp32 body with kNorm = true, apply K3's whole-dim
// QK-RMSNorm (mma.cuh QkNorm) to each q and k tile as it lands in shared
// memory (registers, fp32), from per-row 1/rms factors a pre-pass wrote
// (fused_qkv.cu):
// x -> w * (x * rstd) with the cast chain of
// internvideo_tpu/ops/flash_attention.py:1706-1710 (bf16: the normed value
// is rounded to bf16, multiplied by the fp32 weight, rounded again). The
// normalized q and k never reach device memory.
#pragma once

#include "mma.cuh"

namespace ivt {

constexpr int kFwdBlockM = 64;  // query rows per CTA (4 warps x 16)
constexpr int kFwdBlockN = 64;  // keys per K/V tile
constexpr int kFwdThreads = 128;

struct FwdStrides {  // element strides of (batch, sequence, head); last dim is unit
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

template <int D>
struct FwdTile {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8 (16-byte rows)");
  static constexpr int kDPad = (D + 15) / 16 * 16;     // QK^T k-steps of 16
  static constexpr int kStride = kDPad + 8;            // smem row: +16 B avoids bank conflicts
  static constexpr int kChunks = D / 8;                // 16-byte chunks per row
  static constexpr int kKSteps = kDPad / 16;
  static constexpr int kNV = D / 8;                    // n-tiles of the PV product
  static constexpr int kTile = kFwdBlockM * kStride;   // elements of one tile buffer
  static constexpr int kSmemBytes = 5 * kTile * 2;     // Q + 2 K + 2 V
};

// In place: tile[r][c] = bf16(w[c] * f32(bf16(tile[r][c] * rstd[row0 + r])))
// for the rows below `valid`; rows past it stay zero. One 16-byte chunk (8
// columns) a thread per step: a 128-bit shared load and store, the weights
// as two float4 (`w` 16-byte aligned; D and the chunk offsets are
// multiples of 4 floats).
template <int D>
__device__ __forceinline__ void rms_norm_tile(__nv_bfloat16* tile, const float* rstd,
                                              const float* w, int row0, int valid, int tid) {
  using T = FwdTile<D>;
  for (int i = tid; i < kFwdBlockM * T::kChunks; i += kFwdThreads) {
    const int r = i / T::kChunks, c = (i - r * T::kChunks) * 8;
    if (row0 + r >= valid) continue;
    const float rs = rstd[row0 + r];
    uint4* p = reinterpret_cast<uint4*>(tile + r * T::kStride + c);
    uint4 raw = *p;
    __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(&raw);
    const float4 w0 = *reinterpret_cast<const float4*>(w + c);
    const float4 w1 = *reinterpret_cast<const float4*>(w + c + 4);
    const float ws[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(x2[j]);
      const float n0 = __bfloat162float(__float2bfloat16(f.x * rs));
      const float n1 = __bfloat162float(__float2bfloat16(f.y * rs));
      x2[j] = __floats2bfloat162_rn(ws[2 * j] * n0, ws[2 * j + 1] * n1);
    }
    *p = raw;
  }
}

// The bf16 body applies the norm on load (K11 is its only user)
// and writes no LSE.
template <int D>
__device__ __forceinline__ void attn_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                                              const __nv_bfloat16* __restrict__ k,
                                              const __nv_bfloat16* __restrict__ v,
                                              __nv_bfloat16* __restrict__ o, int Sq, int Sk,
                                              const FwdStrides& st, float scale_log2,
                                              const QkNorm& nrm) {
  using T = FwdTile<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + T::kTile;      // two buffers
  __nv_bfloat16* sV = sK + 2 * T::kTile;  // two buffers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int m0 = blockIdx.x * kFwdBlockM;
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qb = q + b * st.q_b + h * st.q_h;
  const __nv_bfloat16* kb = k + b * st.k_b + h * st.k_h;
  const __nv_bfloat16* vb = v + b * st.v_b + h * st.v_h;

  // Zero the pad columns [D, kDPad) of Q and both K buffers once; cp.async
  // never writes them, so they stay zero and add nothing to QK^T.
  if (T::kDPad > D) {
    for (int r = tid; r < 3 * kFwdBlockM; r += kFwdThreads) {
      __nv_bfloat16* row =
          (r < kFwdBlockM ? sQ + r * T::kStride : sK + (r - kFwdBlockM) * T::kStride);
#pragma unroll
      for (int c = D; c < T::kDPad; ++c) row[c] = __float2bfloat16(0.f);
    }
  }

  // Rows at or past `valid` are zero-filled (finite, so masked keys give p = 0).
  auto load_tile = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, long long s_stride, int row0,
                       int valid) {
    for (int i = tid; i < kFwdBlockM * T::kChunks; i += kFwdThreads) {
      const int r = i / T::kChunks, c = i - r * T::kChunks;
      const bool ok = row0 + r < valid;
      const __nv_bfloat16* p = ok ? src + (long long)(row0 + r) * s_stride + c * 8 : src;
      cp_async_16(dst + r * T::kStride + c * 8, p, ok);
    }
  };

  const int n_tiles = (Sk + kFwdBlockN - 1) / kFwdBlockN;
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
      load_tile(sK + (cur ^ 1) * T::kTile, kb, st.k_s, (j + 1) * kFwdBlockN, Sk);
      load_tile(sV + (cur ^ 1) * T::kTile, vb, st.v_s, (j + 1) * kFwdBlockN, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (j == 0) rms_norm_tile<D>(sQ, nrm.q_rstd + (long long)b * Sq, nrm.q_w + h * D, m0, Sq, tid);
    rms_norm_tile<D>(sK + cur * T::kTile, nrm.k_rstd + (long long)b * Sk, nrm.k_w + h * D,
                     j * kFwdBlockN, Sk, tid);
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
    float s[kFwdBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kFwdBlockN / 8; ++nt) {
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
    const int key0 = j * kFwdBlockN;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kFwdBlockN / 8; ++nt) {
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
    for (int nt = 0; nt < kFwdBlockN / 8; ++nt) {
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
    for (int kk = 0; kk < kFwdBlockN / 16; ++kk) {
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
  }
}

// fp32: one thread per query row, K/V tiles of 32 keys in shared memory,
// CUDA-core FMAs. Numerics as the bf16 body (base-2 online softmax).
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

// Launch `kern` on grid (ceil(Sq / rows), H, B); the bf16 bodies take
// FwdTile<D>::kSmemBytes of dynamic shared memory (above the 48 KB default,
// hence the attribute), the fp32 bodies only static shared memory.
template <typename Kern, typename... Args>
cudaError_t launch_fwd(Kern kern, bool bf16, int smem, int B, int Sq, int H, cudaStream_t stream,
                       Args... args) {
  const int rows = bf16 ? kFwdBlockM : kFwdF32Rows;
  if (bf16) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Sq + rows - 1) / rows, H, B);
  kern<<<grid, bf16 ? kFwdThreads : kFwdF32Rows, bf16 ? smem : 0, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace ivt
