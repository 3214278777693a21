// Device bodies of the attention backward kernels (sm_90a), shared by
// flash_bwd.cu (K4a) and small_s_bwd.cu (K4b). Each of those files defines
// its own __global__ kernels, which call these bodies, so every TPU kernel
// keeps its own symbol, entry point and launch count. The design is
// described in flash_bwd.cu.
#pragma once

#include "mma.cuh"

namespace ivt {

using bf16 = __nv_bfloat16;

constexpr int kBwdBlock = 64;  // rows a CTA owns (4 warps x 16) = rows of a streamed tile
constexpr int kBwdThreads = 128;

struct BwdStrides {  // element strides of (batch, sequence, head); last dim is unit
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, do_b, do_s, do_h, dq_b, dq_s, dq_h,
      dkv_b, dkv_s, dkv_h;
};

template <int D>
struct BwdTile {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8 (16-byte rows)");
  static constexpr int kDPad = (D + 15) / 16 * 16;  // k-steps of 16 over d
  static constexpr int kStride = kDPad + 8;         // smem row: +16 B avoids bank conflicts
  static constexpr int kChunks = D / 8;             // 16-byte chunks per row
  static constexpr int kKSteps = kDPad / 16;
  static constexpr int kND = D / 8;                 // n-tiles of 8 over d
  static constexpr int kTile = kBwdBlock * kStride;    // elements of one tile buffer
  // six bf16 tiles, then (dkv kernel) two buffers of 64 lse and 64 delta
  static constexpr int kSmemBytes = 6 * kTile * 2 + 4 * kBwdBlock * 4;
};

// cp.async 64 rows of a (S, D) slice into a tile; rows at or past `valid`
// are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long s_stride,
                                          int row0, int valid, int tid) {
  using T = BwdTile<D>;
  for (int i = tid; i < kBwdBlock * T::kChunks; i += kBwdThreads) {
    const int r = i / T::kChunks, c = i - r * T::kChunks;
    const bool ok = row0 + r < valid;
    const bf16* p = ok ? src + (long long)(row0 + r) * s_stride + c * 8 : src;
    cp_async_16(dst + r * T::kStride + c * 8, p, ok);
  }
}

// Zero the pad columns [D, kDPad) of `n_rows` tile rows once; cp.async never
// writes them, so they add nothing to the products that reduce over d.
template <int D>
__device__ __forceinline__ void zero_pad(bf16* base, int n_rows, int tid) {
  using T = BwdTile<D>;
  if (T::kDPad > D) {
    for (int r = tid; r < n_rows; r += kBwdThreads) {
#pragma unroll
      for (int c = D; c < T::kDPad; ++c) base[r * T::kStride + c] = __float2bfloat16(0.f);
    }
  }
}

// natural-log LSE -> base 2; a row that saw no key (-inf) gets +inf, so p = 0
__device__ __forceinline__ float lse_base2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * kLog2e;
}

template <int D>
__device__ __forceinline__ void attn_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             bf16* __restrict__ dq, int Sq, int Sk, int H, BwdStrides st,
                             float scale, float scale_log2) {
  using T = BwdTile<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + T::kTile;
  bf16* sK = sDO + T::kTile;      // two buffers
  bf16* sV = sK + 2 * T::kTile;   // two buffers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kBwdBlock;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q + b * st.q_b + h * st.q_h;
  const bf16* kb = k + b * st.k_b + h * st.k_h;
  const bf16* vb = v + b * st.v_b + h * st.v_h;
  const bf16* dob = dout + b * st.do_b + h * st.do_h;

  zero_pad<D>(sQ, 6 * kBwdBlock, tid);

  const int n_tiles = (Sk + kBwdBlock - 1) / kBwdBlock;
  load_rows<D>(sQ, qb, st.q_s, m0, Sq, tid);
  load_rows<D>(sDO, dob, st.do_s, m0, Sq, tid);
  if (n_tiles > 0) {
    load_rows<D>(sK, kb, st.k_s, 0, Sk, tid);
    load_rows<D>(sV, vb, st.v_s, 0, Sk, tid);
  }
  cp_async_commit();

  const int qr = warp * 16;  // this warp's first row in the query tile
  float lse2[2], dlt[2];     // rows g and g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + qr + g + 8 * r;
    const long long i = ((long long)b * H + h) * Sq + row;
    lse2[r] = row < Sq ? lse_base2(lse[i]) : INFINITY;
    dlt[r] = row < Sq ? delta[i] : 0.f;
  }

  uint32_t qf[T::kKSteps][4], dof[T::kKSteps][4];
  float acc[T::kND][4];
#pragma unroll
  for (int n = 0; n < T::kND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < n_tiles) {
      load_rows<D>(sK + (cur ^ 1) * T::kTile, kb, st.k_s, (j + 1) * kBwdBlock, Sk, tid);
      load_rows<D>(sV + (cur ^ 1) * T::kTile, vb, st.v_s, (j + 1) * kBwdBlock, Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < T::kKSteps; ++ks) {
        load_a_frag(qf[ks], sQ, T::kStride, qr, ks, g, t);
        load_a_frag(dof[ks], sDO, T::kStride, qr, ks, g, t);
      }
    }
    const bf16* sKc = sK + cur * T::kTile;
    const bf16* sVc = sV + cur * T::kTile;

    // s = q k^T and dp = dO v^T for this warp's 16 rows x 64 keys.
    float s[kBwdBlock / 8][4], dp[kBwdBlock / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBwdBlock / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < T::kKSteps; ++ks) {
        uint32_t bf[2];
        load_bt_frag(bf, sKc, T::kStride, nt * 8, ks, g, t);
        mma_16816(s[nt], qf[ks], bf);
        load_bt_frag(bf, sVc, T::kStride, nt * 8, ks, g, t);
        mma_16816(dp[nt], dof[ks], bf);
      }
    }

    // ds = p * (dp - delta); element e sits at row g + 8 * (e >> 1) and key
    // 64 * j + 8 * nt + 2 * t + (e & 1).
    const int key0 = j * kBwdBlock;
#pragma unroll
    for (int nt = 0; nt < kBwdBlock / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nt * 8 + 2 * t + (e & 1);
        const float p = key < Sk ? exp2f(s[nt][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dlt[e >> 1]);
      }
    }

    // dq += ds k: ds (bf16) is the A operand of four k-steps of 16 keys;
    // k's B fragments come transposed via ldmatrix.
#pragma unroll
    for (int kk = 0; kk < kBwdBlock / 16; ++kk) {
      uint32_t a[4];
      acc_to_a_frag(a, s[2 * kk], s[2 * kk + 1]);
      const bf16* krow = sKc + (kk * 16 + (lane & 15)) * T::kStride;
#pragma unroll
      for (int n = 0; n < T::kND; ++n) {
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, krow + n * 8);
        mma_16816(acc[n], a, bf);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + qr + g + 8 * r;
    if (row >= Sq) continue;
    bf16* out = dq + b * st.dq_b + (long long)row * st.dq_s + h * st.dq_h;
#pragma unroll
    for (int n = 0; n < T::kND; ++n) {
      *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
    }
  }
}

template <int D>
__device__ __forceinline__ void attn_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H,
                              BwdStrides st, float scale, float scale_log2) {
  using T = BwdTile<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + T::kTile;
  bf16* sQ = sV + T::kTile;        // two buffers
  bf16* sDO = sQ + 2 * T::kTile;   // two buffers
  float* sL = reinterpret_cast<float*>(sDO + 2 * T::kTile);  // [2][64] base-2 lse
  float* sD = sL + 2 * kBwdBlock;                              // [2][64] delta

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBwdBlock;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q + b * st.q_b + h * st.q_h;
  const bf16* kb = k + b * st.k_b + h * st.k_h;
  const bf16* vb = v + b * st.v_b + h * st.v_h;
  const bf16* dob = dout + b * st.do_b + h * st.do_h;
  const float* lseb = lse + ((long long)b * H + h) * Sq;
  const float* deltab = delta + ((long long)b * H + h) * Sq;

  zero_pad<D>(sK, 6 * kBwdBlock, tid);

  // Query rows at or past Sq: q, dO zero-filled, lse +inf (p = 0), delta 0.
  auto load_q_tile = [&](int buf, int row0) {
    load_rows<D>(sQ + buf * T::kTile, qb, st.q_s, row0, Sq, tid);
    load_rows<D>(sDO + buf * T::kTile, dob, st.do_s, row0, Sq, tid);
    if (tid < kBwdBlock) {
      const int row = row0 + tid;
      sL[buf * kBwdBlock + tid] = row < Sq ? lse_base2(lseb[row]) : INFINITY;
      sD[buf * kBwdBlock + tid] = row < Sq ? deltab[row] : 0.f;
    }
  };

  const int m_tiles = (Sq + kBwdBlock - 1) / kBwdBlock;
  load_rows<D>(sK, kb, st.k_s, n0, Sk, tid);
  load_rows<D>(sV, vb, st.v_s, n0, Sk, tid);
  if (m_tiles > 0) load_q_tile(0, 0);
  cp_async_commit();

  const int kr = warp * 16;  // this warp's first key in the key tile
  float acc_dk[T::kND][4], acc_dv[T::kND][4];
#pragma unroll
  for (int n = 0; n < T::kND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;
  }

  for (int i = 0; i < m_tiles; ++i) {
    const int cur = i & 1;
    if (i + 1 < m_tiles) {
      load_q_tile(cur ^ 1, (i + 1) * kBwdBlock);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const bf16* sQc = sQ + cur * T::kTile;
    const bf16* sDOc = sDO + cur * T::kTile;
    const float* sLc = sL + cur * kBwdBlock;
    const float* sDc = sD + cur * kBwdBlock;

    // s^T = k q^T and dp^T = v dO^T for this warp's 16 keys x 64 queries.
    float s[kBwdBlock / 8][4], dp[kBwdBlock / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBwdBlock / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < T::kKSteps; ++ks) {
      uint32_t kf[4], vf[4];
      load_a_frag(kf, sK, T::kStride, kr, ks, g, t);
      load_a_frag(vf, sV, T::kStride, kr, ks, g, t);
#pragma unroll
      for (int nt = 0; nt < kBwdBlock / 8; ++nt) {
        uint32_t bf[2];
        load_bt_frag(bf, sQc, T::kStride, nt * 8, ks, g, t);
        mma_16816(s[nt], kf, bf);
        load_bt_frag(bf, sDOc, T::kStride, nt * 8, ks, g, t);
        mma_16816(dp[nt], vf, bf);
      }
    }

    // p^T and ds^T; element e sits at key kr + g + 8 * (e >> 1) and query
    // (in the tile) 8 * nt + 2 * t + (e & 1).
#pragma unroll
    for (int nt = 0; nt < kBwdBlock / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * t + (e & 1);
        const float p = exp2f(s[nt][e] * scale_log2 - sLc[qc]);
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - sDc[qc]);
      }
    }

    // dv += p^T dO and dk += ds^T q over four k-steps of 16 queries; dO's
    // and q's B fragments come transposed via ldmatrix.
#pragma unroll
    for (int kk = 0; kk < kBwdBlock / 16; ++kk) {
      uint32_t ap[4], ads[4];
      acc_to_a_frag(ap, s[2 * kk], s[2 * kk + 1]);
      acc_to_a_frag(ads, dp[2 * kk], dp[2 * kk + 1]);
      const int row = (kk * 16 + (lane & 15)) * T::kStride;
#pragma unroll
      for (int n = 0; n < T::kND; ++n) {
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, sDOc + row + n * 8);
        mma_16816(acc_dv[n], ap, bf);
        ldmatrix_x2_trans(bf, sQc + row + n * 8);
        mma_16816(acc_dk[n], ads, bf);
      }
    }
    __syncthreads();  // the next iteration's prefetch overwrites this buffer
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = n0 + kr + g + 8 * r;
    if (key >= Sk) continue;
    const long long off = b * st.dkv_b + (long long)key * st.dkv_s + h * st.dkv_h;
#pragma unroll
    for (int n = 0; n < T::kND; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + n * 8 + 2 * t) =
          pack_bf16(acc_dk[n][2 * r] * scale, acc_dk[n][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + n * 8 + 2 * t) =
          pack_bf16(acc_dv[n][2 * r], acc_dv[n][2 * r + 1]);
    }
  }
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

// Launch a dq kernel pair (bf16 kernel on grid (ceil(Sq / 64), H, B) with
// BwdTile<D>::kSmemBytes of dynamic shared memory, fp32 kernel with static
// shared memory) for `dtype` (0 = float32, 1 = bfloat16).
template <int D, typename KBf16, typename KF32>
cudaError_t launch_bwd_dq(KBf16 kbf16, KF32 kf32, int dtype, const BwdArgs& a) {
  if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(kbf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           BwdTile<D>::kSmemBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sq + kBwdBlock - 1) / kBwdBlock, a.H, a.B);
    kbf16<<<grid, kBwdThreads, BwdTile<D>::kSmemBytes, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
        static_cast<bf16*>(a.dq), a.Sq, a.Sk, a.H, a.st, a.scale, a.scale_log2);
  } else {
    const dim3 g32((a.Sq + kBwdF32Rows - 1) / kBwdF32Rows, a.H, a.B);
    kf32<<<g32, kBwdF32Rows, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        static_cast<float*>(a.dq), a.Sq, a.Sk, a.H, a.st, a.scale, a.scale_log2);
  }
  return cudaGetLastError();
}

// The same for a dk/dv kernel pair, on grid (ceil(Sk / 64), H, B).
template <int D, typename KBf16, typename KF32>
cudaError_t launch_bwd_dkv(KBf16 kbf16, KF32 kf32, int dtype, const BwdArgs& a) {
  if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(kbf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           BwdTile<D>::kSmemBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sk + kBwdBlock - 1) / kBwdBlock, a.H, a.B);
    kbf16<<<grid, kBwdThreads, BwdTile<D>::kSmemBytes, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
        static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.Sq, a.Sk, a.H, a.st, a.scale,
        a.scale_log2);
  } else {
    const dim3 g32((a.Sk + kBwdF32Rows - 1) / kBwdF32Rows, a.H, a.B);
    kf32<<<g32, kBwdF32Rows, 0, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.Sq, a.Sk, a.H, a.st, a.scale,
        a.scale_log2);
  }
  return cudaGetLastError();
}

// Declares the four __global__ kernels of one backward (PREFIX##_dq_bf16_kernel,
// PREFIX##_dq_f32_kernel, PREFIX##_dkv_bf16_kernel, PREFIX##_dkv_f32_kernel),
// each a thin wrapper of the bodies above, so that every TPU kernel ported
// onto them keeps kernels of its own name.
#define IVT_BWD_KERNELS(PREFIX)                                                                 \
  template <int D>                                                                            \
  __global__ void __launch_bounds__(kBwdThreads) PREFIX##_dq_bf16_kernel(                     \
      const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,    \
      const bf16* __restrict__ dout, const float* __restrict__ lse,                          \
      const float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk, int H,          \
      BwdStrides st, float scale, float scale_log2) {                                        \
    attn_bwd_dq_bf16<D>(q, k, v, dout, lse, delta, dq, Sq, Sk, H, st, scale, scale_log2);    \
  }                                                                                          \
  template <int D>                                                                            \
  __global__ void __launch_bounds__(kBwdF32Rows) PREFIX##_dq_f32_kernel(                      \
      const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, \
      const float* __restrict__ dout, const float* __restrict__ lse,                         \
      const float* __restrict__ delta, float* __restrict__ dq, int Sq, int Sk, int H,         \
      BwdStrides st, float scale, float scale_log2) {                                        \
    attn_bwd_dq_f32<D>(q, k, v, dout, lse, delta, dq, Sq, Sk, H, st, scale, scale_log2);     \
  }                                                                                          \
  template <int D>                                                                            \
  __global__ void __launch_bounds__(kBwdThreads) PREFIX##_dkv_bf16_kernel(                    \
      const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,    \
      const bf16* __restrict__ dout, const float* __restrict__ lse,                          \
      const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,  \
      int Sk, int H, BwdStrides st, float scale, float scale_log2) {                         \
    attn_bwd_dkv_bf16<D>(q, k, v, dout, lse, delta, dk, dv, Sq, Sk, H, st, scale,           \
                         scale_log2);                                                        \
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
