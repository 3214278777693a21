// Flash-attention backward, dq kernel, for the causal / narrow-v /
// segmented case (K5 backward + K8) on Hopper (sm_90a): the gradient of the
// M2LA LLM's training attention, q/k at d_qk = nope + rope (256 on
// qwen3_8b_mla) and v/dO at d_v = 128, causal, with packed-sequence segment
// ids, inputs in (B, S, H, D) with any element strides.
//
// Replaces internvideo_tpu/ops/flash_attention.py:468 `_bwd_dq_kernel` as
// `_bwd` (:782) drives it on its causal / segmented remap path (:830-908,
// :1009): dq = scale * sum_j ds_ij k_j with p = exp(s - lse) recomputed from
// the forward's LSE, dp = dO v^T (over d_v), ds = p * (dp - delta), delta =
// rowsum(dO * O) over d_v minus the LSE cotangent (computed by the wrapper,
// as `_bwd` :792-797 does). Query row i sees key j iff j <= i + q_off
// (causal) and q_seg[i] == kv_seg[j] (segments). The companion dk/dv kernel
// is flash_bwd_causal_dkv.cu; as in the JAX package the two run without
// atomics.
//
// Grouped-query heads and the sliding window (the dense-GQA LLM's training
// attention, qwen3_8b_dense at (128, 128); `_bwd(group=, window=)` :782-785,
// the K/V index maps `h // group`): the CTA of q head h reads K/V head
// h / group through the K/V strides, so K/V are never repeated in memory.
// With window > 0 query position p = i + q_off sees key j only if
// p - j < window, and without causal also j - p < window (`_mask_block`
// :40-68). Key tiles outside the band of the CTA's rows are never loaded
// (band_keys in causal_bwd.cuh: from m0 + q_off - window + 1, and without
// causal up to row_end - 1 + q_off + window); a tile that crosses an edge of
// the band is masked per element. A row that sees no key (LSE -inf) gets
// p = 0, so dq = 0.
//
// What does not carry over: the TPU kernel remaps dead (q block, k block)
// pairs' DMAs with a scalar-prefetched table. Here each CTA (one 64-query
// tile) walks its key tiles and skips, before loading it, a tile above the
// causal diagonal (the loop ends at the last visible key) or one whose
// segment range misses the query tile's (segments.cuh). Tiles that cross the
// diagonal, the Sk tail or hold segments are masked element by element.
//
// Registers: at d_qk = 256 the fp32 dq accumulator of a warp's 16 rows is
// 128 registers a thread. So the streamed K/V tiles are 32 keys (s and dp
// then take 32 more), and the A fragments of q and dO are read from shared
// memory at every k-step instead of being held (they would take 96).
//
// What bounds it: 2 * S_vis * (2 d_qk + d_v) operations per (row, head)
// over the visible keys S_vis, against reading q, k, v, dO once: the tensor
// cores and the exp2 between the products, not device memory.
//
// Design (right and simple first): one CTA per (64-query tile, head,
// batch), the last query tiles (the most key tiles) launched first; 4 warps
// of 16 rows on mma.sync.m16n8k16 (bf16 in, fp32 accumulate); K (d_qk) and V
// (d_v) tiles double-buffered with cp.async; ds (rounded to bf16, as the JAX
// kernel rounds it to k's dtype) becomes the A operand of ds k in registers,
// k's B fragments come transposed via ldmatrix. fp32 inputs take a CUDA-core
// kernel (the parity checks, not the bf16 main path). wgmma, TMA and warp
// specialisation are later work.

#include "causal_bwd.cuh"

namespace {

using namespace ivt;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;     // query rows per CTA (4 warps x 16)
constexpr int kKeys = 32;     // keys per streamed K/V tile
constexpr int kThreads = 128;

template <int DQK, int DV>
struct DqTile {
  static_assert(DQK % 16 == 0 && DV % 16 == 0, "head dims must be multiples of 16");
  static constexpr int kQStride = DQK + 8;  // smem row: +16 B avoids bank conflicts
  static constexpr int kVStride = DV + 8;
  static constexpr int kQ = kRows * kQStride;   // q tile
  static constexpr int kDO = kRows * kVStride;  // dO tile
  static constexpr int kK = kKeys * kQStride;   // one K buffer
  static constexpr int kV = kKeys * kVStride;   // one V buffer
  // q, dO, two K and two V buffers, the key tile's segment ids
  static constexpr int kSmemBytes = (kQ + kDO + 2 * (kK + kV)) * 2 + kKeys * 4;
};

template <int DQK, int DV, bool kSeg>
__global__ void __launch_bounds__(kThreads) causal_bwd_dq_bf16_kernel(const CausalBwdArgs a) {
  using T = DqTile<DQK, DV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + T::kQ;
  bf16* sK = sDO + T::kDO;    // two buffers
  bf16* sV = sK + 2 * T::kK;  // two buffers
  int* sKS = reinterpret_cast<int*>(sV + 2 * T::kV);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int Sq = a.Sq, Sk = a.Sk;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_b + h * a.q_h;
  const int hk = h / a.group;  // GQA: the group's K/V head
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_b + hk * a.k_h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_b + hk * a.v_h;
  const bf16* dob = static_cast<const bf16*>(a.dout) + b * a.do_b + h * a.do_h;
  const int qr = warp * 16;  // this warp's first row in the query tile

  // Key tiles [lo / kKeys, n_tiles) hold every key a row of this tile sees.
  const int2 band = band_keys(a, m0, min(m0 + kRows, Sq));
  const int n_tiles = (band.y + kKeys - 1) / kKeys;
  // With a window: keys below band_lo_all are outside some row's band, and
  // (non-causal) so are keys at or above band_hi_all.
  const int band_lo_all = m0 + kRows + a.q_off - a.window;
  const int band_hi_all = m0 + a.q_off + a.window;

  int rows[2], qs[2] = {0, 0};
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = m0 + qr + g + 8 * r;
    const long long i = ((long long)b * a.H + h) * Sq + rows[r];
    lse2[r] = rows[r] < Sq ? lse_to_base2(a.lse[i]) : INFINITY;  // rows past Sq: p = 0
    dlt[r] = rows[r] < Sq ? a.delta[i] : 0.f;
  }
  const int* kvs = kSeg ? a.kv_seg + (long long)b * Sk : nullptr;
  int2 q_range = make_int2(INT_MIN, INT_MAX);
  if constexpr (kSeg) {
    const int* qsb = a.q_seg + (long long)b * Sq;
    q_range = seg_range(qsb, m0, kRows, Sq, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) qs[r] = rows[r] < Sq ? qsb[rows[r]] : INT_MIN;
  }
  auto next_tile = [&](int j) {
    if constexpr (kSeg) {
      while (j < n_tiles && !ranges_meet(seg_range(kvs, j * kKeys, kKeys, Sk, lane), q_range)) ++j;
    }
    return j;
  };
  auto load_kv = [&](int buf, int j) {
    cp_rows<DQK, kKeys, kThreads>(sK + buf * T::kK, T::kQStride, kb, a.k_s, j * kKeys, Sk, tid);
    cp_rows<DV, kKeys, kThreads>(sV + buf * T::kV, T::kVStride, vb, a.v_s, j * kKeys, Sk, tid);
  };

  int j = next_tile(band.x / kKeys);
  cp_rows<DQK, kRows, kThreads>(sQ, T::kQStride, qb, a.q_s, m0, Sq, tid);
  cp_rows<DV, kRows, kThreads>(sDO, T::kVStride, dob, a.do_s, m0, Sq, tid);
  if (j < n_tiles) load_kv(0, j);
  cp_async_commit();

  float acc[DQK / 8][4];
#pragma unroll
  for (int n = 0; n < DQK / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int cur = 0;
  while (j < n_tiles) {
    const int jn = next_tile(j + 1);
    if (jn < n_tiles) {
      load_kv(cur ^ 1, jn);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int key0 = j * kKeys;
    if constexpr (kSeg) {
      if (tid < kKeys) sKS[tid] = key0 + tid < Sk ? kvs[key0 + tid] : INT_MIN;
    }
    __syncthreads();
    const bf16* sKc = sK + cur * T::kK;
    const bf16* sVc = sV + cur * T::kV;

    // s = q k^T (over d_qk) and dp = dO v^T (over d_v), 16 rows x 32 keys.
    float s[kKeys / 8][4], dp[kKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll 4
    for (int ks = 0; ks < DQK / 16; ++ks) {
      uint32_t af[4];
      load_a_frag(af, sQ, T::kQStride, qr, ks, g, t);
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
        uint32_t bf[2];
        load_bt_frag(bf, sKc, T::kQStride, nt * 8, ks, g, t);
        mma_16816(s[nt], af, bf);
      }
    }
#pragma unroll 4
    for (int ks = 0; ks < DV / 16; ++ks) {
      uint32_t af[4];
      load_a_frag(af, sDO, T::kVStride, qr, ks, g, t);
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
        uint32_t bf[2];
        load_bt_frag(bf, sVc, T::kVStride, nt * 8, ks, g, t);
        mma_16816(dp[nt], af, bf);
      }
    }

    // ds = p * (dp - delta); element e sits at row g + 8 * (e >> 1) and key
    // key0 + 8 * nt + 2 * t + (e & 1). Only a tile that crosses the diagonal,
    // an edge of the window's band, the Sk tail or holds segments is masked.
    const bool masked =
        kSeg || key0 + kKeys > Sk || (a.causal && key0 + kKeys - 1 > m0 + a.q_off) ||
        (a.window > 0 && (key0 < band_lo_all || (!a.causal && key0 + kKeys > band_hi_all)));
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kc = nt * 8 + 2 * t + (e & 1), key = key0 + kc;
        bool ok = true;
        if (masked) {
          ok = key < Sk && band_sees(a, rows[r] + a.q_off, key) && !(kSeg && sKS[kc] != qs[r]);
        }
        const float p = ok ? exp2f(s[nt][e] * a.scale_log2 - lse2[r]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dlt[r]);
      }
    }

    // dq += ds k over two k-steps of 16 keys.
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t af[4];
      acc_to_a_frag(af, s[2 * kk], s[2 * kk + 1]);
      const bf16* krow = sKc + (kk * 16 + (lane & 15)) * T::kQStride;
#pragma unroll
      for (int n = 0; n < DQK / 8; ++n) {
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, krow + n * 8);
        mma_16816(acc[n], af, bf);
      }
    }
    __syncthreads();  // the next prefetch overwrites this buffer (and sKS)
    cur ^= 1;
    j = jn;
  }
  cp_async_wait<0>();

  bf16* dq = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Sq) continue;
    bf16* out = dq + b * a.dq_b + (long long)rows[r] * a.dq_s + h * a.dq_h;
#pragma unroll
    for (int n = 0; n < DQK / 8; ++n) {
      *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * r] * a.scale, acc[n][2 * r + 1] * a.scale);
    }
  }
}

// fp32: one thread per query row, K/V tiles of 16 keys in shared memory,
// CUDA-core FMAs; q and dO are read from global memory (L1) per key so that
// d_qk = 256 needs no register copy of them. Every key of the tile's band
// (band_keys) is tested (no segment tile skipping: the parity checks'
// kernel).
constexpr int kF32Rows = 64;
constexpr int kF32Keys = 16;

template <int DQK, int DV, bool kSeg>
__global__ void __launch_bounds__(kF32Rows) causal_bwd_dq_f32_kernel(const CausalBwdArgs a) {
  __shared__ float sK[kF32Keys][DQK];
  __shared__ float sV[kF32Keys][DV];
  __shared__ int sKS[kF32Keys];
  const int tid = threadIdx.x;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kF32Rows;
  const int row = m0 + tid;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Sq = a.Sq, Sk = a.Sk;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_b + (h / a.group) * a.k_h;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_b + (h / a.group) * a.v_h;
  const bool valid = row < Sq;
  const int r = valid ? row : 0;
  const float* qp = static_cast<const float*>(a.q) + b * a.q_b + (long long)r * a.q_s + h * a.q_h;
  const float* dop =
      static_cast<const float*>(a.dout) + b * a.do_b + (long long)r * a.do_s + h * a.do_h;
  const long long li = ((long long)b * a.H + h) * Sq + r;
  const float lse2 = valid ? lse_to_base2(a.lse[li]) : INFINITY;
  const float dlt = valid ? a.delta[li] : 0.f;
  const int qs = kSeg && valid ? a.q_seg[(long long)b * Sq + row] : 0;
  const int2 band = band_keys(a, m0, min(m0 + kF32Rows, Sq));

  float acc[DQK];
#pragma unroll
  for (int c = 0; c < DQK; ++c) acc[c] = 0.f;

  for (int k0 = band.x / kF32Keys * kF32Keys; k0 < band.y; k0 += kF32Keys) {
    __syncthreads();
    for (int i = tid; i < kF32Keys * DQK; i += kF32Rows) {
      const int j = i / DQK, c = i - j * DQK;
      sK[j][c] = k0 + j < Sk ? kb[(long long)(k0 + j) * a.k_s + c] : 0.f;
    }
    for (int i = tid; i < kF32Keys * DV; i += kF32Rows) {
      const int j = i / DV, c = i - j * DV;
      sV[j][c] = k0 + j < Sk ? vb[(long long)(k0 + j) * a.v_s + c] : 0.f;
    }
    if (kSeg && tid < kF32Keys) {
      sKS[tid] = k0 + tid < Sk ? a.kv_seg[(long long)b * Sk + k0 + tid] : INT_MIN;
    }
    __syncthreads();
    for (int j = 0; j < kF32Keys; ++j) {
      const int key = k0 + j;
      if (!valid || key >= Sk || !band_sees(a, row + a.q_off, key) || (kSeg && sKS[j] != qs))
        continue;
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < DQK; ++c) s = fmaf(qp[c], sK[j][c], s);
      for (int c = 0; c < DV; ++c) dp = fmaf(dop[c], sV[j][c], dp);
      const float ds = exp2f(s * a.scale_log2 - lse2) * (dp - dlt);
#pragma unroll
      for (int c = 0; c < DQK; ++c) acc[c] = fmaf(ds, sK[j][c], acc[c]);
    }
  }
  if (!valid) return;
  float* out = static_cast<float*>(a.dq) + b * a.dq_b + (long long)row * a.dq_s + h * a.dq_h;
#pragma unroll
  for (int c = 0; c < DQK; ++c) out[c] = acc[c] * a.scale;
}

template <int DQK, int DV, bool kSeg>
cudaError_t launch(int dtype, int B, const CausalBwdArgs& a, cudaStream_t stream) {
  if (dtype == 1) {
    auto kern = causal_bwd_dq_bf16_kernel<DQK, DV, kSeg>;
    const int smem = DqTile<DQK, DV>::kSmemBytes;
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3((a.Sq + kRows - 1) / kRows, a.H, B), kThreads, smem, stream>>>(a);
  } else {
    causal_bwd_dq_f32_kernel<DQK, DV, kSeg>
        <<<dim3((a.Sq + kF32Rows - 1) / kF32Rows, a.H, B), kF32Rows, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// C entry bound with ctypes (the same signature as ivt_flash_bwd_causal_dkv,
// flash_bwd_causal_dkv.cu). dtype: 0 = float32, 1 = bfloat16. q, k, dq are
// (B, S, H, Dqk), v and dO (B, S, H, Dv); `strides` holds 21 int64, the
// (batch, seq, head) element strides of q, k, v, dO, dq, dk, dv. lse
// (natural log) and delta are (B, H, Sq) fp32 contiguous; q_seg / kv_seg are
// (B, Sq) / (B, Sk) int32 contiguous or both null. H counts the q heads,
// Hkv the K/V heads (H a multiple of it: grouped-query attention); window
// <= 0 means none. Writes dq only (dk, dv are ignored). Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for an uninstantiated
// (Dqk, Dv) or dtype, or H not a multiple of Hkv); launches on `stream`;
// does not synchronise.
extern "C" int ivt_flash_bwd_causal_dq(int dtype, const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       const int* q_seg, const int* kv_seg, void* dq, void* dk,
                                       void* dv, int B, int Sq, int Sk, int H, int Dqk, int Dv,
                                       const long long* strides, float scale, int causal,
                                       int q_offset, int Hkv, int window, void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if ((q_seg == nullptr) != (kv_seg == nullptr)) return cudaErrorInvalidValue;
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  const CausalBwdArgs a =
      make_causal_bwd_args(q, k, v, dout, lse, delta, q_seg, kv_seg, dq, dk, dv, Sq, Sk, H,
                           strides, scale, causal, q_offset, H / Hkv, window);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool seg = q_seg != nullptr;
#define IVT_CASE(DQK, DV)                                                                   \
  if (Dqk == DQK && Dv == DV)                                                               \
    return seg ? launch<DQK, DV, true>(dtype, B, a, s) : launch<DQK, DV, false>(dtype, B, a, s);
  IVT_CASE(256, 128)
  IVT_CASE(128, 128)
  IVT_CASE(64, 64)
  IVT_CASE(64, 32)
  IVT_CASE(32, 32)
#undef IVT_CASE
  return cudaErrorInvalidValue;
}
