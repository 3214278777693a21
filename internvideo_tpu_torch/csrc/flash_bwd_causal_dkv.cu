// Flash-attention backward, dk/dv kernel, for the causal / narrow-v /
// segmented case (K5 backward + K8) on Hopper (sm_90a); the dq kernel and
// the design notes they share are in flash_bwd_causal_dq.cu.
//
// Replaces internvideo_tpu/ops/flash_attention.py:613 `_bwd_dkv_kernel` as
// `_bwd` (:782) drives it on its causal / segmented remap path (:830-908,
// :1009): for each key j, dv_j = sum_i p_ij dO_i and dk_j = scale * sum_i
// ds_ij q_i over the query rows i that see it.
//
// One CTA per (64-key tile, K/V head, batch, column part), the first key
// tiles (seen by the most queries under the causal mask) launched first; 4
// warps of 16 keys; q / dO tiles of 32 rows streamed, double-buffered with
// cp.async, with their base-2 LSE, delta and segment ids. A query tile below
// the causal diagonal's start (rows i < key0 - q_off), outside the window's
// band or whose segment range misses the key tile's is never loaded.
//
// Grouped-query heads (`_bwd(group=)`, the JAX grid's (q_head_in_group,
// q_block) inner dimension :919-940): the CTA of K/V head hk walks the q
// heads hk * group .. hk * group + group - 1 one after the other, and for
// each the query tiles whose band reaches its keys, accumulating dk / dv in
// fp32 registers across all of them and writing once. No atomics, no per-q-
// head dk buffer and a fixed order, so two calls give bit-identical dk / dv.
// LSE and delta (= rowsum(dO * O) - dLSE) are per q head. With a window the
// query rows that can see keys [n0, n0 + 64) are [n0 - q_off - window + 1
// (n0 - q_off with causal), n0 + 63 - q_off + window) clipped to [0, Sq)
// (band_rows in causal_bwd.cuh); tiles that cross an edge of the band are
// masked per element.
//
// Registers: at (d_qk, d_v) = (256, 128) a warp's fp32 dk and dv
// accumulators would be 192 registers a thread on top of the s / dp tiles.
// So the dk and dv columns are split in two parts, one per CTA (kSplit = 2:
// the grid's x dimension is key tiles x 2): each CTA recomputes the whole
// s^T = k q^T and dp^T = v dO^T for its keys and accumulates half the
// columns of dk and dv (64 + 32 registers). The recomputed products add half
// again to this kernel's operations at that width; the simpler alternative
// to a shared-memory exchange of p and ds between warps.
//
// What bounds it: 2 * S_vis * (2 d_qk + 2 d_v) operations per (key, head)
// (x 1.5 with the split), against reading q, k, v, dO once: the tensor cores
// and the exp2 between the products.

#include "causal_bwd.cuh"

namespace {

using namespace ivt;
using bf16 = __nv_bfloat16;

constexpr int kKeys = 64;     // keys per CTA (4 warps x 16)
constexpr int kRows = 32;     // query rows per streamed q / dO tile
constexpr int kThreads = 128;

template <int DQK, int DV>
struct DkvTile {
  static_assert(DQK % 16 == 0 && DV % 16 == 0, "head dims must be multiples of 16");
  static constexpr int kSplit = DQK >= 256 ? 2 : 1;  // column parts of dk / dv, one per CTA
  static constexpr int kDK = DQK / kSplit;            // dk columns a CTA accumulates
  static constexpr int kDV = DV / kSplit;             // dv columns a CTA accumulates
  static_assert(kDK % 8 == 0 && kDV % 8 == 0, "column parts must be whole n-tiles");
  static constexpr int kQStride = DQK + 8;  // smem row: +16 B avoids bank conflicts
  static constexpr int kVStride = DV + 8;
  static constexpr int kK = kKeys * kQStride;   // k tile
  static constexpr int kV = kKeys * kVStride;   // v tile
  static constexpr int kQ = kRows * kQStride;   // one q buffer
  static constexpr int kDO = kRows * kVStride;  // one dO buffer
  // k, v, two q and two dO buffers; two buffers each of base-2 LSE, delta
  // and query segment ids
  static constexpr int kSmemBytes = (kK + kV + 2 * (kQ + kDO)) * 2 + 3 * 2 * kRows * 4;
};

template <int DQK, int DV, bool kSeg>
__global__ void __launch_bounds__(kThreads) causal_bwd_dkv_bf16_kernel(const CausalBwdArgs a) {
  using T = DkvTile<DQK, DV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + T::kK;
  bf16* sQ = sV + T::kV;        // two buffers
  bf16* sDO = sQ + 2 * T::kQ;   // two buffers
  float* sL = reinterpret_cast<float*>(sDO + 2 * T::kDO);  // [2][kRows] base-2 lse
  float* sD = sL + 2 * kRows;                               // [2][kRows] delta
  int* sQS = reinterpret_cast<int*>(sD + 2 * kRows);        // [2][kRows] query segment ids

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = (blockIdx.x / T::kSplit) * kKeys;
  const int part = blockIdx.x % T::kSplit;
  const int hk = blockIdx.y, b = blockIdx.z;  // the K/V head
  const int Sq = a.Sq, Sk = a.Sk;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_b + hk * a.k_h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_b + hk * a.v_h;
  const int* qsb = kSeg ? a.q_seg + (long long)b * Sq : nullptr;
  const int kr = warp * 16;  // this warp's first key in the key tile

  int keys[2], ks_id[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) keys[r] = n0 + kr + g + 8 * r;
  int2 k_range = make_int2(INT_MIN, INT_MAX);
  if constexpr (kSeg) {
    const int* kvs = a.kv_seg + (long long)b * Sk;
    k_range = seg_range(kvs, n0, kKeys, Sk, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) ks_id[r] = keys[r] < Sk ? kvs[keys[r]] : INT_MIN;
  }
  // The CTA walks n_work = group x n_q (q head, query tile) steps: step w is
  // q head hk * group + w / n_q, query tile i_first + w % n_q, the tiles
  // holding the rows that can see a key of this tile.
  const int2 rows = band_rows(a, n0, min(n0 + kKeys, Sk));
  const int i_first = rows.x / kRows;
  const int n_q = rows.y > rows.x ? (rows.y + kRows - 1) / kRows - i_first : 0;
  const int n_work = a.group * n_q;
  auto row0_of = [&](int w) { return (i_first + w % n_q) * kRows; };
  auto next_tile = [&](int w) {
    if constexpr (kSeg) {
      while (w < n_work && !ranges_meet(seg_range(qsb, row0_of(w), kRows, Sq, lane), k_range)) ++w;
    }
    return w;
  };
  // Rows at or past Sq: q, dO zero-filled, lse +inf (p = 0), delta 0.
  auto load_q_tile = [&](int buf, int w) {
    const int row0 = row0_of(w);
    const int h = hk * a.group + w / n_q;  // the q head
    const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_b + h * a.q_h;
    const bf16* dob = static_cast<const bf16*>(a.dout) + b * a.do_b + h * a.do_h;
    const float* lseb = a.lse + ((long long)b * a.H + h) * Sq;
    const float* deltab = a.delta + ((long long)b * a.H + h) * Sq;
    cp_rows<DQK, kRows, kThreads>(sQ + buf * T::kQ, T::kQStride, qb, a.q_s, row0, Sq, tid);
    cp_rows<DV, kRows, kThreads>(sDO + buf * T::kDO, T::kVStride, dob, a.do_s, row0, Sq, tid);
    if (tid < kRows) {
      const int row = row0 + tid;
      sL[buf * kRows + tid] = row < Sq ? lse_to_base2(lseb[row]) : INFINITY;
      sD[buf * kRows + tid] = row < Sq ? deltab[row] : 0.f;
      if constexpr (kSeg) sQS[buf * kRows + tid] = row < Sq ? qsb[row] : INT_MIN;
    }
  };

  int w = next_tile(0);
  cp_rows<DQK, kKeys, kThreads>(sK, T::kQStride, kb, a.k_s, n0, Sk, tid);
  cp_rows<DV, kKeys, kThreads>(sV, T::kVStride, vb, a.v_s, n0, Sk, tid);
  if (w < n_work) load_q_tile(0, w);
  cp_async_commit();

  float acc_dk[T::kDK / 8][4], acc_dv[T::kDV / 8][4];
#pragma unroll
  for (int n = 0; n < T::kDK / 8; ++n) acc_dk[n][0] = acc_dk[n][1] = acc_dk[n][2] = acc_dk[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < T::kDV / 8; ++n) acc_dv[n][0] = acc_dv[n][1] = acc_dv[n][2] = acc_dv[n][3] = 0.f;

  int cur = 0;
  while (w < n_work) {
    const int wn = next_tile(w + 1);
    if (wn < n_work) {
      load_q_tile(cur ^ 1, wn);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sQc = sQ + cur * T::kQ;
    const bf16* sDOc = sDO + cur * T::kDO;
    const float* sLc = sL + cur * kRows;
    const float* sDc = sD + cur * kRows;
    const int* sQSc = sQS + cur * kRows;

    // s^T = k q^T (over d_qk) and dp^T = v dO^T (over d_v), 16 keys x 32 rows.
    float s[kRows / 8][4], dp[kRows / 8][4];
#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll 4
    for (int ks = 0; ks < DQK / 16; ++ks) {
      uint32_t af[4];
      load_a_frag(af, sK, T::kQStride, kr, ks, g, t);
#pragma unroll
      for (int nt = 0; nt < kRows / 8; ++nt) {
        uint32_t bf[2];
        load_bt_frag(bf, sQc, T::kQStride, nt * 8, ks, g, t);
        mma_16816(s[nt], af, bf);
      }
    }
#pragma unroll 4
    for (int ks = 0; ks < DV / 16; ++ks) {
      uint32_t af[4];
      load_a_frag(af, sV, T::kVStride, kr, ks, g, t);
#pragma unroll
      for (int nt = 0; nt < kRows / 8; ++nt) {
        uint32_t bf[2];
        load_bt_frag(bf, sDOc, T::kVStride, nt * 8, ks, g, t);
        mma_16816(dp[nt], af, bf);
      }
    }

    // p^T and ds^T; element e sits at key keys[e >> 1] and query row
    // q0 + 8 * nt + 2 * t + (e & 1). Rows past Sq have p = 0 through their
    // +inf LSE; keys past Sk are never stored. Only a pair that crosses the
    // diagonal or an edge of the window's band, or holds segments, is masked.
    const int q0 = row0_of(w);
    const bool masked =
        kSeg || (a.causal && n0 + kKeys - 1 > q0 + a.q_off) ||
        (a.window > 0 && (q0 + kRows - 1 + a.q_off - n0 >= a.window ||
                          (!a.causal && n0 + kKeys - 1 - q0 - a.q_off >= a.window)));
#pragma unroll
    for (int nt = 0; nt < kRows / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + 2 * t + (e & 1), r = e >> 1;
        bool ok = true;
        if (masked) {
          ok = band_sees(a, q0 + qc + a.q_off, keys[r]) && !(kSeg && sQSc[qc] != ks_id[r]);
        }
        const float p = ok ? exp2f(s[nt][e] * a.scale_log2 - sLc[qc]) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - sDc[qc]);
      }
    }

    // dv[:, part] += p^T dO[:, part] and dk[:, part] += ds^T q[:, part] over
    // two k-steps of 16 rows; dO's and q's B fragments come via ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t ap[4], ads[4];
      acc_to_a_frag(ap, s[2 * kk], s[2 * kk + 1]);
      acc_to_a_frag(ads, dp[2 * kk], dp[2 * kk + 1]);
      const int row = kk * 16 + (lane & 15);
      const bf16* dorow = sDOc + row * T::kVStride + part * T::kDV;
      const bf16* qrow = sQc + row * T::kQStride + part * T::kDK;
#pragma unroll
      for (int n = 0; n < T::kDV / 8; ++n) {
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, dorow + n * 8);
        mma_16816(acc_dv[n], ap, bf);
      }
#pragma unroll
      for (int n = 0; n < T::kDK / 8; ++n) {
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, qrow + n * 8);
        mma_16816(acc_dk[n], ads, bf);
      }
    }
    __syncthreads();  // the next prefetch overwrites this buffer
    cur ^= 1;
    w = wn;
  }
  cp_async_wait<0>();

  bf16* dk = static_cast<bf16*>(a.dk);
  bf16* dv = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= Sk) continue;
    bf16* kout = dk + b * a.dk_b + (long long)keys[r] * a.dk_s + hk * a.dk_h + part * T::kDK;
    bf16* vout = dv + b * a.dv_b + (long long)keys[r] * a.dv_s + hk * a.dv_h + part * T::kDV;
#pragma unroll
    for (int n = 0; n < T::kDK / 8; ++n) {
      *reinterpret_cast<uint32_t*>(kout + n * 8 + 2 * t) =
          pack_bf16(acc_dk[n][2 * r] * a.scale, acc_dk[n][2 * r + 1] * a.scale);
    }
#pragma unroll
    for (int n = 0; n < T::kDV / 8; ++n) {
      *reinterpret_cast<uint32_t*>(vout + n * 8 + 2 * t) =
          pack_bf16(acc_dv[n][2 * r], acc_dv[n][2 * r + 1]);
    }
  }
}

// fp32: one thread per key, q / dO tiles of 16 rows in shared memory,
// CUDA-core FMAs; k and v are read from global memory (L1) per row. For
// each q head of the group, every row of the key tile's band (band_rows) is
// tested (the parity checks' kernel).
constexpr int kF32Keys = 64;
constexpr int kF32Rows = 16;

template <int DQK, int DV, bool kSeg>
__global__ void __launch_bounds__(kF32Keys) causal_bwd_dkv_f32_kernel(const CausalBwdArgs a) {
  __shared__ float sQ[kF32Rows][DQK];
  __shared__ float sDO[kF32Rows][DV];
  __shared__ float sL[kF32Rows], sD[kF32Rows];
  __shared__ int sQS[kF32Rows];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kF32Keys;
  const int key = n0 + tid;
  const int hk = blockIdx.y, b = blockIdx.z;  // the K/V head
  const int Sq = a.Sq, Sk = a.Sk;
  const bool valid = key < Sk;
  const int r = valid ? key : 0;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_b + (long long)r * a.k_s + hk * a.k_h;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_b + (long long)r * a.v_s + hk * a.v_h;
  const int ks_id = kSeg && valid ? a.kv_seg[(long long)b * Sk + key] : 0;
  const int2 rows = band_rows(a, n0, min(n0 + kF32Keys, Sk));
  const int n_chunks = (rows.y - rows.x + kF32Rows - 1) / kF32Rows;

  float ak[DQK], av[DV];
#pragma unroll
  for (int c = 0; c < DQK; ++c) ak[c] = 0.f;
#pragma unroll
  for (int c = 0; c < DV; ++c) av[c] = 0.f;

  for (int step = 0; step < a.group * n_chunks; ++step) {  // (q head, 16-row chunk)
    const int h = hk * a.group + step / n_chunks;
    const int q0 = rows.x + (step % n_chunks) * kF32Rows;
    const int n = min(kF32Rows, rows.y - q0);
    const float* qb = static_cast<const float*>(a.q) + b * a.q_b + h * a.q_h;
    const float* dob = static_cast<const float*>(a.dout) + b * a.do_b + h * a.do_h;
    const long long lrow = ((long long)b * a.H + h) * Sq;
    __syncthreads();
    for (int i = tid; i < kF32Rows * DQK; i += kF32Keys) {
      const int j = i / DQK, c = i - j * DQK;
      sQ[j][c] = q0 + j < Sq ? qb[(long long)(q0 + j) * a.q_s + c] : 0.f;
    }
    for (int i = tid; i < kF32Rows * DV; i += kF32Keys) {
      const int j = i / DV, c = i - j * DV;
      sDO[j][c] = q0 + j < Sq ? dob[(long long)(q0 + j) * a.do_s + c] : 0.f;
    }
    if (tid < kF32Rows) {
      const bool ok = q0 + tid < Sq;
      sL[tid] = ok ? lse_to_base2(a.lse[lrow + q0 + tid]) : INFINITY;
      sD[tid] = ok ? a.delta[lrow + q0 + tid] : 0.f;
      if (kSeg) sQS[tid] = ok ? a.q_seg[(long long)b * Sq + q0 + tid] : INT_MIN;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      if (!valid || !band_sees(a, q0 + j + a.q_off, key) || (kSeg && sQS[j] != ks_id)) continue;
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < DQK; ++c) s = fmaf(kp[c], sQ[j][c], s);
      for (int c = 0; c < DV; ++c) dp = fmaf(vp[c], sDO[j][c], dp);
      const float p = exp2f(s * a.scale_log2 - sL[j]);
      const float ds = p * (dp - sD[j]);
#pragma unroll
      for (int c = 0; c < DV; ++c) av[c] = fmaf(p, sDO[j][c], av[c]);
#pragma unroll
      for (int c = 0; c < DQK; ++c) ak[c] = fmaf(ds, sQ[j][c], ak[c]);
    }
  }
  if (!valid) return;
  float* kout = static_cast<float*>(a.dk) + b * a.dk_b + (long long)key * a.dk_s + hk * a.dk_h;
  float* vout = static_cast<float*>(a.dv) + b * a.dv_b + (long long)key * a.dv_s + hk * a.dv_h;
#pragma unroll
  for (int c = 0; c < DQK; ++c) kout[c] = ak[c] * a.scale;
#pragma unroll
  for (int c = 0; c < DV; ++c) vout[c] = av[c];
}

template <int DQK, int DV, bool kSeg>
cudaError_t launch(int dtype, int B, const CausalBwdArgs& a, cudaStream_t stream) {
  if (dtype == 1) {
    using T = DkvTile<DQK, DV>;
    auto kern = causal_bwd_dkv_bf16_kernel<DQK, DV, kSeg>;
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Sk + kKeys - 1) / kKeys * T::kSplit, a.H / a.group, B);
    kern<<<grid, kThreads, T::kSmemBytes, stream>>>(a);
  } else {
    causal_bwd_dkv_f32_kernel<DQK, DV, kSeg>
        <<<dim3((a.Sk + kF32Keys - 1) / kF32Keys, a.H / a.group, B), kF32Keys, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// C entry bound with ctypes, with the signature of ivt_flash_bwd_causal_dq
// (flash_bwd_causal_dq.cu); writes dk and dv of the Hkv K/V heads (dq is
// ignored). Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for an uninstantiated
// (Dqk, Dv) or dtype); launches on `stream`; does not synchronise.
extern "C" int ivt_flash_bwd_causal_dkv(int dtype, const void* q, const void* k, const void* v,
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
