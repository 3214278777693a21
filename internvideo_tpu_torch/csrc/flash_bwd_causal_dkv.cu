// Flash-attention backward, dk/dv kernel, for the causal / narrow-v /
// segmented / grouped-query / windowed case (K5 backward + K8) on Hopper
// (sm_90a); the dq kernel and the design notes they share are in
// flash_bwd_causal_dq.cu.
//
// Replaces internvideo_tpu/ops/flash_attention.py:613 `_bwd_dkv_kernel` as
// `_bwd` (:782) drives it on its causal / segmented remap path (:830-908,
// :1009): for each key j, dv_j = sum_i p_ij dO_i and dk_j = scale * sum_i
// ds_ij q_i over the query rows i that see it.
//
// Grouped-query heads (`_bwd(group=)`, the JAX grid's (q_head_in_group,
// q_block) inner dimension :919-940): the CTA of K/V head hk walks the q
// heads hk * group .. hk * group + group - 1 one after the other, and for
// each the 64-row query tiles whose band reaches its keys (band_rows),
// accumulating dk / dv in fp32 registers across all of them and writing
// once. No atomics, no per-q-head dk buffer and a fixed order, so two calls
// give bit-identical dk / dv. LSE and delta (= rowsum(dO * O) - dLSE) are
// per q head.
//
// What bounds it: 2 * S_vis * (2 d_qk + 2 d_v) tensor-core operations per
// (key, head), against reading q, k, v, dO once: operations, with the exp2
// between the products.
//
// Design (on hopper.cuh, as the dq kernel): one CTA of three warpgroups per
// (key tile, K/V head, batch), the first key tiles (seen by the most rows
// under the causal mask) launched first.
// - A producer warp loads the CTA's K and V once by TMA, before it walks
//   the (q head, query tile) steps, then fills a ring of q + dO stages; its
//   lanes write each step's base-2 LSE, delta and query segment ids beside
//   the stage (loaded one step ahead, while the ring is full). It alone
//   decides each step's skip (segment ranges, 32 steps at a time:
//   segments.cuh) and hands the step's first row to the consumers; -1 ends
//   the walk.
// - The products are transposed so that P^T and dS^T come out in the
//   accumulator layout that is wgmma's A-fragment layout: S^T = K Q^T and
//   dP^T = V dO^T (both operands K-major in shared memory), then dV += P^T dO
//   and dK += dS^T Q with q / dO read MN-major through the transpose bit.
// - d_qk 64 / 32 (kShare false): 128 keys a CTA, 64 per consumer
//   warpgroup, each holding dk and dv of its keys in registers, with P^T and
//   dS^T as bf16 A fragments in registers (the RS form). A warpgroup skips
//   a step none of its keys sees.
// - d_qk 256 and 128 (kShare): dk 128 + dv 64 registers (64 + 64 at (128,
//   128)) beside S^T and dP^T spilled (116-460 bytes in ptxas). 64 keys a
//   CTA: each warpgroup computes S^T and dP^T for half the step's 64 rows
//   (m64n32k16), writes its P^T and dS^T in bf16 to a swizzled shared tile
//   (two buffers, so one named barrier a step orders both writes before
//   both reads), and accumulates half of dk's and of dv's columns from the
//   whole tile (A from shared memory). P^T and dS^T are computed once,
//   where the earlier mma.sync kernel recomputed them in two CTAs at d_qk
//   256 (1.5 x its operations).
// - Masks: per key the kept rows of a step are one interval of the
//   compile-time column (causal, window, Sq tail), two integer compares an
//   element (plus the id equality with segments); only steps that straddle
//   the diagonal, a band edge or the Sq tail, or carry segments, are masked.
// TMA zero-fills rows past Sq / Sk; keys past Sk are not stored.

#include "causal_bwd.cuh"

namespace {

using namespace ivt;
namespace hp = ivt::hopper;
using bf16 = __nv_bfloat16;

constexpr int kBlockM = 64;  // query rows per streamed q / dO stage

template <int DQK, int DV>
struct DkvTile {
  static_assert(DQK % 32 == 0 && DV % 32 == 0, "head dims must be multiples of 32");
  static constexpr bool kShare = DQK >= 128;  // P^T / dS^T through shared memory
  static_assert(!kShare || (DQK % 128 == 0 && DV % 128 == 0),
                "the column halves must be whole 64-column panels");
  static constexpr int kKeys = kShare ? 64 : 128;  // keys per CTA
  static constexpr int kStages = DQK > 128 ? 2 : 4;
  static constexpr int kDK = kShare ? DQK / 2 : DQK;  // dk columns a warpgroup accumulates
  static constexpr int kDV = kShare ? DV / 2 : DV;
  static constexpr int kQCols = DQK < 64 ? DQK : 64;  // columns of a panel (one TMA box)
  static constexpr int kVCols = DV < 64 ? DV : 64;
  static constexpr int kQRow = 2 * kQCols;  // bytes of a panel row = the swizzle span
  static constexpr int kVRow = 2 * kVCols;
  static constexpr int kKBytes = kKeys * DQK * 2;
  static constexpr int kVBytes = kKeys * DV * 2;
  static constexpr int kQBytes = kBlockM * DQK * 2;
  static constexpr int kDOBytes = kBlockM * DV * 2;
  static constexpr int kPBytes = kShare ? kKeys * kBlockM * 2 : 0;  // one bf16 P^T or dS^T tile
  // From a 1024-byte boundary: K, V, each stage's q, each stage's dO, two
  // buffers of [P^T | dS^T], each stage's [lse2 | delta | q ids] rows,
  // each stage's first row, then the barriers.
  static constexpr int kVOff = kKBytes;
  static constexpr int kQOff = kVOff + kVBytes;
  static constexpr int kDOOff = kQOff + kStages * kQBytes;
  static constexpr int kPOff = kDOOff + kStages * kDOBytes;
  static constexpr int kRowOff = kPOff + 4 * kPBytes;
  static constexpr int kInfoOff = kRowOff + kStages * 3 * kBlockM * 4;
  static constexpr int kBarOff = (kInfoOff + kStages * 4 + 7) / 8 * 8;
  static constexpr int kSmemBytes = kBarOff + (2 * kStages + 1) * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "over the 227 KB a CTA may use");
};

// The kept rows of a step for key `key`, relative to the thread's column
// base row0 + 2 t: [lo, hi] (causal, window, Sq tail; segments apart).
__device__ __forceinline__ int2 kept_rows(const CausalBwdArgs& a, int key, int base) {
  int lo = INT_MIN, hi = a.Sq - 1 - base;
  const int rel = key - a.q_off - base;  // the row whose position is the key
  if (a.causal) lo = rel;
  if (a.window > 0) {
    hi = min(hi, rel + a.window - 1);
    if (!a.causal) lo = rel - a.window + 1;
  }
  return make_int2(lo, hi);
}

// P^T and dS^T of NT 8-row n-tiles in place: s (S^T) becomes p, dp (dP^T)
// becomes ds = p (dp - delta). Element e of n-tile nt sits at key row
// g + 8 (e >> 1) and column c = col0 + 8 nt + (e & 1) past the base; L, D,
// QS are the step's lse2 / delta / ids from the base.
template <int NT, bool kSeg>
__device__ __forceinline__ void p_and_ds(float (&s)[4 * NT], float (&dp)[4 * NT], int col0,
                                         bool masked, const int2 (&kept)[2], const int (&ks)[2],
                                         const float* L, const float* D, const int* QS,
                                         float scale_log2) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = col0 + 8 * nt + (e & 1), r = e >> 1;
      float p = exp2f(s[4 * nt + e] * scale_log2 - L[c]);
      if (masked && (c < kept[r].x || c > kept[r].y || (kSeg && QS[c] != ks[r]))) p = 0.f;
      s[4 * nt + e] = p;
      dp[4 * nt + e] = p * (dp[4 * nt + e] - D[c]);
    }
  }
}

template <int DQK, int DV, bool kSeg>
__global__ void __launch_bounds__(kBwdThreads, 1)
    causal_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap do_map,
                               const CausalBwdArgs a) {
  using T = DkvTile<DQK, DV>;
  constexpr int kKeys = T::kKeys, kStages = T::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sK = smem;  // panels of kKeys rows
  unsigned char* sV = smem + T::kVOff;
  unsigned char* sQ = smem + T::kQOff;  // stage s at s * kQBytes, panels of kBlockM rows
  unsigned char* sDO = smem + T::kDOOff;
  unsigned char* sP = smem + T::kPOff;  // [buffer][P^T | dS^T] (kShare)
  float* sRow = reinterpret_cast<float*>(smem + T::kRowOff);  // [stage][lse2 | delta | ids]
  int* sInfo = reinterpret_cast<int*>(smem + T::kInfoOff);    // [stage]: first row, -1 = the end
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBarOff);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kKeys;  // the first key tiles (the most rows) first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int Sq = a.Sq, Sk = a.Sk;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 32);  // every producer lane (lane 0 with the bytes)
      hp::mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    hp::mbar_init(kv_full, 1);
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    // Producer warpgroup: warp 0 walks the (q head, query tile) steps.
    hp::setmaxnreg_dec<kBwdProducerRegs>();
    if (warp != 0) return;
    // Step w is q head hk * group + w / n_q, query tile i_first + w % n_q:
    // the tiles holding the rows that can see a key of this CTA.
    const int2 rows = band_rows(a, n0, min(n0 + kKeys, Sk));
    const int i_first = rows.x / kBlockM;
    const int n_q = rows.y > rows.x ? (rows.y + kBlockM - 1) / kBlockM - i_first : 0;
    const int n_work = a.group * n_q;
    const int* qsb = kSeg ? a.q_seg + (long long)b * Sq : nullptr;
    int2 k_range = make_int2(INT_MIN, INT_MAX);
    if constexpr (kSeg) k_range = seg_range(a.kv_seg + (long long)b * Sk, n0, kKeys, Sk, lane);
    auto row0_of = [&](int w) { return (i_first + w % n_q) * kBlockM; };
    int win = INT_MIN;  // the window of 32 steps whose skip tests `meets` holds
    unsigned meets = 0;
    auto next_step = [&](int w) {
      if constexpr (kSeg) {
        w = next_meeting(w, n_work, win, meets, lane, [&](int ww) {
          return ranges_meet(ids_range(qsb, row0_of(ww), kBlockM, Sq), k_range);
        });
      }
      return w;
    };
    // The next step's lse2 / delta / ids of rows lane and lane + 32, loaded
    // while the ring is full.
    float rl[2], rd[2];
    int ri[2];
    auto load_rows = [&](int w) {
      const int row0 = row0_of(w);
      const long long base = ((long long)b * a.H + hk * a.group + w / n_q) * Sq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + lane + 32 * r;
        const bool ok = row < Sq;
        rl[r] = ok ? lse_to_base2(a.lse[base + row]) : INFINITY;  // rows past Sq: p = 0
        rd[r] = ok ? a.delta[base + row] : 0.f;
        if constexpr (kSeg) ri[r] = ok ? qsb[row] : INT_MIN;
      }
    };
    if (lane == 0) {
      hp::prefetch_map(&q_map);
      hp::prefetch_map(&k_map);
      hp::prefetch_map(&v_map);
      hp::prefetch_map(&do_map);
      hp::mbar_arrive_expect_tx(kv_full, T::kKBytes + T::kVBytes);
#pragma unroll
      for (int p = 0; p < DQK / T::kQCols; ++p)
        hp::tma_load_4d(sK + p * kKeys * T::kQRow, &k_map, kv_full, p * T::kQCols, n0, hk, b);
#pragma unroll
      for (int p = 0; p < DV / T::kVCols; ++p)
        hp::tma_load_4d(sV + p * kKeys * T::kVRow, &v_map, kv_full, p * T::kVCols, n0, hk, b);
    }
    int w = next_step(0);
    if (w < n_work) load_rows(w);
    int stage = 0;
    unsigned phase = 0;
    while (true) {
      hp::mbar_wait(&empty[stage], phase ^ 1);
      const bool more = w < n_work;
      const int row0 = more ? row0_of(w) : 0;
      const int h = hk * a.group + (more ? w / n_q : 0);  // the q head
      if (more) {
        float* rs = sRow + stage * 3 * kBlockM;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rs[lane + 32 * r] = rl[r];
          rs[kBlockM + lane + 32 * r] = rd[r];
          if constexpr (kSeg) reinterpret_cast<int*>(rs)[2 * kBlockM + lane + 32 * r] = ri[r];
        }
      }
      if (lane == 0 && more) {
        sInfo[stage] = row0;
        hp::mbar_arrive_expect_tx(&full[stage], T::kQBytes + T::kDOBytes);
        unsigned char* qd = sQ + stage * T::kQBytes;
        unsigned char* dd = sDO + stage * T::kDOBytes;
#pragma unroll
        for (int p = 0; p < DQK / T::kQCols; ++p)
          hp::tma_load_4d(qd + p * kBlockM * T::kQRow, &q_map, &full[stage], p * T::kQCols,
                          row0, h, b);
#pragma unroll
        for (int p = 0; p < DV / T::kVCols; ++p)
          hp::tma_load_4d(dd + p * kBlockM * T::kVRow, &do_map, &full[stage], p * T::kVCols,
                          row0, h, b);
      } else {
        if (lane == 0) sInfo[stage] = -1;
        hp::mbar_arrive(&full[stage]);
      }
      if (!more) break;
      w = next_step(w + 1);
      if (w < n_work) load_rows(w);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // Consumer warpgroups. kShare: both own the CTA's 64 keys, each half of
  // the dk / dv columns; otherwise warpgroup wg owns keys [64 wg, 64 wg + 64).
  hp::setmaxnreg_inc<kBwdConsumerRegs>();
  const int wg = warp / 4 - 1;
  const int g = lane >> 2, t = lane & 3;  // accumulator fragment row group / column pair
  const int k_first = n0 + (T::kShare ? 0 : 64 * wg);  // this warpgroup's keys
  const int k_last = k_first + 63;
  const int kr = (T::kShare ? 0 : 64 * wg) + 16 * (warp & 3);  // this warp's first key row
  const int q_off = a.q_off, window = a.window, causal = a.causal;
  int keys[2], ks[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    keys[r] = n0 + kr + g + 8 * r;
    if constexpr (kSeg) ks[r] = keys[r] < Sk ? a.kv_seg[(long long)b * Sk + keys[r]] : INT_MIN;
  }
  const unsigned char* sKw = sK + (T::kShare ? 0 : 64 * wg) * T::kQRow;  // this warpgroup's keys
  const unsigned char* sVw = sV + (T::kShare ? 0 : 64 * wg) * T::kVRow;

  float acc_dk[T::kDK / 2], acc_dv[T::kDV / 2];
#pragma unroll
  for (int i = 0; i < T::kDK / 2; ++i) acc_dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < T::kDV / 2; ++i) acc_dv[i] = 0.f;

  hp::mbar_wait(kv_full, 0);
  // Per step: whether an element of this warpgroup's keys x the step's rows
  // needs a mask, and each key's kept rows from the thread's column base.
  auto step_masks = [&](int row0, int2 (&kept)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) kept[r] = kept_rows(a, keys[r], row0 + 2 * t);
    return kSeg || row0 + kBlockM > Sq || (causal && k_last > row0 + q_off) ||
           (window > 0 && (row0 + kBlockM - 1 + q_off - k_first >= window ||
                           (!causal && k_last - row0 - q_off >= window)));
  };
  int stage = 0;
  unsigned phase = 0;
  if constexpr (!T::kShare) {
    while (true) {
      hp::mbar_wait(&full[stage], phase);
      __syncwarp();
      const int row0 = sInfo[stage];
      if (row0 < 0) break;
      const int row_last = min(row0 + kBlockM, Sq) - 1;
      const unsigned char* qt = sQ + stage * T::kQBytes;
      const unsigned char* dt = sDO + stage * T::kDOBytes;
      const float* rs = sRow + stage * 3 * kBlockM + 2 * t;  // from the thread's column base
      const int* QS = reinterpret_cast<const int*>(rs) + 2 * kBlockM;
      int2 kept[2];
      const bool masked = step_masks(row0, kept);
      // Does some key of this warpgroup see some row of the step?
      const bool sees = k_first < Sk && (!causal || k_first <= row_last + q_off) &&
                        (window == 0 || (row0 + q_off - k_last < window &&
                                         (causal || k_first - row_last - q_off < window)));
      if (sees) {
        // Descriptors of the operands' first k-step.
        const uint64_t k0 = hp::make_desc(sKw, T::kQRow, 16, 8 * T::kQRow);
        const uint64_t v0 = hp::make_desc(sVw, T::kVRow, 16, 8 * T::kVRow);
        const uint64_t q0 = hp::make_desc(qt, T::kQRow, 16, 8 * T::kQRow);
        const uint64_t o0 = hp::make_desc(dt, T::kVRow, 16, 8 * T::kVRow);
        float s[kBlockM / 2], dp[kBlockM / 2];
#pragma unroll
        for (int i = 0; i < kBlockM / 2; ++i) s[i] = dp[i] = 0.f;
        hp::fence_regs(s);
        hp::fence_regs(dp);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DQK / 16; ++kk) {  // S^T = K Q^T, both K-major
          const int p = kk * 16 / T::kQCols, c = kk * 16 % T::kQCols * 2;  // panel, byte column
          hp::wgmma_ss<0, 0>(s, hp::desc_add(k0, p * kKeys * T::kQRow + c),
                             hp::desc_add(q0, p * kBlockM * T::kQRow + c), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk) {  // dP^T = V dO^T, both K-major
          const int p = kk * 16 / T::kVCols, c = kk * 16 % T::kVCols * 2;
          hp::wgmma_ss<0, 0>(dp, hp::desc_add(v0, p * kKeys * T::kVRow + c),
                             hp::desc_add(o0, p * kBlockM * T::kVRow + c), kk > 0);
        }
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(s);
        hp::fence_regs(dp);
        p_and_ds<kBlockM / 8, kSeg>(s, dp, 0, masked, kept, ks, rs, rs + kBlockM, QS,
                                    a.scale_log2);
        uint32_t pa[kBlockM / 16][4], da[kBlockM / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBlockM / 16; ++kk) {
          acc_to_a_frag(pa[kk], &s[8 * kk], &s[8 * kk + 4]);
          acc_to_a_frag(da[kk], &dp[8 * kk], &dp[8 * kk + 4]);
        }
        // dV += P^T dO and dK += dS^T Q over four k-steps of 16 rows, dO and
        // q MN-major (transposed B).
        const uint64_t omn =
            hp::make_desc(dt, T::kVRow, kBlockM * T::kVRow, 8 * T::kVRow);  // dO MN-major
        const uint64_t qmn =
            hp::make_desc(qt, T::kQRow, kBlockM * T::kQRow, 8 * T::kQRow);  // q MN-major
        hp::fence_regs(acc_dv);
        hp::fence_regs(acc_dk);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockM / 16; ++kk) {
          hp::wgmma_rs_mn<DV, T::kVCols>(acc_dv, pa[kk], hp::desc_add(omn, kk * 16 * T::kVRow),
                                         kBlockM * T::kVRow);
          hp::wgmma_rs_mn<DQK, T::kQCols>(acc_dk, da[kk], hp::desc_add(qmn, kk * 16 * T::kQRow),
                                          kBlockM * T::kQRow);
        }
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(acc_dv);
        hp::fence_regs(acc_dk);
      }
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[stage]);  // this warp is done with the stage
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // Step t: S^T and dP^T of this warpgroup's 32 rows (all 64 keys), then
    // P^T and dS^T into buffer t % 2 and a barrier, then dV and dK of this
    // warpgroup's column halves from the whole buffer. (Issuing step t + 1's
    // S^T / dP^T before step t's dV / dK, with a third buffer, was 17-20 %
    // slower at the RL shape, tools_torch/compare_k5_bwd.py.)
    constexpr int kHalf = kBlockM / 2;
    float s[kHalf / 2], dp[kHalf / 2];
    auto issue_a = [&](int st) {
      const uint64_t k0 = hp::make_desc(sK, T::kQRow, 16, 8 * T::kQRow);
      const uint64_t v0 = hp::make_desc(sV, T::kVRow, 16, 8 * T::kVRow);
      const uint64_t q0 =
          hp::make_desc(sQ + st * T::kQBytes + wg * kHalf * T::kQRow, T::kQRow, 16, 8 * T::kQRow);
      const uint64_t o0 = hp::make_desc(sDO + st * T::kDOBytes + wg * kHalf * T::kVRow, T::kVRow,
                                        16, 8 * T::kVRow);
#pragma unroll
      for (int i = 0; i < kHalf / 2; ++i) s[i] = dp[i] = 0.f;
      hp::fence_regs(s);
      hp::fence_regs(dp);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const int p = kk * 16 / T::kQCols, c = kk * 16 % T::kQCols * 2;
        hp::wgmma_ss<0, 0>(s, hp::desc_add(k0, p * kKeys * T::kQRow + c),
                           hp::desc_add(q0, p * kBlockM * T::kQRow + c), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        const int p = kk * 16 / T::kVCols, c = kk * 16 % T::kVCols * 2;
        hp::wgmma_ss<0, 0>(dp, hp::desc_add(v0, p * kKeys * T::kVRow + c),
                           hp::desc_add(o0, p * kBlockM * T::kVRow + c), kk > 0);
      }
      hp::wgmma_commit();
    };
    auto finish_a = [&](int st, int row0, int bf) {
      hp::fence_regs(s);
      hp::fence_regs(dp);
      int2 kept[2];
      const bool masked = step_masks(row0, kept);
      const float* rs = sRow + st * 3 * kBlockM + 2 * t;
      p_and_ds<kHalf / 8, kSeg>(s, dp, wg * kHalf, masked, kept, ks, rs, rs + kBlockM,
                                reinterpret_cast<const int*>(rs) + 2 * kBlockM, a.scale_log2);
      // P^T and dS^T in bf16 into the buffer's (64 keys, 64 rows) tiles,
      // 128-byte rows with the 128-byte swizzle (the 16-byte chunk of a row
      // XOR-ed with the row % 8), columns [32 wg, 32 wg + 32).
      unsigned char* pt = sP + bf * 2 * T::kPBytes;
#pragma unroll
      for (int nt = 0; nt < kHalf / 8; ++nt) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * (warp & 3) + g + 8 * r;
          const int off = row * 128 + (((4 * wg + nt) ^ (row & 7)) << 4) + 4 * t;
          *reinterpret_cast<uint32_t*>(pt + off) =
              pack_bf16(s[4 * nt + 2 * r], s[4 * nt + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(pt + T::kPBytes + off) =
              pack_bf16(dp[4 * nt + 2 * r], dp[4 * nt + 2 * r + 1]);
        }
      }
      hp::fence_proxy_async();
      hp::bar_sync(1, 2 * 128);  // both halves written (the other buffer's reads are done)
    };
    // dV[:, half] += P^T dO[:, half], dK[:, half] += dS^T Q[:, half]: A
    // K-major from the shared tile, dO / q MN-major, one wgmma per panel.
    auto issue_b = [&](int st, int bf) {
      const unsigned char* pt = sP + bf * 2 * T::kPBytes;
      const uint64_t ap = hp::make_desc(pt, 128, 16, 1024);
      const uint64_t ad = hp::make_desc(pt + T::kPBytes, 128, 16, 1024);
      const uint64_t omn =
          hp::make_desc(sDO + st * T::kDOBytes + wg * T::kDV / 64 * kBlockM * T::kVRow, T::kVRow,
                        kBlockM * T::kVRow, 8 * T::kVRow);
      const uint64_t qmn =
          hp::make_desc(sQ + st * T::kQBytes + wg * T::kDK / 64 * kBlockM * T::kQRow, T::kQRow,
                        kBlockM * T::kQRow, 8 * T::kQRow);
      hp::fence_regs(acc_dv);
      hp::fence_regs(acc_dk);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockM / 16; ++kk) {
#pragma unroll
        for (int c = 0; c < T::kDV / 64; ++c)
          hp::wgmma_ss<0, 1>(hp::cols<32>(acc_dv, c), hp::desc_add(ap, kk * 32),
                             hp::desc_add(omn, (c * kBlockM + kk * 16) * T::kVRow), 1);
#pragma unroll
        for (int c = 0; c < T::kDK / 64; ++c)
          hp::wgmma_ss<0, 1>(hp::cols<32>(acc_dk, c), hp::desc_add(ad, kk * 32),
                             hp::desc_add(qmn, (c * kBlockM + kk * 16) * T::kQRow), 1);
      }
      hp::wgmma_commit();
    };
    int buf = 0;
    while (true) {
      hp::mbar_wait(&full[stage], phase);
      __syncwarp();
      const int row0 = sInfo[stage];
      if (row0 < 0) break;
      issue_a(stage);
      hp::wgmma_wait<0>();
      finish_a(stage, row0, buf);
      issue_b(stage, buf);
      hp::wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[stage]);  // this warp is done with the stage
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
      buf ^= 1;
    }
    hp::fence_regs(acc_dv);
    hp::fence_regs(acc_dk);
    hp::fence_regs(acc_dv);
    hp::fence_regs(acc_dk);
  }

  bf16* dk = static_cast<bf16*>(a.dk);
  bf16* dv = static_cast<bf16*>(a.dv);
  const int ck = T::kShare ? wg * T::kDK : 0, cv = T::kShare ? wg * T::kDV : 0;  // first columns
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (keys[r] >= Sk) continue;
    bf16* kout = dk + b * a.dk_b + (long long)keys[r] * a.dk_s + hk * a.dk_h + ck;
    bf16* vout = dv + b * a.dv_b + (long long)keys[r] * a.dv_s + hk * a.dv_h + cv;
#pragma unroll
    for (int n = 0; n < T::kDK / 8; ++n) {
      *reinterpret_cast<uint32_t*>(kout + n * 8 + 2 * t) =
          pack_bf16(acc_dk[4 * n + 2 * r] * a.scale, acc_dk[4 * n + 2 * r + 1] * a.scale);
    }
#pragma unroll
    for (int n = 0; n < T::kDV / 8; ++n) {
      *reinterpret_cast<uint32_t*>(vout + n * 8 + 2 * t) =
          pack_bf16(acc_dv[4 * n + 2 * r], acc_dv[4 * n + 2 * r + 1]);
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
  const int Hkv = a.H / a.group;
  if (dtype == 1) {
    using T = DkvTile<DQK, DV>;
    CUtensorMap maps[4];  // q, k, v, dO
    cudaError_t err = hp::encode_bshd(&maps[0], a.q, B, a.Sq, a.H, DQK, a.q_b, a.q_s, a.q_h,
                                      kBlockM, T::kQCols);
    if (err == cudaSuccess)
      err = hp::encode_bshd(&maps[1], a.k, B, a.Sk, Hkv, DQK, a.k_b, a.k_s, a.k_h, T::kKeys,
                            T::kQCols);
    if (err == cudaSuccess)
      err = hp::encode_bshd(&maps[2], a.v, B, a.Sk, Hkv, DV, a.v_b, a.v_s, a.v_h, T::kKeys,
                            T::kVCols);
    if (err == cudaSuccess)
      err = hp::encode_bshd(&maps[3], a.dout, B, a.Sq, a.H, DV, a.do_b, a.do_s, a.do_h, kBlockM,
                            T::kVCols);
    if (err != cudaSuccess) return err;
    auto kern = causal_bwd_dkv_bf16_kernel<DQK, DV, kSeg>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err != cudaSuccess) return err;
    kern<<<dim3((a.Sk + T::kKeys - 1) / T::kKeys, Hkv, B), kBwdThreads, T::kSmemBytes, stream>>>(
        maps[0], maps[1], maps[2], maps[3], a);
  } else {
    causal_bwd_dkv_f32_kernel<DQK, DV, kSeg>
        <<<dim3((a.Sk + kF32Keys - 1) / kF32Keys, Hkv, B), kF32Keys, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// C entry bound with ctypes, with the signature of ivt_flash_bwd_causal_dq
// (flash_bwd_causal_dq.cu); writes dk and dv of the Hkv K/V heads (dq is
// ignored). Returns the cudaError_t of the launch (cudaErrorInvalidValue for
// an uninstantiated (Dqk, Dv) or dtype, or a bf16 tensor
// cuTensorMapEncodeTiled refuses a TMA map for); launches on `stream`; does
// not synchronise.
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
