// Flash-attention backward, dq kernel, for the causal / narrow-v /
// segmented / grouped-query / windowed case (K5 backward + K8) on Hopper
// (sm_90a): the gradient of the LLMs' training attention, q/k at d_qk =
// nope + rope (256 on qwen3_8b_mla) and v/dO at d_v = 128, or (128, 128) on
// qwen3_8b_dense, inputs in (B, S, H, D) with any 16-byte-multiple strides.
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
// Grouped-query heads and the sliding window (`_bwd(group=, window=)`
// :782-785, the K/V index maps `h // group`): the CTA of q head h reads K/V
// head h / group through the K/V maps, so K/V are never repeated in memory.
// With window > 0 query position p = i + q_off sees key j only if
// p - j < window, and without causal also j - p < window (`_mask_block`
// :40-68). A row that sees no key (LSE -inf) gets p = 0, so dq = 0.
//
// What does not carry over: the TPU kernel remaps dead (q block, k block)
// pairs' DMAs with a scalar-prefetched table. Here the producer warp of each
// CTA walks its key tiles and skips, before loading it, a tile outside its
// rows' band (band_keys) or whose segment range misses the query tile's
// (segments.cuh).
//
// What bounds it: 2 * S_vis * (2 d_qk + d_v) tensor-core operations per
// (row, head) over the visible keys S_vis, against reading q, k, v, dO once:
// operations, with the exp2 between the products.
//
// Design (the forward's, flash_fwd_causal.cu, on hopper.cuh): one CTA of
// three warpgroups per (query tile, head, batch), the last query tiles (the
// most key tiles) launched first.
// - A producer warp loads the q and dO tiles once by TMA, before it walks
//   the key tiles, then fills a ring of K + V stages (full / empty
//   mbarriers). It alone decides each tile's skip and hands the tile index,
//   and with segments the tile's ids, to the consumers with the stage; -1
//   ends the walk.
// - Two consumer warpgroups: S = Q K^T and dP = dO V^T as wgmma with both
//   operands in shared memory (K-major, 128-byte swizzle; 64-byte at d 32);
//   P and dS stay in the fp32 accumulator fragments; dS, rounded to bf16 (as
//   the JAX kernel rounds it to k's dtype), is the A operand of dQ += dS K,
//   with K read MN-major through the transpose bit.
// - d_qk <= 128: 128 rows a CTA, 64 per warpgroup (m64n64k16 for S and dP),
//   dq of all columns in registers (64 at 128) and dS as A fragments in
//   registers (the RS form). A warpgroup skips a tile none of its rows sees.
// - d_qk 256 (kSplit): dq alone would be 128 registers a thread; beside S
//   and dP, ptxas spilled it and serialized every wgmma (a wait after each).
//   So both warpgroups take the CTA's 64 rows: each computes S and dP for
//   half the tile's keys (m64n32k16), writes its dS in bf16 to a swizzled
//   shared tile (two buffers, so one named barrier a tile orders both
//   writes before both reads) and accumulates half of dq's columns (64
//   registers) from the whole tile (A from shared memory).
// - Masks: per row the kept keys of a tile are one interval of the
//   compile-time column (causal, window, Sk tail), so a masked element costs
//   two integer compares (plus the id equality with segments); only tiles
//   that straddle the diagonal, a band edge or the Sk tail, or carry
//   segments, are masked.
// - 64 keys a stage; 4 stages (3 at d_qk 256) in the 227 KB.
// TMA zero-fills rows past Sq / Sk; rows past Sq have p = 0 (LSE +inf) and
// are not stored. fp32 inputs take a CUDA-core kernel (the parity checks,
// not the bf16 main path).

#include "causal_bwd.cuh"

namespace {

using namespace ivt;
namespace hp = ivt::hopper;
using bf16 = __nv_bfloat16;

constexpr int kBlockN = 64;  // keys per K/V stage

template <int DQK, int DV>
struct DqTile {
  static_assert(DQK % 32 == 0 && DV % 32 == 0, "head dims must be multiples of 32");
  // kSplit (d_qk 256): both consumer warpgroups on the CTA's 64 rows, each
  // accumulating half of dq's columns from dS passed through shared memory;
  // otherwise 128 rows, 64 per warpgroup, all columns in registers.
  static constexpr bool kSplit = DQK > 128;
  static_assert(!kSplit || DQK % 128 == 0, "the column halves must be whole 64-column panels");
  static constexpr int kRows = kSplit ? 64 : 128;  // query rows per CTA
  static constexpr int kDQ = kSplit ? DQK / 2 : DQK;  // dq columns a warpgroup accumulates
  static constexpr int kStages = kSplit ? 3 : 4;
  static constexpr int kQCols = DQK < 64 ? DQK : 64;  // columns of a panel (one TMA box)
  static constexpr int kVCols = DV < 64 ? DV : 64;
  static constexpr int kQRow = 2 * kQCols;  // bytes of a panel row = the swizzle span
  static constexpr int kVRow = 2 * kVCols;
  static constexpr int kQBytes = kRows * DQK * 2;
  static constexpr int kDOBytes = kRows * DV * 2;
  static constexpr int kKBytes = kBlockN * DQK * 2;
  static constexpr int kVBytes = kBlockN * DV * 2;
  static constexpr int kDSBytes = kSplit ? kRows * kBlockN * 2 : 0;  // one bf16 dS tile
  // From a 1024-byte boundary: q, dO, each stage's K, each stage's V, two
  // dS buffers (kSplit), each stage's key segment ids and tile index, then
  // the barriers.
  static constexpr int kDOOff = kQBytes;
  static constexpr int kKOff = kDOOff + kDOBytes;
  static constexpr int kVOff = kKOff + kStages * kKBytes;
  static constexpr int kDSOff = kVOff + kStages * kVBytes;
  static constexpr int kSegOff = kDSOff + 2 * kDSBytes;
  static constexpr int kTileOff = kSegOff + kStages * kBlockN * 4;
  static constexpr int kBarOff = (kTileOff + kStages * 4 + 7) / 8 * 8;
  static constexpr int kSmemBytes = kBarOff + (2 * kStages + 1) * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "over the 227 KB a CTA may use");
};

template <int DQK, int DV, bool kSeg>
__global__ void __launch_bounds__(kBwdThreads, 1)
    causal_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const CausalBwdArgs a) {
  using T = DqTile<DQK, DV>;
  constexpr int kStages = T::kStages, kRows = T::kRows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sDO = smem + T::kDOOff;
  unsigned char* sK = smem + T::kKOff;  // stage s at s * kKBytes, panels of kBlockN rows
  unsigned char* sV = smem + T::kVOff;
  unsigned char* sDS = smem + T::kDSOff;  // [buffer]: dS (kSplit)
  int* sKS = reinterpret_cast<int*>(smem + T::kSegOff);    // [stage][key]: kv segment ids
  int* sTile = reinterpret_cast<int*>(smem + T::kTileOff);  // [stage]: key tile, -1 = the end
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBarOff);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int Sq = a.Sq, Sk = a.Sk;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 32);  // every producer lane (lane 0 with the bytes)
      hp::mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    hp::mbar_init(q_full, 1);
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    // Producer warpgroup: warp 0 walks the key tiles and issues every load.
    hp::setmaxnreg_dec<kBwdProducerRegs>();
    if (warp != 0) return;
    const int2 band = band_keys(a, m0, min(m0 + kRows, Sq));
    const int n_tiles = (band.y + kBlockN - 1) / kBlockN;
    const int* kvs = kSeg ? a.kv_seg + (long long)b * Sk : nullptr;
    int2 q_range = make_int2(INT_MIN, INT_MAX);
    if constexpr (kSeg) q_range = seg_range(a.q_seg + (long long)b * Sq, m0, kRows, Sq, lane);
    int win = INT_MIN;  // the window of 32 tiles whose skip tests `meets` holds
    unsigned meets = 0;
    auto next_tile = [&](int j) {
      if constexpr (kSeg) {
        j = next_meeting(j, n_tiles, win, meets, lane, [&](int jj) {
          return ranges_meet(ids_range(kvs, jj * kBlockN, kBlockN, Sk), q_range);
        });
      }
      return j;
    };
    int ids[2];  // the next tile's key ids, loaded while the ring is full
    auto load_ids = [&](int j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = j * kBlockN + lane + 32 * r;
        ids[r] = key < Sk ? kvs[key] : INT_MIN;
      }
    };
    if (lane == 0) {
      hp::prefetch_map(&q_map);
      hp::prefetch_map(&k_map);
      hp::prefetch_map(&v_map);
      hp::prefetch_map(&do_map);
      hp::mbar_arrive_expect_tx(q_full, T::kQBytes + T::kDOBytes);
#pragma unroll
      for (int p = 0; p < DQK / T::kQCols; ++p)
        hp::tma_load_4d(sQ + p * kRows * T::kQRow, &q_map, q_full, p * T::kQCols, m0, h, b);
#pragma unroll
      for (int p = 0; p < DV / T::kVCols; ++p)
        hp::tma_load_4d(sDO + p * kRows * T::kVRow, &do_map, q_full, p * T::kVCols, m0, h, b);
    }
    const int hk = h / a.group;  // GQA: the group's K/V head
    int j = next_tile(band.x / kBlockN);
    if (kSeg && j < n_tiles) load_ids(j);
    int stage = 0;
    unsigned phase = 0;
    while (true) {
      hp::mbar_wait(&empty[stage], phase ^ 1);
      const bool more = j < n_tiles;
      const int key0 = j * kBlockN;
      if (kSeg && more) {
#pragma unroll
        for (int r = 0; r < 2; ++r) sKS[stage * kBlockN + lane + 32 * r] = ids[r];
      }
      if (lane == 0 && more) {
        sTile[stage] = j;
        hp::mbar_arrive_expect_tx(&full[stage], T::kKBytes + T::kVBytes);
        unsigned char* kd = sK + stage * T::kKBytes;
        unsigned char* vd = sV + stage * T::kVBytes;
#pragma unroll
        for (int p = 0; p < DQK / T::kQCols; ++p)
          hp::tma_load_4d(kd + p * kBlockN * T::kQRow, &k_map, &full[stage], p * T::kQCols, key0,
                          hk, b);
#pragma unroll
        for (int p = 0; p < DV / T::kVCols; ++p)
          hp::tma_load_4d(vd + p * kBlockN * T::kVRow, &v_map, &full[stage], p * T::kVCols, key0,
                          hk, b);
      } else {
        if (lane == 0) sTile[stage] = -1;
        hp::mbar_arrive(&full[stage]);
      }
      if (!more) break;
      j = next_tile(j + 1);
      if (kSeg && j < n_tiles) load_ids(j);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // Consumer warpgroups. kSplit: both on the CTA's 64 rows, warpgroup wg
  // taking keys [32 wg, 32 wg + 32) of each tile for S and dP and dq's
  // columns [128 wg, 128 wg + 128); otherwise rows [64 wg, 64 wg + 64).
  hp::setmaxnreg_inc<kBwdConsumerRegs>();
  const int wg = warp / 4 - 1;
  const int g = lane >> 2, t = lane & 3;  // accumulator fragment row group / column pair
  constexpr int kKeys = T::kSplit ? kBlockN / 2 : kBlockN;  // keys of S / dP a warpgroup takes
  const int wrow = T::kSplit ? 0 : 64 * wg;  // this warpgroup's first row in the tile
  const int wkey = T::kSplit ? kKeys * wg : 0;  // and its first key of S / dP in a K tile
  const int r0 = m0 + wrow, r_last = r0 + 63;
  const int qr = wrow + (warp & 3) * 16;  // this warp's first row in the tile
  const int q_off = a.q_off, window = a.window, causal = a.causal;
  int rows[2], qs[2] = {0, 0};
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rows[r] = m0 + qr + g + 8 * r;
    const long long i = ((long long)b * a.H + h) * Sq + rows[r];
    lse2[r] = rows[r] < Sq ? lse_to_base2(a.lse[i]) : INFINITY;  // rows past Sq: p = 0
    dlt[r] = rows[r] < Sq ? a.delta[i] : 0.f;
    if constexpr (kSeg) qs[r] = rows[r] < Sq ? a.q_seg[(long long)b * Sq + rows[r]] : INT_MIN;
  }
  const unsigned char* sQw = sQ + wrow * T::kQRow;  // this warpgroup's rows
  const unsigned char* sDOw = sDO + wrow * T::kVRow;

  float acc[T::kDQ / 2];
#pragma unroll
  for (int i = 0; i < T::kDQ / 2; ++i) acc[i] = 0.f;

  hp::mbar_wait(q_full, 0);
  int stage = 0, buf = 0;
  unsigned phase = 0;
  while (true) {
    hp::mbar_wait(&full[stage], phase);
    __syncwarp();
    const int j = sTile[stage];
    if (j < 0) break;
    const int key0 = j * kBlockN, key_last = key0 + kBlockN - 1;
    // Does some row of this warpgroup see some key of the tile? (kSplit:
    // the same answer for both warpgroups, which meet at a barrier.)
    const bool sees = r0 < Sq && (!causal || key0 <= r_last + q_off) &&
                      (window == 0 || (key_last > r0 + q_off - window &&
                                       (causal || key0 < r_last + q_off + window)));
    if (sees) {
      // S = Q K^T and dP = dO V^T on this warpgroup's rows and keys, all
      // operands K-major; descriptors of the first k-step.
      const unsigned char* kt = sK + stage * T::kKBytes;
      const uint64_t dq0 = hp::make_desc(sQw, T::kQRow, 16, 8 * T::kQRow);
      const uint64_t do0 = hp::make_desc(sDOw, T::kVRow, 16, 8 * T::kVRow);
      const uint64_t k0 = hp::make_desc(kt + wkey * T::kQRow, T::kQRow, 16, 8 * T::kQRow);
      const uint64_t v0 =
          hp::make_desc(sV + stage * T::kVBytes + wkey * T::kVRow, T::kVRow, 16, 8 * T::kVRow);
      float s[kKeys / 2], dp[kKeys / 2];
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) s[i] = dp[i] = 0.f;
      hp::fence_regs(s);
      hp::fence_regs(dp);
      hp::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DQK / 16; ++ks) {
        const int p = ks * 16 / T::kQCols, c = ks * 16 % T::kQCols * 2;  // panel, byte column
        hp::wgmma_ss<0, 0>(s, hp::desc_add(dq0, p * kRows * T::kQRow + c),
                           hp::desc_add(k0, p * kBlockN * T::kQRow + c), ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < DV / 16; ++ks) {
        const int p = ks * 16 / T::kVCols, c = ks * 16 % T::kVCols * 2;
        hp::wgmma_ss<0, 0>(dp, hp::desc_add(do0, p * kRows * T::kVRow + c),
                           hp::desc_add(v0, p * kBlockN * T::kVRow + c), ks > 0);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(s);
      hp::fence_regs(dp);

      // ds = p * (dp - delta), masked only where the tile straddles the
      // diagonal, a band edge or the Sk tail, or carries segments. Element e
      // of n-tile nt sits at row g + 8 (e >> 1) of the warp and key key0 +
      // wkey + 2 t + c, c = 8 nt + (e & 1) a compile-time constant: row r
      // keeps it iff lo[r] <= c <= hi[r] (and the ids match).
      const bool masked =
          kSeg || key0 + kBlockN > Sk || (causal && key_last > r0 + q_off) ||
          (window > 0 &&
           (r_last + q_off - key0 >= window || (!causal && key_last - r0 - q_off >= window)));
      const int kb = key0 + wkey + 2 * t;  // the thread's key base
      const int* ids = sKS + stage * kBlockN + wkey + 2 * t;
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rel = rows[r] + q_off - kb;  // position - key base
        hi[r] = Sk - 1 - kb;
        if (causal) hi[r] = min(hi[r], rel);
        if (window > 0 && !causal) hi[r] = min(hi[r], rel + window - 1);
        lo[r] = window > 0 ? rel - window + 1 : INT_MIN;
      }
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * nt + (e & 1), r = e >> 1;
          float p = exp2f(s[4 * nt + e] * a.scale_log2 - lse2[r]);
          if (masked && (c > hi[r] || c < lo[r] || (kSeg && ids[c] != qs[r]))) p = 0.f;
          s[4 * nt + e] = p * (dp[4 * nt + e] - dlt[r]);
        }
      }

      // dQ += dS K over four k-steps of 16 keys, K MN-major (transposed B).
      const uint64_t kmn = hp::make_desc(kt, T::kQRow, kBlockN * T::kQRow, 8 * T::kQRow);
      if constexpr (!T::kSplit) {
        uint32_t ds[kBlockN / 16][4];  // dS in bf16 A fragments
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk)
          acc_to_a_frag(ds[kk], &s[8 * kk], &s[8 * kk + 4]);
        hp::fence_regs(acc);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk)
          hp::wgmma_rs_mn<DQK, T::kQCols>(acc, ds[kk], hp::desc_add(kmn, kk * 16 * T::kQRow),
                                          kBlockN * T::kQRow);
      } else {
        // dS in bf16 into this buffer's (64 rows, 64 keys) tile, 128-byte
        // rows with the 128-byte swizzle (the 16-byte chunk of a row XOR-ed
        // with the row % 8), keys [32 wg, 32 wg + 32); then all of dS, from
        // shared memory, times this warpgroup's half of K's columns.
        unsigned char* dst = sDS + buf * T::kDSBytes;
#pragma unroll
        for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = 16 * (warp & 3) + g + 8 * r;
            const int off = row * 128 + (((4 * wg + nt) ^ (row & 7)) << 4) + 4 * t;
            *reinterpret_cast<uint32_t*>(dst + off) =
                pack_bf16(s[4 * nt + 2 * r], s[4 * nt + 2 * r + 1]);
          }
        }
        hp::fence_proxy_async();
        hp::bar_sync(1, 2 * 128);  // both halves written (the other buffer's reads are done)
        const uint64_t ads = hp::make_desc(dst, 128, 16, 1024);
        hp::fence_regs(acc);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk) {
#pragma unroll
          for (int c = 0; c < T::kDQ / 64; ++c)
            hp::wgmma_ss<0, 1>(
                hp::cols<32>(acc, c), hp::desc_add(ads, kk * 32),
                hp::desc_add(kmn, ((wg * T::kDQ / 64 + c) * kBlockN + kk * 16) * T::kQRow), 1);
        }
        buf ^= 1;
      }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&empty[stage]);  // this warp is done with the stage
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  bf16* dq = static_cast<bf16*>(a.dq);
  const int col0 = T::kSplit ? wg * T::kDQ : 0;  // this warpgroup's first dq column
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Sq) continue;
    bf16* out = dq + b * a.dq_b + (long long)rows[r] * a.dq_s + h * a.dq_h + col0;
#pragma unroll
    for (int n = 0; n < T::kDQ / 8; ++n) {
      *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t) =
          pack_bf16(acc[4 * n + 2 * r] * a.scale, acc[4 * n + 2 * r + 1] * a.scale);
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
    using T = DqTile<DQK, DV>;
    const int Hkv = a.H / a.group;
    CUtensorMap maps[4];  // q, k, v, dO
    cudaError_t err = hp::encode_bshd(&maps[0], a.q, B, a.Sq, a.H, DQK, a.q_b, a.q_s, a.q_h,
                                      T::kRows, T::kQCols);
    if (err == cudaSuccess)
      err = hp::encode_bshd(&maps[1], a.k, B, a.Sk, Hkv, DQK, a.k_b, a.k_s, a.k_h, kBlockN,
                            T::kQCols);
    if (err == cudaSuccess)
      err = hp::encode_bshd(&maps[2], a.v, B, a.Sk, Hkv, DV, a.v_b, a.v_s, a.v_h, kBlockN,
                            T::kVCols);
    if (err == cudaSuccess)
      err = hp::encode_bshd(&maps[3], a.dout, B, a.Sq, a.H, DV, a.do_b, a.do_s, a.do_h, T::kRows,
                            T::kVCols);
    if (err != cudaSuccess) return err;
    auto kern = causal_bwd_dq_bf16_kernel<DQK, DV, kSeg>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err != cudaSuccess) return err;
    kern<<<dim3((a.Sq + T::kRows - 1) / T::kRows, a.H, B), kBwdThreads, T::kSmemBytes,
           stream>>>(maps[0], maps[1], maps[2], maps[3], a);
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
// (Dqk, Dv) or dtype, H not a multiple of Hkv, or a bf16 tensor
// cuTensorMapEncodeTiled refuses a TMA map for); launches on `stream`; does
// not synchronise.
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
