// Causal flash-attention forward with a narrow value head for Hopper
// (sm_90a): the M2LA LLM's prefill attention, q/k at d_qk = nope + rope
// (256 on qwen3_8b_mla, 192 on qwen3_2b_mla) and v/o at d_v = 128, inputs
// in (B, S, H, D) with any 16-byte-multiple strides (a (B, H, S, D) view
// and the k / v halves of one projection included).
//
// Replaces internvideo_tpu/ops/flash_attention.py:153 `_fwd_kernel` on its
// causal branch (`_block_visible` :137-150, the masked body :253-301) with
// separate q/k and v/o widths (:322-328, :2072-2075) and the query position
// offset of chunked prefill (`q_pos`): query row i sits at key index
// i + q_offset and sees key j iff j <= i + q_offset. A row that sees no key
// gets out 0 and LSE -inf. With causal = 0 the same body runs non-causal
// attention at d_v != d_qk.
//
// Grouped-query heads and the sliding window (the dense-GQA LLM,
// qwen3_8b_dense; the JAX `_fwd(group=, window=)` :322-324): q head h reads
// K/V head h / group through the K/V tensors' own strides (the K/V index maps
// `h // group` :396-400), so K/V are never repeated in memory. With
// window > 0 query position p = i + q_offset sees key j only if
// p - j < window, and without causal also j - p < window (`_mask_block`
// :40-68). A CTA walks only the key tiles of its rows' band (`_block_visible`
// :137-150): tiles wholly outside it are never loaded, tiles that straddle
// an edge of it are masked per element.
//
// With packed-sequence segment ids (K8, the `kSeg` template flag; the JAX
// kernel's `q_seg == k_seg` in `_mask_block` :62-64 and its block skipping
// `_segs_overlap` / `_build_remap` :75-130) query row i also needs
// q_seg[i] == kv_seg[j]. A key tile whose id range is disjoint from the
// query tile's is never loaded (segments.cuh); the kept tiles are masked by
// equality element by element from the tile's ids in shared memory.
//
// What bounds it: at the prefill shape (8, 2048, 32, 256 / 128) bf16 the
// causal half of B*H*S^2*(d_qk + d_v) FLOPs (4.1e11) takes 0.42 ms at the
// tensor cores' 989 TFLOP/s, against 0.81 GB of q/k/v/out (0.24 ms at 3.35
// TB/s): operations. Whole-tile skipping halves the work: a (query tile,
// key tile) pair above the diagonal is never loaded, and only tiles that
// cross the diagonal (or the Sk tail) are masked element by element.
// With a window of w the work is linear in S: each row sees at most w keys,
// so at (8, 2048, 32 / 8, 128) with w = 128 the 6.5e7 visible pairs (4 * d
// FLOPs each, 33 GFLOP) take 34 us at the tensor cores' rate against 0.34
// GB of q/k/v/out (0.1 ms): bytes. GQA reads each K/V tile once per q head
// of its group (from L2 for all but the first), so the DRAM bytes stay
// those of the Hkv heads.
//
// Design: mma.sync cannot reach that rate, and loads issued by the math
// warps take their issue slots; wgmma can, with its operands in shared
// memory filled by TMA from a warp that does no math, and loads that
// overlap the products through a ring of stages (hopper.cuh holds the
// pieces). One CTA of three warpgroups per (128-query tile, head, batch),
// the last query tiles (the most key tiles) launched first:
// - a producer warp (its warpgroup gives registers back with setmaxnreg)
//   loads the Q tile once and walks the key tiles, filling a K ring and a
//   V ring by TMA through full / empty mbarriers (a K stage is refilled
//   once its S = Q K^T is read, a V stage once its P V is done); it decides
//   each tile's skip (causal / window band, segment ranges) and hands the
//   tile index, and with segments the tile's ids, to the consumers with
//   the K stage, so every role follows one walk, and an index of -1 ends it;
// - two consumer warpgroups of 64 query rows each run S = Q K^T as wgmma
//   m64n64k16 with both operands in shared memory (K-major, 128-byte
//   swizzle; 64-byte at d 32), the online softmax in the base-2 domain on
//   the fp32 accumulator fragments, then O += P V as wgmma with P
//   converted to bf16 A fragments in registers (the RS form) and V read
//   from its (keys, d_v) tile with the transpose bit. A tile's P V is
//   issued together with the next tile's S (wait_group 1), so the softmax
//   of one tile runs while the other product is in flight, and the two
//   warpgroups take turns to issue (named barriers 1 and 2: ping-pong), so
//   one's softmax also runs under the other's products;
// - masks: the wgmma accumulator of a warp is mma.sync's m16n8 fragment
//   repeated over 8-column chunks: element e of chunk n sits at row
//   16 * warp + lane / 4 + 8 * (e >> 1) and key 8 * n + 2 * (lane % 4) +
//   (e & 1). Per row the kept keys of a tile are one interval of the
//   compile-time column 8 n + (e & 1) (causal, window, Sk tail), so a
//   masked tile costs two integer compares an element (plus the id
//   equality with segments). Only tiles that straddle the diagonal, a band
//   edge or the Sk tail, or carry segments, are masked; a tile none of a
//   warpgroup's rows sees is masked whole and leaves its running max / sum
//   as they were;
// - 64 keys a stage at every pair (the S accumulator is 32 registers, which
//   leaves room for the 64 of the d_v 128 output), with as many stages as
//   the 227 KB of shared memory hold: 3 at d_qk 256 (Q 64 KB + 3 x 48 KB),
//   4 otherwise (192: Q 48 KB + 4 x 40 KB).
// TMA zero-fills rows past Sq / Sk (each map's S extent is the true S, so a
// box never reads into the next head or batch); stores check the row.
// fp32 inputs take a CUDA-core FMA kernel (the parity checks and the fp32
// token-identity check, not the bf16 main path).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC, linked with the other sources into one shared
//        library (internvideo_tpu_torch/ops/_build.py).

#include "hopper.cuh"
#include "segments.cuh"

namespace {

using namespace ivt;
namespace hp = ivt::hopper;

constexpr int kBlockM = 128;       // query rows per CTA: two consumer warpgroups
constexpr int kWgRows = 64;        // query rows per consumer warpgroup (the wgmma M)
constexpr int kThreads = 384;      // the producer warpgroup, then two consumer warpgroups
constexpr int kProducerRegs = 24;  // setmaxnreg: 128 x 24 + 256 x 240 = 384 x 168
constexpr int kConsumerRegs = 240;

struct Strides {  // element strides of (batch, sequence, head); the head dim is unit
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

template <int DQK, int DV>
struct Tile {
  static_assert(DQK % 32 == 0 && DV % 32 == 0, "head dims must be multiples of 32");
  static constexpr int kBlockN = 64;  // keys per K/V stage
  static constexpr int kStages = DQK >= 256 ? 3 : 4;
  static constexpr int kQCols = DQK < 64 ? DQK : 64;  // columns of a panel (one TMA box)
  static constexpr int kVCols = DV < 64 ? DV : 64;
  static constexpr int kQRow = 2 * kQCols;  // bytes of a panel row = the swizzle span
  static constexpr int kVRow = 2 * kVCols;
  static constexpr int kQBytes = kBlockM * DQK * 2;
  static constexpr int kKBytes = kBlockN * DQK * 2;
  static constexpr int kVBytes = kBlockN * DV * 2;
  // Shared memory from a 1024-byte boundary: Q, each stage's K, each
  // stage's V (all whole swizzle atoms), each stage's key segment ids and
  // tile index, then the barriers; + 1024 to align the base.
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKBytes;
  static constexpr int kSegOff = kVOff + kStages * kVBytes;
  static constexpr int kTileOff = kSegOff + kStages * kBlockN * 4;
  static constexpr int kBarOff = (kTileOff + kStages * 4 + 7) / 8 * 8;
  static constexpr int kSmemBytes = kBarOff + (4 * kStages + 1) * 8 + 1024;
  static_assert(kSmemBytes <= 232448, "over the 227 KB a CTA may use");
};

// Keys that query rows [r0, min(r0 + rows, Sq)) can see: [x, y).
__device__ __forceinline__ int2 key_span(int r0, int rows, int Sq, int Sk, int causal, int q_off,
                                         int window) {
  const int row_end = min(r0 + rows, Sq);
  const int lo = window > 0 ? max(0, r0 + q_off - window + 1) : 0;
  int end = causal ? min(Sk, row_end + q_off) : Sk;
  if (window > 0 && !causal) end = min(end, row_end - 1 + q_off + window);
  return make_int2(lo, end);
}

template <int DQK, int DV, bool kSeg>
__global__ void __launch_bounds__(kThreads, 1)
    causal_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                           const int* __restrict__ q_seg, const int* __restrict__ kv_seg, int Sq,
                           int Sk, int H, long long o_b, long long o_s, long long o_h,
                           float scale_log2, int causal, int q_off, int group, int window) {
  using T = Tile<DQK, DV>;
  constexpr int kBlockN = T::kBlockN, kStages = T::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sK = smem + T::kKOff;  // stage s at s * kKBytes, panels of kBlockN rows
  unsigned char* sV = smem + T::kVOff;
  int* sKS = reinterpret_cast<int*>(smem + T::kSegOff);    // [stage][key]: kv segment ids
  int* sTile = reinterpret_cast<int*>(smem + T::kTileOff);  // [stage]: key tile, -1 = the end
  // K and V have rings of their own (full: loaded, empty: consumed), so a K
  // stage is refilled once its S = Q K^T is done and a V stage once its
  // P V is; the tile index and segment ids travel with K.
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + T::kBarOff);
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;
  uint64_t* q_full = v_empty + kStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&k_full[s], 32);  // every producer lane (lane 0 with the bytes)
      hp::mbar_init(&k_empty[s], 8);  // lane 0 of every consumer warp
      hp::mbar_init(&v_full[s], 1);
      hp::mbar_init(&v_empty[s], 8);
    }
    hp::mbar_init(q_full, 1);
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    // Producer warpgroup: warp 0 walks the key tiles and issues every load.
    hp::setmaxnreg_dec<kProducerRegs>();
    if (warp != 0) return;
    const int2 span = key_span(m0, kBlockM, Sq, Sk, causal, q_off, window);
    const int n_tiles = (max(span.y, 0) + kBlockN - 1) / kBlockN;
    const int* kvs = kSeg ? kv_seg + (long long)b * Sk : nullptr;
    int2 q_range = make_int2(INT_MIN, INT_MAX);
    if constexpr (kSeg) q_range = seg_range(q_seg + (long long)b * Sq, m0, kBlockM, Sq, lane);
    // The first key tile at or after j that some row of this tile may see.
    auto next_tile = [&](int j) {
      if constexpr (kSeg) {
        while (j < n_tiles &&
               !ranges_meet(seg_range(kvs, j * kBlockN, kBlockN, Sk, lane), q_range))
          ++j;
      }
      return j;
    };
    if (lane == 0) {
      hp::prefetch_map(&q_map);
      hp::prefetch_map(&k_map);
      hp::prefetch_map(&v_map);
      hp::mbar_arrive_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int p = 0; p < DQK / T::kQCols; ++p)
        hp::tma_load_4d(smem + p * kBlockM * T::kQRow, &q_map, q_full, p * T::kQCols, m0, h, b);
    }
    const int hk = h / group;  // GQA: the group's K/V head
    int j = next_tile(span.x / kBlockN);
    int stage = 0;
    unsigned phase = 0;
    while (true) {
      hp::mbar_wait(&k_empty[stage], phase ^ 1);
      const bool more = j < n_tiles;
      const int key0 = j * kBlockN;
      if (kSeg && more) {
        for (int r = lane; r < kBlockN; r += 32)
          sKS[stage * kBlockN + r] = key0 + r < Sk ? kvs[key0 + r] : INT_MIN;
      }
      if (lane == 0 && more) {
        sTile[stage] = j;
        hp::mbar_arrive_expect_tx(&k_full[stage], T::kKBytes);
        unsigned char* dst = sK + stage * T::kKBytes;
#pragma unroll
        for (int p = 0; p < DQK / T::kQCols; ++p)
          hp::tma_load_4d(dst + p * kBlockN * T::kQRow, &k_map, &k_full[stage], p * T::kQCols,
                          key0, hk, b);
      } else {
        if (lane == 0) sTile[stage] = -1;
        hp::mbar_arrive(&k_full[stage]);
      }
      if (!more) break;
      hp::mbar_wait(&v_empty[stage], phase ^ 1);
      if (lane == 0) {
        hp::mbar_arrive_expect_tx(&v_full[stage], T::kVBytes);
        unsigned char* dst = sV + stage * T::kVBytes;
#pragma unroll
        for (int p = 0; p < DV / T::kVCols; ++p)
          hp::tma_load_4d(dst + p * kBlockN * T::kVRow, &v_map, &v_full[stage], p * T::kVCols,
                          key0, hk, b);
      }
      j = next_tile(j + 1);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // Consumer warpgroups: rows [64 wg, 64 wg + 64) of the query tile.
    hp::setmaxnreg_inc<kConsumerRegs>();
    const int wg = warp / 4 - 1;
    const int g = lane >> 2, t = lane & 3;  // accumulator fragment row group / column pair
    const int r0 = m0 + wg * kWgRows;        // this warpgroup's first query row
    const int qr = wg * kWgRows + (warp & 3) * 16;  // this warp's first row in the tile
    // With a window: keys below band_lo_all are outside some row's band, and
    // (non-causal) so are keys at or above band_hi_all.
    const int band_lo_all = r0 + kWgRows + q_off - window;
    const int band_hi_all = r0 + q_off + window;
    int qs[2] = {0, 0};  // this thread's two rows' segment ids
    if constexpr (kSeg) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + qr + g + 8 * r;
        qs[r] = row < Sq ? q_seg[(long long)b * Sq + row] : INT_MIN;
      }
    }
    const unsigned char* sQw = smem + wg * kWgRows * T::kQRow;  // this warpgroup's Q rows
    // Ping-pong: the warpgroups take turns to issue their products (named
    // barriers 1 + wg), so one's softmax runs under the other's wgmma.
    const int my_turn = 1 + wg, their_turn = 2 - wg;
    if (wg == 1) hp::bar_arrive(1, 2 * 128);  // warpgroup 0 goes first

    float acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // running max of base-2 scores, rows g and g+8
    float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums
    // S of the current tile (fp32) and P of the previous one (bf16 A
    // fragments, waiting for its P V, issued with the next tile's S).
    float s[kBlockN / 2];
    uint32_t pa[kBlockN / 16][4];
    auto issue_qk = [&](int stage) {  // S = Q K^T: 64 rows x kBlockN keys, both K-major
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) s[i] = 0.f;
      hp::fence_regs(s);
      hp::wgmma_fence();
      const unsigned char* kt = sK + stage * T::kKBytes;
#pragma unroll
      for (int ks = 0; ks < DQK / 16; ++ks) {
        const int p = ks * 16 / T::kQCols, c = ks * 16 % T::kQCols * 2;  // panel, byte column
        const uint64_t da =
            hp::make_desc(sQw + p * kBlockM * T::kQRow + c, T::kQRow, 16, 8 * T::kQRow);
        const uint64_t db =
            hp::make_desc(kt + p * kBlockN * T::kQRow + c, T::kQRow, 16, 8 * T::kQRow);
        hp::wgmma_ss<0, 0>(s, da, db, ks > 0);
      }
      hp::wgmma_commit();
    };
    auto issue_pv = [&](int stage, unsigned phase) {  // O += P V, V MN-major (transposed B)
      hp::mbar_wait(&v_full[stage], phase);
      const unsigned char* vt = sV + stage * T::kVBytes;
      hp::fence_regs(acc);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        const uint64_t dv = hp::make_desc(vt + kk * 16 * T::kVRow, T::kVRow,
                                          kBlockN * T::kVRow, 8 * T::kVRow);
        hp::wgmma_rs<1>(acc, pa[kk], dv, 1);
      }
      hp::wgmma_commit();
    };
    // The online softmax of the tile at key0 on S (masked where the tile
    // straddles the diagonal, a band edge or the Sk tail, or carries
    // segments; a tile none of this warpgroup's rows sees is all masked and
    // leaves the running max / sum as they were); S becomes P. Returns the
    // rescale of the older terms, per row.
    auto softmax = [&](int stage, int key0, float (&alpha)[2]) {
      const bool masked =
          kSeg || key0 + kBlockN > Sk || (causal && key0 + kBlockN - 1 > r0 + q_off) ||
          (window > 0 && (key0 < band_lo_all || (!causal && key0 + kBlockN > band_hi_all)));
      // Element e of n-tile nt sits at key key0 + 2 t + c, c = 8 nt + (e & 1)
      // a compile-time constant: row r keeps it iff lo[r] <= c <= hi[r].
      const int* ids = sKS + stage * kBlockN + 2 * t;
      int lo[2], hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rel = m0 + qr + g + 8 * r + q_off - key0 - 2 * t;  // position - key base
        hi[r] = Sk - 1 - key0 - 2 * t;
        if (causal) hi[r] = min(hi[r], rel);
        if (window > 0 && !causal) hi[r] = min(hi[r], rel + window - 1);
        lo[r] = window > 0 ? rel - window + 1 : INT_MIN;
      }
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * nt + (e & 1), r = e >> 1;
          float x = s[4 * nt + e] * scale_log2;
          if (masked && (c > hi[r] || c < lo[r] || (kSeg && ids[c] != qs[r]))) x = -INFINITY;
          s[4 * nt + e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
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
      for (int i = 0; i < kBlockN / 2; ++i) {
        const float p = exp2f(s[i] - mx[(i >> 1) & 1]);
        s[i] = p;
        rs[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(bar);
    };

    hp::mbar_wait(q_full, 0);
    int stage = 0;
    unsigned phase = 0;
    hp::mbar_wait(&k_full[stage], phase);
    __syncwarp();
    int j = sTile[stage];
    if (j >= 0) {
      // The first tile: S, softmax, P; its P V goes out with the next S.
      hp::bar_sync(my_turn, 2 * 128);
      issue_qk(stage);
      hp::bar_arrive(their_turn, 2 * 128);
      hp::wgmma_wait<0>();
      hp::fence_regs(s);
      float alpha[2];
      softmax(stage, j * kBlockN, alpha);
      release(&k_empty[stage]);
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        acc_to_a_frag(pa[kk], &s[8 * kk], &s[8 * kk + 4]);
      int p_stage = stage;
      unsigned p_phase = phase;
      while (true) {
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
        hp::mbar_wait(&k_full[stage], phase);
        __syncwarp();
        j = sTile[stage];
        if (j < 0) break;
        hp::bar_sync(my_turn, 2 * 128);
        issue_qk(stage);
        issue_pv(p_stage, p_phase);  // the previous tile's P V runs under this S
        hp::bar_arrive(their_turn, 2 * 128);
        hp::wgmma_wait<1>();
        hp::fence_regs(s);
        softmax(stage, j * kBlockN, alpha);
        release(&k_empty[stage]);  // S and the tile's ids are used
        hp::wgmma_wait<0>();
        hp::fence_regs(acc);
        release(&v_empty[p_stage]);
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk)
          acc_to_a_frag(pa[kk], &s[8 * kk], &s[8 * kk + 4]);
        p_stage = stage;
        p_phase = phase;
      }
      issue_pv(p_stage, p_phase);
      hp::wgmma_wait<0>();
      hp::fence_regs(acc);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = m0 + qr + g + 8 * r;
      if (row >= Sq) continue;
      const float inv = l > 0.f ? 1.f / l : 0.f;  // a row that sees no key gets 0
      __nv_bfloat16* op = o + b * o_b + (long long)row * o_s + h * o_h;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        *reinterpret_cast<uint32_t*>(op + n * 8 + 2 * t) =
            pack_bf16(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
      }
      if (t == 0) {
        lse[((long long)b * H + h) * Sq + row] =
            l > 0.f ? (m_run[r] + log2f(l)) * kLn2 : -INFINITY;
      }
    }
  }
}

// fp32: one thread per query row, K/V tiles of 16 keys in shared memory,
// CUDA-core FMAs; q is read from global memory (L1) per key tile so that
// d_qk = 256 needs no register array. Numerics as the bf16 body; with
// segments every key is tested (no tile skipping: the parity checks' path).
constexpr int kF32Rows = 64;
constexpr int kF32Keys = 16;

template <int DQK, int DV, bool kSeg>
__global__ void __launch_bounds__(kF32Rows)
    causal_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, const int* __restrict__ q_seg,
                          const int* __restrict__ kv_seg, int Sq, int Sk, int H, Strides st,
                          float scale_log2, int causal, int q_off, int group, int window) {
  __shared__ float sK[kF32Keys][DQK];
  __shared__ float sV[kF32Keys][DV];
  __shared__ int sKS[kF32Keys];
  const int tid = threadIdx.x;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kF32Rows;
  const int row = m0 + tid;
  const int h = blockIdx.y, b = blockIdx.z;
  const float* kb = k + b * st.k_b + (h / group) * st.k_h;
  const float* vb = v + b * st.v_b + (h / group) * st.v_h;
  const bool valid = row < Sq;
  const float* qp = q + b * st.q_b + (long long)(valid ? row : 0) * st.q_s + h * st.q_h;
  const int row_end = min(m0 + kF32Rows, Sq);
  const int key_lo = window > 0 ? max(0, m0 + q_off - window + 1) : 0;
  int key_end = causal ? min(Sk, row_end + q_off) : Sk;
  if (window > 0 && !causal) key_end = min(key_end, row_end - 1 + q_off + window);
  // keys this row sees: [my_lo, my_end)
  const int pos = row + q_off;
  const int my_lo = window > 0 ? pos - window + 1 : 0;
  int my_end = causal ? min(Sk, pos + 1) : Sk;
  if (window > 0 && !causal) my_end = min(my_end, pos + window);
  const int qs = kSeg && valid ? q_seg[(long long)b * Sq + row] : 0;

  float acc[DV];
#pragma unroll
  for (int c = 0; c < DV; ++c) acc[c] = 0.f;
  float m_run = -INFINITY, l_run = 0.f;

  for (int k0 = key_lo / kF32Keys * kF32Keys; k0 < key_end; k0 += kF32Keys) {
    __syncthreads();
    for (int i = tid; i < kF32Keys * DQK; i += kF32Rows) {
      const int r = i / DQK, c = i - r * DQK;
      sK[r][c] = k0 + r < Sk ? kb[(long long)(k0 + r) * st.k_s + c] : 0.f;
    }
    for (int i = tid; i < kF32Keys * DV; i += kF32Rows) {
      const int r = i / DV, c = i - r * DV;
      sV[r][c] = k0 + r < Sk ? vb[(long long)(k0 + r) * st.v_s + c] : 0.f;
    }
    if (kSeg && tid < kF32Keys) {
      sKS[tid] = k0 + tid < Sk ? kv_seg[(long long)b * Sk + k0 + tid] : INT_MIN;
    }
    __syncthreads();
    float s[kF32Keys];
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DQK; ++c) {
      const float qc = valid ? qp[c] : 0.f;
#pragma unroll
      for (int j = 0; j < kF32Keys; ++j) s[j] = fmaf(qc, sK[j][c], s[j]);
    }
    float mx = m_run;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      const bool ok = k0 + j >= my_lo && k0 + j < my_end && (!kSeg || sKS[j] == qs);
      s[j] = ok ? s[j] * scale_log2 : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float m_use = mx == -INFINITY ? 0.f : mx;
    const float alpha = exp2f(m_run - m_use);
    m_run = mx;
    float p[kF32Keys];
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      p[j] = exp2f(s[j] - m_use);
      rs += p[j];
    }
    l_run = l_run * alpha + rs;
#pragma unroll
    for (int c = 0; c < DV; ++c) {
      float a = acc[c] * alpha;
#pragma unroll
      for (int j = 0; j < kF32Keys; ++j) a = fmaf(p[j], sV[j][c], a);
      acc[c] = a;
    }
  }
  if (!valid) return;
  const float inv = l_run > 0.f ? 1.f / l_run : 0.f;
  float* op = o + b * st.o_b + (long long)row * st.o_s + h * st.o_h;
#pragma unroll
  for (int c = 0; c < DV; ++c) op[c] = acc[c] * inv;
  lse[((long long)b * H + h) * Sq + row] = l_run > 0.f ? (m_run + log2f(l_run)) * kLn2 : -INFINITY;
}

template <int DQK, int DV, bool kSeg>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
                   const int* q_seg, const int* kv_seg, int B, int Sq, int Sk, int H, int Hkv,
                   const Strides& st, float scale_log2, int causal, int q_off, int group,
                   int window, cudaStream_t stream) {
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    using T = Tile<DQK, DV>;
    CUtensorMap maps[3];
    cudaError_t err = hp::encode_bshd(&maps[0], q, B, Sq, H, DQK, st.q_b, st.q_s, st.q_h,
                                      kBlockM, T::kQCols);
    if (err == cudaSuccess && Sk > 0)
      err = hp::encode_bshd(&maps[1], k, B, Sk, Hkv, DQK, st.k_b, st.k_s, st.k_h, T::kBlockN,
                            T::kQCols);
    if (err == cudaSuccess && Sk > 0)
      err = hp::encode_bshd(&maps[2], v, B, Sk, Hkv, DV, st.v_b, st.v_s, st.v_h, T::kBlockN,
                            T::kVCols);
    if (err != cudaSuccess) return err;
    if (Sk == 0) maps[1] = maps[2] = maps[0];  // no key tile is loaded: Q's map stands in
    auto kern = causal_fwd_bf16_kernel<DQK, DV, kSeg>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + kBlockM - 1) / kBlockM, H, B);
    kern<<<grid, kThreads, T::kSmemBytes, stream>>>(
        maps[0], maps[1], maps[2], static_cast<bf*>(o), lse, q_seg, kv_seg, Sq, Sk, H, st.o_b,
        st.o_s, st.o_h, scale_log2, causal, q_off, group, window);
  } else {
    const dim3 grid((Sq + kF32Rows - 1) / kF32Rows, H, B);
    causal_fwd_f32_kernel<DQK, DV, kSeg><<<grid, kF32Rows, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, q_seg, kv_seg, Sq, Sk, H, st,
        scale_log2, causal, q_off, group, window);
  }
  return cudaGetLastError();
}

}  // namespace


// C entry bound with ctypes. dtype: 0 = float32, 1 = bfloat16. q and k are
// (B, S, H, Dqk), v and o (B, S, H, Dv); `strides` holds 12 int64: (batch,
// seq, head) element strides of q, k, v, o. q_seg / kv_seg: (B, Sq) / (B, Sk)
// int32 contiguous segment ids, or both null (no segments). causal: 0 or 1;
// q_offset: the key index of query row 0. Hkv: K/V heads (H a multiple of
// it: grouped-query attention). window: the sliding window, <= 0 for none.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for an
// uninstantiated (Dqk, Dv) or dtype, H not a multiple of Hkv, or a bf16
// tensor cuTensorMapEncodeTiled refuses a TMA map for).
// Launches on `stream`; does not synchronise.
extern "C" int ivt_flash_fwd_causal(int dtype, const void* q, const void* k, const void* v,
                                    void* o, float* lse, const int* q_seg, const int* kv_seg,
                                    int B, int Sq, int Sk, int H, int Dqk, int Dv,
                                    const long long* strides, float scale, int causal,
                                    int q_offset, int Hkv, int window, void* stream) {
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  const float scale_log2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if ((q_seg == nullptr) != (kv_seg == nullptr)) return cudaErrorInvalidValue;
  if (Hkv <= 0 || H % Hkv != 0) return cudaErrorInvalidValue;
  const int group = H / Hkv;
  const bool seg = q_seg != nullptr;
#define IVT_CASE(DQK, DV)                                                                   \
  if (Dqk == DQK && Dv == DV)                                                               \
    return seg ? launch<DQK, DV, true>(dtype, q, k, v, o, lse, q_seg, kv_seg, B, Sq, Sk, H, \
                                       Hkv, st, scale_log2, causal, q_offset, group,        \
                                       window, s)                                           \
               : launch<DQK, DV, false>(dtype, q, k, v, o, lse, q_seg, kv_seg, B, Sq, Sk,   \
                                        H, Hkv, st, scale_log2, causal, q_offset, group,    \
                                        window, s);
  IVT_CASE(256, 128)
  IVT_CASE(192, 128)
  IVT_CASE(128, 128)
  IVT_CASE(64, 64)
  IVT_CASE(64, 32)
  IVT_CASE(32, 32)
#undef IVT_CASE
  return cudaErrorInvalidValue;
}
