// Causal flash-attention forward with a narrow value head for Hopper
// (sm_90a): the M2LA LLM's prefill attention, q/k at d_qk = nope + rope
// (256 on qwen3_8b_mla, 192 on qwen3_2b_mla and deepseek_v3, 128 on
// qwen3_moe_text, 64 on gpt_oss_moe_text) and v/o at d_v = 128 (64 on the
// two MoE models: d_qk 128 is two 64-column panels, d_v 64 one), inputs
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
//   swizzle; 64-byte at widths no multiple of 64), the online softmax in
//   the base-2 domain on the fp32 accumulator fragments, then O += P V as
//   wgmma with P converted to bf16 A fragments in registers (the RS form)
//   and V read from its (keys, d_v) tile with the transpose bit. A tile's
//   P V is issued together with the next tile's S (wait_group 1), so the
//   softmax of one tile runs while the other product is in flight, and the
//   two warpgroups take turns to issue (named barriers 1 and 2: ping-pong),
//   so one's softmax also runs under the other's products;
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
// K1 and K2 (flash_fwd.cu, small_s_fwd.cu: the InternVideo2 encoder and its
// finetune, the MAE teacher, the retrieval tower and rerank, the UMT
// student, the InternVideo3 / HiCo vision towers) run this body in bf16
// under their own kernel names (flash_fwd_wgmma_kernel,
// small_s_fwd_wgmma_kernel) at (D, D), non-causal, without segments, window
// or groups, launched by flash_fwd_wgmma (the end of this file). K3
// (fused_qkv.cu: the UMT student and the CLIP-6B teacher) runs the same
// walk with the QK-RMSNorm applied to the Q and K tiles in shared memory
// between TMA and wgmma (fused_qkv_fwd_wgmma_kernel, launched by
// fused_qkv_fwd_wgmma); K11 (fused_qkv_large.cu) runs it with only the Q
// tiles normed there and K read from rows its pre-pass normed once
// (fused_qkv_large_fwd_wgmma_kernel, launched by fused_qkv_large_fwd_wgmma).
// A head dim
// that is no multiple of 32 (88, 72) is stored as three 32-column panels of
// 64-byte swizzle (96 columns); each TMA map keeps the true width, so the
// columns past it load as zeros and add nothing to S, P V accumulates all
// 96 columns (48 registers, one m64n96 wgmma a k-step) and the stores write
// the true width. Every exp2 of the softmax is ex2.approx.ftz (hopper.cuh
// exp2_ftz), one SFU instruction: exp2f's subnormal handling cost K1 0.5-3 %
// and changed no output bit at its path shapes (PERF.md, section 6).
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
  static_assert(DQK % 8 == 0 && DV % 8 == 0, "head dims must be multiples of 8 (16-byte rows)");
  static constexpr int kBlockN = 64;  // keys per K/V stage
  // Panels of 64 columns where a head dim is a multiple of 64, else of 32
  // (one TMA box each); the stored widths kQW / kVW round up to whole panels
  // (88 -> 96, 72 -> 96), the columns past the true width zero-filled by TMA.
  static constexpr int kQCols = DQK % 64 == 0 ? 64 : 32;
  static constexpr int kVCols = DV % 64 == 0 ? 64 : 32;
  static constexpr int kQW = (DQK + kQCols - 1) / kQCols * kQCols;
  static constexpr int kVW = (DV + kVCols - 1) / kVCols * kVCols;
  static constexpr int kStages = kQW >= 256 ? 3 : 4;
  static constexpr int kQRow = 2 * kQCols;  // bytes of a panel row = the swizzle span
  static constexpr int kVRow = 2 * kVCols;
  static constexpr int kQBytes = kBlockM * kQW * 2;
  static constexpr int kKBytes = kBlockN * kQW * 2;
  static constexpr int kVBytes = kBlockN * kVW * 2;
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

// A consumer warpgroup's steps, shared by the body below and K3's and
// K11's kernels (which add the norm between them). S = Q K^T: the
// warpgroup's 64 Q rows (sQw) x the kBlockN keys of K tile kt, both K-major.
template <class T>
__device__ __forceinline__ void qk_product(float (&s)[T::kBlockN / 2], const unsigned char* sQw,
                                           const unsigned char* kt) {
#pragma unroll
  for (int i = 0; i < T::kBlockN / 2; ++i) s[i] = 0.f;
  hp::fence_regs(s);
  hp::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < T::kQW / 16; ++ks) {
    const int p = ks * 16 / T::kQCols, c = ks * 16 % T::kQCols * 2;  // panel, byte column
    const uint64_t da =
        hp::make_desc(sQw + p * kBlockM * T::kQRow + c, T::kQRow, 16, 8 * T::kQRow);
    const uint64_t db =
        hp::make_desc(kt + p * T::kBlockN * T::kQRow + c, T::kQRow, 16, 8 * T::kQRow);
    hp::wgmma_ss<0, 0>(s, da, db, ks > 0);
  }
  hp::wgmma_commit();
}

// O += P V once V tile vt has landed (v_full at phase), V MN-major
// (transposed B).
template <class T>
__device__ __forceinline__ void pv_product(float (&acc)[T::kVW / 2],
                                           const uint32_t (&pa)[T::kBlockN / 16][4],
                                           const unsigned char* vt, uint64_t* v_full,
                                           unsigned phase) {
  hp::mbar_wait(v_full, phase);
  hp::fence_regs(acc);
  hp::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::kBlockN / 16; ++kk) {
    const uint64_t dv = hp::make_desc(vt + kk * 16 * T::kVRow, T::kVRow,
                                      T::kBlockN * T::kVRow, 8 * T::kVRow);
    hp::wgmma_rs<1>(acc, pa[kk], dv, 1);
  }
  hp::wgmma_commit();
}

// The online softmax of one key tile on S; S becomes P. Where `masked`,
// element e of n-tile nt (key column c = 8 nt + (e & 1) past the thread's
// first, 2 t, a compile-time constant; row r = e >> 1) is kept iff
// lo[r] <= c <= hi[r] and, with segments, ids[c] == qs[r]. A tile none of
// the rows sees leaves the running max / sum as they were. Returns the
// rescale of the older terms, per row, in alpha.
template <int kBlockN, bool kSeg>
__device__ __forceinline__ void online_softmax(float (&s)[kBlockN / 2], float (&m_run)[2],
                                               float (&l_run)[2], float (&alpha)[2],
                                               float scale_log2, bool masked, const int (&lo)[2],
                                               const int (&hi)[2], const int* ids,
                                               const int (&qs)[2]) {
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
    alpha[r] = hp::exp2_ftz(m_run[r] - m_use);
    m_run[r] = mx[r];
    mx[r] = m_use;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kBlockN / 2; ++i) {
    const float p = hp::exp2_ftz(s[i] - mx[(i >> 1) & 1]);
    s[i] = p;
    rs[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
}

// The epilogue: this thread's rows row0 and row0 + 8 (those below Sq) of O
// divided by their sums, the true DV columns, at o + row * o_s, and their
// natural-log LSE at lse[row] where kLse.
template <int DV, bool kLse, int kAcc>
__device__ __forceinline__ void store_rows(const float (&acc)[kAcc], const float (&l_run)[2],
                                           const float (&m_run)[2], int row0, int Sq, int t,
                                           __nv_bfloat16* __restrict__ o, long long o_s,
                                           float* __restrict__ lse) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;  // a row that sees no key gets 0
    __nv_bfloat16* op = o + (long long)row * o_s;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      *reinterpret_cast<uint32_t*>(op + n * 8 + 2 * t) =
          pack_bf16(acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
    }
    if (kLse && t == 0) lse[row] = l > 0.f ? (m_run[r] + log2f(l)) * kLn2 : -INFINITY;
  }
}

// The bf16 kernel's body, behind K5's kernel and K1's and K2's (below); the
// maps are the kernel's __grid_constant__ parameters.
template <int DQK, int DV, bool kSeg>
__device__ __forceinline__ void fwd_bf16_body(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                              const CUtensorMap& v_map,
                                              __nv_bfloat16* __restrict__ o,
                                              float* __restrict__ lse,
                                              const int* __restrict__ q_seg,
                                              const int* __restrict__ kv_seg, int Sq, int Sk,
                                              int H, long long o_b, long long o_s, long long o_h,
                                              float scale_log2, int causal, int q_off, int group,
                                              int window) {
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
      for (int p = 0; p < T::kQW / T::kQCols; ++p)
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
        for (int p = 0; p < T::kQW / T::kQCols; ++p)
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
        for (int p = 0; p < T::kVW / T::kVCols; ++p)
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

    float acc[T::kVW / 2];
#pragma unroll
    for (int i = 0; i < T::kVW / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // running max of base-2 scores, rows g and g+8
    float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums
    // S of the current tile (fp32) and P of the previous one (bf16 A
    // fragments, waiting for its P V, issued with the next tile's S).
    float s[kBlockN / 2];
    uint32_t pa[kBlockN / 16][4];
    // The tile at key0 is masked where it straddles the diagonal, a band
    // edge or the Sk tail, or carries segments; each row keeps the columns
    // lo[r] <= c <= hi[r] (of the same segment).
    auto softmax = [&](int stage, int key0, float (&alpha)[2]) {
      const bool masked =
          kSeg || key0 + kBlockN > Sk || (causal && key0 + kBlockN - 1 > r0 + q_off) ||
          (window > 0 && (key0 < band_lo_all || (!causal && key0 + kBlockN > band_hi_all)));
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
      online_softmax<kBlockN, kSeg>(s, m_run, l_run, alpha, scale_log2, masked, lo, hi, ids, qs);
    };
    auto issue_qk = [&](int stage) { qk_product<T>(s, sQw, sK + stage * T::kKBytes); };
    auto issue_pv = [&](int stage, unsigned phase) {
      pv_product<T>(acc, pa, sV + stage * T::kVBytes, &v_full[stage], phase);
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
        for (int i = 0; i < T::kVW / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
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

    store_rows<DV, true>(acc, l_run, m_run, m0 + qr + g, Sq, t, o + b * o_b + h * o_h, o_s,
                         lse + ((long long)b * H + h) * Sq);
  }
}

// K5's bf16 kernel.
template <int DQK, int DV, bool kSeg>
__global__ void __launch_bounds__(kThreads, 1)
    causal_fwd_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                           const int* __restrict__ q_seg, const int* __restrict__ kv_seg, int Sq,
                           int Sk, int H, long long o_b, long long o_s, long long o_h,
                           float scale_log2, int causal, int q_off, int group, int window) {
  fwd_bf16_body<DQK, DV, kSeg>(q_map, k_map, v_map, o, lse, q_seg, kv_seg, Sq, Sk, H, o_b, o_s,
                               o_h, scale_log2, causal, q_off, group, window);
}

// K1's and K2's bf16 kernels (flash_fwd.cu's ivt_flash_fwd, small_s_fwd.cu's
// ivt_small_s_fwd): the same body at d_v = d_qk = D, non-causal, without
// segments, window or groups (compile-time constants here, so the per-tile
// mask test reduces to the Sk tail).
#define IVT_FWD_WGMMA_KERNEL(NAME)                                                            \
  template <int D>                                                                            \
  __global__ void __launch_bounds__(kThreads, 1)                                              \
      NAME(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map, \
           const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,          \
           float* __restrict__ lse, int Sq, int Sk, int H, long long o_b, long long o_s,      \
           long long o_h, float scale_log2) {                                                 \
    fwd_bf16_body<D, D, false>(q_map, k_map, v_map, o, lse, nullptr, nullptr, Sq, Sk, H, o_b, \
                               o_s, o_h, scale_log2, 0, 0, 1, 0);                             \
  }
IVT_FWD_WGMMA_KERNEL(flash_fwd_wgmma_kernel)
IVT_FWD_WGMMA_KERNEL(small_s_fwd_wgmma_kernel)
#undef IVT_FWD_WGMMA_KERNEL

// ---- K3 and K11: the forward with the QK-RMSNorm in shared memory ----------------------------

constexpr int kFusedMaxS = 1024;  // K3's S range, the small-S route's

// K3's shared memory: Tile<D, D>'s, then one more barrier and the head's k
// weights (kQW fp32, zero past D) and the sequence's k 1/rms (S fp32),
// which producer warp 1 stages at the start. K11 stages nothing and takes
// Tile<D, D>'s alone, so its S is not bounded by kFusedMaxS.
template <int D>
struct FusedTile {
  using T = Tile<D, D>;
  static constexpr int kRkBar = T::kBarOff + (4 * T::kStages + 1) * 8;
  static constexpr int kWOff = (kRkBar + 8 + 15) / 16 * 16;
  static constexpr int kROff = kWOff + T::kQW * 4;
  static constexpr int kSmemBytes = kROff + kFusedMaxS * 4 + 1024;
  static_assert(kSmemBytes <= 232448, "over the 227 KB a CTA may use");
};

// K3's and K11's walk (fused_qkv.cu's ivt_fused_qkv_fwd, fused_qkv_large.cu's
// ivt_fused_qkv_large_fwd): the body's walk at (D, D), non-causal, Sq = Sk
// = S, no LSE, one CTA per (128-query tile, head, batch), built from the
// same steps (qk_product, pv_product, online_softmax, store_rows), with the
// norm applied in shared memory by the consumers: each warpgroup norms its
// 64 rows of the Q tile once TMA lands it (hopper.cuh qk_norm_chunks:
// 16-byte chunks mapped back through the swizzle to their true columns, the
// padding columns of 88 / 72 left zero). With kNormK (K3) each also norms
// half the rows of each K stage, 32 at a time, the next tile's while this
// tile's products run, from the head's k weights and the sequence's k 1/rms
// that producer warp 1 stages in shared memory at the start; each fences
// its writes for wgmma (the async proxy), and the two tell each other
// through named barriers (a warpgroup arrives on the other's after its
// writes and syncs on its own before it issues S). Without kNormK (K11) the
// K map reads rows the pre-pass normed once, so the loop over K tiles is
// K1's: wait for the stage, S, softmax, P V; nothing staged grows with S.
// Every tile walks all ceil(S / 64) key tiles in order, so no tile index is
// handed on. A tile whose second warpgroup has no row (S = 257's, 1025's
// and 4097's 1-row last tile) runs the first alone: it norms whole K tiles,
// takes no turns, and the rings' release counts are set for it. Tried and
// dropped (PERF.md, section 6): the norm in the producer warpgroup's idle
// warps (they did not keep up), and the walk made persistent over work
// items (registers spilled; no faster).
template <int D, bool kNormK>
__device__ __forceinline__ void fused_qkv_fwd_body(const CUtensorMap& q_map,
                                                   const CUtensorMap& k_map,
                                                   const CUtensorMap& v_map,
                                                   __nv_bfloat16* __restrict__ o, int S, int H,
                                                   long long o_b, long long o_s, long long o_h,
                                                   float scale_log2, const QkNorm& nrm) {
  using T = Tile<D, D>;
  using F = FusedTile<D>;
  constexpr int kBlockN = T::kBlockN, kStages = T::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sK = smem + T::kKOff;
  unsigned char* sV = smem + T::kVOff;
  float* sWk = reinterpret_cast<float*>(smem + F::kWOff);
  float* sRk = reinterpret_cast<float*>(smem + F::kROff);
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + T::kBarOff);
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;
  uint64_t* q_full = v_empty + kStages;
  uint64_t* rk_full = reinterpret_cast<uint64_t*>(smem + F::kRkBar);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nk = (S + kBlockN - 1) / kBlockN;
  const bool solo = m0 + kWgRows >= S;  // only the first consumer warpgroup has rows
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&k_full[s], 1);
      hp::mbar_init(&k_empty[s], solo ? 4 : 8);  // lane 0 of every consumer warp
      hp::mbar_init(&v_full[s], 1);
      hp::mbar_init(&v_empty[s], solo ? 4 : 8);
    }
    hp::mbar_init(q_full, 1);
    if (kNormK) hp::mbar_init(rk_full, 32);  // every lane of producer warp 1
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    hp::setmaxnreg_dec<kProducerRegs>();
    if (kNormK && warp == 1) {
      // The k weights and 1/rms the consumers' K norm reads, staged once.
      for (int c = lane; c < T::kQW; c += 32) sWk[c] = c < D ? nrm.k_w[h * D + c] : 0.f;
#pragma unroll 4
      for (int r = lane; r < S; r += 32) sRk[r] = nrm.k_rstd[(long long)b * S + r];
      hp::mbar_arrive(rk_full);
    }
    if (warp == 0 && lane == 0) {
      // Producer: lane 0 issues every load.
      hp::prefetch_map(&q_map);
      hp::prefetch_map(&k_map);
      hp::prefetch_map(&v_map);
      hp::mbar_arrive_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int p = 0; p < T::kQW / T::kQCols; ++p)
        hp::tma_load_4d(smem + p * kBlockM * T::kQRow, &q_map, q_full, p * T::kQCols, m0, h, b);
      int stage = 0;
      unsigned phase = 0;
      for (int j = 0; j < nk; ++j) {
        hp::mbar_wait(&k_empty[stage], phase ^ 1);
        hp::mbar_arrive_expect_tx(&k_full[stage], T::kKBytes);
#pragma unroll
        for (int p = 0; p < T::kQW / T::kQCols; ++p)
          hp::tma_load_4d(sK + stage * T::kKBytes + p * kBlockN * T::kQRow, &k_map,
                          &k_full[stage], p * T::kQCols, j * kBlockN, h, b);
        hp::mbar_wait(&v_empty[stage], phase ^ 1);
        hp::mbar_arrive_expect_tx(&v_full[stage], T::kVBytes);
#pragma unroll
        for (int p = 0; p < T::kVW / T::kVCols; ++p)
          hp::tma_load_4d(sV + stage * T::kVBytes + p * kBlockN * T::kVRow, &v_map,
                          &v_full[stage], p * T::kVCols, j * kBlockN, h, b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumer warpgroups: rows [64 wg, 64 wg + 64) of the query tile.
  hp::setmaxnreg_inc<kConsumerRegs>();
  const int wg = warp / 4 - 1;
  if (solo && wg == 1) return;
  const int wt = tid - 128 * (wg + 1);    // this thread in its warpgroup
  const int g = lane >> 2, t = lane & 3;  // accumulator fragment row group / column pair
  const int qr = wg * kWgRows + (warp & 3) * 16;  // this warp's first row in the tile
  const unsigned char* sQw = smem + wg * kWgRows * T::kQRow;
  const float* k_w = sWk;
  const float* k_rs = sRk;
  // Ping-pong as in the body (named barriers 1 + wg); none alone.
  const int my_turn = 1 + wg, their_turn = 2 - wg;
  if (wg == 1) hp::bar_arrive(1, 2 * 128);  // warpgroup 0 goes first
  // "The other warpgroup's half of K tile j is normed": named barrier
  // 3 + 2 (j & 1) + wg, on which the other arrives; alternating with the
  // tile's parity, a warpgroup's arrival for tile j + 1 cannot meet the
  // other's wait for tile j. Alone, the first warpgroup syncs on 7.
  auto k_bar = [&](int j, int who) { return 3 + 2 * (j & 1) + who; };
  // K tile j in stage st once TMA lands it: this warpgroup's half of the
  // rows (all of them alone), fenced for wgmma, then the other told.
  auto norm_k = [&](int st, unsigned ph, int j) {
    hp::mbar_wait(&k_full[st], ph);
    unsigned char* kt = sK + st * T::kKBytes;
    const int key0 = j * kBlockN;
    // 32 rows a call: fewer live registers beside the products in flight
    for (int r_lo = solo ? 0 : wg * 32; r_lo < (solo ? kBlockN : wg * 32 + 32); r_lo += 32)
      hp::qk_norm_chunks<32, kBlockN, T::kQCols, T::kQW, D, 128>(kt, r_lo, S - key0 - r_lo, wt,
                                                                  k_w, k_rs + key0 + r_lo);
    hp::fence_proxy_async();
    if (!solo) hp::bar_arrive(k_bar(j, 1 - wg), 2 * 128);
  };
  // Before S of tile j (in stage st): every row of its K normed and fenced
  // (kNormK), or landed.
  auto k_ready = [&](int st, unsigned ph, int j) {
    if constexpr (!kNormK)
      hp::mbar_wait(&k_full[st], ph);
    else if (solo)
      hp::bar_sync(7, 128);
    else
      hp::bar_sync(k_bar(j, wg), 2 * 128);
  };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(bar);
  };

  float acc[T::kVW / 2];
#pragma unroll
  for (int i = 0; i < T::kVW / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float s[kBlockN / 2];
  uint32_t pa[kBlockN / 16][4];
  auto issue_qk = [&](int st) { qk_product<T>(s, sQw, sK + st * T::kKBytes); };
  auto issue_pv = [&](int st, unsigned ph) {
    pv_product<T>(acc, pa, sV + st * T::kVBytes, &v_full[st], ph);
  };
  // Keys past S masked.
  auto softmax = [&](int key0, float (&alpha)[2]) {
    const int last = S - 1 - key0 - 2 * t;  // element column c is a key iff c <= last
    const int lo[2] = {INT_MIN, INT_MIN}, hi[2] = {last, last}, qs[2] = {0, 0};
    online_softmax<kBlockN, false>(s, m_run, l_run, alpha, scale_log2, key0 + kBlockN > S, lo,
                                   hi, nullptr, qs);
  };

  // This warpgroup's Q rows normed; the first tile: its K normed, S,
  // softmax, P; the next K normed under S; its P V goes out with the next S.
  hp::mbar_wait(q_full, 0);
  for (int r_lo = wg * kWgRows; r_lo < wg * kWgRows + kWgRows; r_lo += 32)
    hp::qk_norm_chunks<32, kBlockM, T::kQCols, T::kQW, D, 128>(
        smem, r_lo, S - m0 - r_lo, wt, nrm.q_w + h * D, nrm.q_rstd + (long long)b * S + m0 + r_lo);
  if constexpr (!kNormK) {
    // Without a K norm to fence them, the Q writes are fenced here and the
    // warpgroup meets (named barrier 3 + wg) before its first S reads them.
    hp::fence_proxy_async();
    hp::bar_sync(3 + wg, 128);
  }
  int stage = 0;
  unsigned phase = 0;
  if constexpr (kNormK) {
    hp::mbar_wait(rk_full, 0);
    norm_k(stage, phase, 0);
  }
  k_ready(stage, phase, 0);
  if (!solo) hp::bar_sync(my_turn, 2 * 128);
  issue_qk(stage);
  if (!solo) hp::bar_arrive(their_turn, 2 * 128);
  if (kNormK && nk > 1) norm_k(stage + 1 == kStages ? 0 : stage + 1, 0, 1);
  hp::wgmma_wait<0>();
  hp::fence_regs(s);
  float alpha[2];
  softmax(0, alpha);
  release(&k_empty[stage]);
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) acc_to_a_frag(pa[kk], &s[8 * kk], &s[8 * kk + 4]);
  int p_stage = stage;
  unsigned p_phase = phase;
  for (int j = 1; j < nk; ++j) {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
    k_ready(stage, phase, j);
    if (!solo) hp::bar_sync(my_turn, 2 * 128);
    issue_qk(stage);
    issue_pv(p_stage, p_phase);  // the previous tile's P V runs under this S
    if (!solo) hp::bar_arrive(their_turn, 2 * 128);
    if (kNormK && j + 1 < nk) {
      const int ns = stage + 1 == kStages ? 0 : stage + 1;
      norm_k(ns, ns == 0 ? phase ^ 1 : phase, j + 1);
    }
    hp::wgmma_wait<1>();
    hp::fence_regs(s);
    softmax(j * kBlockN, alpha);
    release(&k_empty[stage]);
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    release(&v_empty[p_stage]);
#pragma unroll
    for (int i = 0; i < T::kVW / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) acc_to_a_frag(pa[kk], &s[8 * kk], &s[8 * kk + 4]);
    p_stage = stage;
    p_phase = phase;
  }
  issue_pv(p_stage, p_phase);
  hp::wgmma_wait<0>();
  hp::fence_regs(acc);
  store_rows<D, false>(acc, l_run, m_run, m0 + qr + g, S, t, o + b * o_b + h * o_h, o_s,
                       nullptr);
}

// K3's bf16 kernel: q and k normed in shared memory. K11's: k read normed
// from the pre-pass's buffer, only q normed in shared memory.
#define IVT_FUSED_WGMMA_KERNEL(NAME, NORM_K)                                                 \
  template <int D>                                                                           \
  __global__ void __launch_bounds__(kThreads, 1)                                             \
      NAME(const __grid_constant__ CUtensorMap q_map,                                        \
           const __grid_constant__ CUtensorMap k_map,                                        \
           const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o, int S,  \
           int H, long long o_b, long long o_s, long long o_h, float scale_log2, QkNorm nrm) { \
    fused_qkv_fwd_body<D, NORM_K>(q_map, k_map, v_map, o, S, H, o_b, o_s, o_h, scale_log2,  \
                                  nrm);                                                      \
  }
IVT_FUSED_WGMMA_KERNEL(fused_qkv_fwd_wgmma_kernel, true)
IVT_FUSED_WGMMA_KERNEL(fused_qkv_large_fwd_wgmma_kernel, false)
#undef IVT_FUSED_WGMMA_KERNEL

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

// The three TMA maps (q, k, v) of a bf16 launch of tile Tile<DQK, DV>, and
// `kern`'s shared-memory size set.
template <int DQK, int DV, typename Kernel>
cudaError_t prepare_bf16(Kernel kern, CUtensorMap (&maps)[3], const void* q, const void* k,
                         const void* v, int B, int Sq, int Sk, int H, int Hkv, const Strides& st) {
  using T = Tile<DQK, DV>;
  cudaError_t err = hp::encode_bshd(&maps[0], q, B, Sq, H, DQK, st.q_b, st.q_s, st.q_h, kBlockM,
                                    T::kQCols);
  if (err == cudaSuccess && Sk > 0)
    err = hp::encode_bshd(&maps[1], k, B, Sk, Hkv, DQK, st.k_b, st.k_s, st.k_h, T::kBlockN,
                          T::kQCols);
  if (err == cudaSuccess && Sk > 0)
    err = hp::encode_bshd(&maps[2], v, B, Sk, Hkv, DV, st.v_b, st.v_s, st.v_h, T::kBlockN,
                          T::kVCols);
  if (err != cudaSuccess) return err;
  if (Sk == 0) maps[1] = maps[2] = maps[0];  // no key tile is loaded: Q's map stands in
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
}

template <int DQK, int DV, bool kSeg>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
                   const int* q_seg, const int* kv_seg, int B, int Sq, int Sk, int H, int Hkv,
                   const Strides& st, float scale_log2, int causal, int q_off, int group,
                   int window, cudaStream_t stream) {
  if (dtype == 1) {
    auto kern = causal_fwd_bf16_kernel<DQK, DV, kSeg>;
    CUtensorMap maps[3];
    const cudaError_t err = prepare_bf16<DQK, DV>(kern, maps, q, k, v, B, Sq, Sk, H, Hkv, st);
    if (err != cudaSuccess) return err;
    kern<<<dim3((Sq + kBlockM - 1) / kBlockM, H, B), kThreads, Tile<DQK, DV>::kSmemBytes,
           stream>>>(maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), lse, q_seg,
                     kv_seg, Sq, Sk, H, st.o_b, st.o_s, st.o_h, scale_log2, causal, q_off, group,
                     window);
  } else {
    const dim3 grid((Sq + kF32Rows - 1) / kF32Rows, H, B);
    causal_fwd_f32_kernel<DQK, DV, kSeg><<<grid, kF32Rows, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, q_seg, kv_seg, Sq, Sk, H, st,
        scale_log2, causal, q_off, group, window);
  }
  return cudaGetLastError();
}

// A bf16 launch of K1's or K2's kernel `kern` at head dim D.
template <int D, typename Kernel>
cudaError_t launch_wgmma(Kernel kern, const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int Sq, int Sk, int H, const Strides& st,
                         float scale_log2, cudaStream_t stream) {
  CUtensorMap maps[3];
  const cudaError_t err = prepare_bf16<D, D>(kern, maps, q, k, v, B, Sq, Sk, H, H, st);
  if (err != cudaSuccess) return err;
  kern<<<dim3((Sq + kBlockM - 1) / kBlockM, H, B), kThreads, Tile<D, D>::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, H, st.o_b, st.o_s,
      st.o_h, scale_log2);
  return cudaGetLastError();
}

// A bf16 launch of K3's (kNormK) or K11's kernel `kern` at head dim D: q and
// v the column views [0, W) and [2W, 3W) of `qkv`, k at `k`, each with its
// strides in st.
template <int D, bool kNormK, typename Kernel>
cudaError_t launch_fused(Kernel kern, const __nv_bfloat16* qkv, const void* k, const QkNorm& nrm,
                         void* o, int B, int S, int H, const Strides& st, float scale_log2,
                         cudaStream_t stream) {
  constexpr int kSmem = kNormK ? FusedTile<D>::kSmemBytes : Tile<D, D>::kSmemBytes;
  const long long W = (long long)H * D;
  CUtensorMap maps[3];
  cudaError_t err = prepare_bf16<D, D>(kern, maps, qkv, k, qkv + 2 * W, B, S, S, H, H, st);
  if (err != cudaSuccess) return err;
  if (kNormK) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3((S + kBlockM - 1) / kBlockM, H, B), kThreads, kSmem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), S, H, st.o_b, st.o_s, st.o_h,
      scale_log2, nrm);
  return cudaGetLastError();
}

Strides make_strides(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
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
  const Strides st = make_strides(strides);
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
  IVT_CASE(128, 64)
  IVT_CASE(64, 64)
  IVT_CASE(64, 32)
  IVT_CASE(32, 32)
#undef IVT_CASE
  return cudaErrorInvalidValue;
}

namespace ivt {

// K1's and K2's bf16 launches, called by flash_fwd.cu's ivt_flash_fwd
// (small_s = false: flash_fwd_wgmma_kernel, head dims 64, 88 and 128) and
// small_s_fwd.cu's ivt_small_s_fwd (small_s = true: small_s_fwd_wgmma_kernel,
// 64, 72, 88 and 128), with their C entries' arguments (12 strides: q, k, v,
// o): this file's body at (D, D), non-causal, without segments, window or
// groups. Returns cudaErrorInvalidValue for another head dim, or a tensor
// cuTensorMapEncodeTiled refuses a TMA map for.
cudaError_t flash_fwd_wgmma(bool small_s, const void* q, const void* k, const void* v, void* o,
                            float* lse, int B, int Sq, int Sk, int H, int D,
                            const long long* strides, float scale, void* stream) {
  const Strides st = make_strides(strides);
  const float sl2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IVT_CASE(KERNEL, DIM)                                                              \
  if (D == DIM)                                                                            \
    return launch_wgmma<DIM>(KERNEL<DIM>, q, k, v, o, lse, B, Sq, Sk, H, st, sl2, s);
  if (small_s) {
    IVT_CASE(small_s_fwd_wgmma_kernel, 64)
    IVT_CASE(small_s_fwd_wgmma_kernel, 72)
    IVT_CASE(small_s_fwd_wgmma_kernel, 88)
    IVT_CASE(small_s_fwd_wgmma_kernel, 128)
  } else {
    IVT_CASE(flash_fwd_wgmma_kernel, 64)
    IVT_CASE(flash_fwd_wgmma_kernel, 88)
    IVT_CASE(flash_fwd_wgmma_kernel, 128)
  }
#undef IVT_CASE
  return cudaErrorInvalidValue;
}

// K3's bf16 launch, called by fused_qkv.cu's ivt_fused_qkv_fwd with its
// arguments: q, k and v are the column views [0, W), [W, 2W), [2W, 3W) of
// the (B, S, 3W) projection `qkv` (element strides s_b, s_s; W = H * D);
// head dims 64, 72, 88 and 128. Returns cudaErrorInvalidValue for another
// head dim, or a tensor cuTensorMapEncodeTiled refuses a TMA map for.
cudaError_t fused_qkv_fwd_wgmma(const void* qkv, const QkNorm& nrm, void* o, int B, int S, int H,
                                int D, long long s_b, long long s_s, long long o_b, long long o_s,
                                long long o_h, float scale, void* stream) {
  const Strides st{s_b, s_s, D, s_b, s_s, D, s_b, s_s, D, o_b, o_s, o_h};
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  const long long W = (long long)H * D;
  const float sl2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S > kFusedMaxS) return cudaErrorInvalidValue;
#define IVT_CASE(DIM)                                                                     \
  if (D == DIM)                                                                           \
    return launch_fused<DIM, true>(fused_qkv_fwd_wgmma_kernel<DIM>, q, q + W, nrm, o, B, S, H, \
                                   st, sl2, s);
  IVT_CASE(64)
  IVT_CASE(72)
  IVT_CASE(88)
  IVT_CASE(128)
#undef IVT_CASE
  return cudaErrorInvalidValue;
}

// K11's bf16 launch, called by fused_qkv_large.cu's ivt_fused_qkv_large_fwd
// with its arguments: q and v are the column views [0, W) and [2W, 3W) of
// the (B, S, 3W) projection `qkv` (element strides s_b, s_s; W = H * D), k
// the pre-pass's normed rows `k_normed`, (B, S, W) contiguous; nrm's q_rstd
// and q_w norm the Q tiles (its k fields are not read); head dims 64 and 88.
// Returns cudaErrorInvalidValue for another head dim, or a tensor
// cuTensorMapEncodeTiled refuses a TMA map for.
cudaError_t fused_qkv_large_fwd_wgmma(const void* qkv, const void* k_normed, const QkNorm& nrm,
                                      void* o, int B, int S, int H, int D, long long s_b,
                                      long long s_s, long long o_b, long long o_s, long long o_h,
                                      float scale, void* stream) {
  const long long W = (long long)H * D;
  const Strides st{s_b, s_s, D, S * W, W, D, s_b, s_s, D, o_b, o_s, o_h};
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  const float sl2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define IVT_CASE(DIM)                                                                         \
  if (D == DIM)                                                                               \
    return launch_fused<DIM, false>(fused_qkv_large_fwd_wgmma_kernel<DIM>, q, k_normed, nrm, o, \
                                    B, S, H, st, sl2, s);
  IVT_CASE(64)
  IVT_CASE(88)
#undef IVT_CASE
  return cudaErrorInvalidValue;
}

}  // namespace ivt
