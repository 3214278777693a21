// Paged absorbed-MLA decode for Hopper (sm_90a): one generated token per
// sequence attends over that sequence's latent cache in a shared page pool.
//
// Replaces internvideo_tpu/ops/paged_decode.py:47 `_decode_kernel`
// (launched by `paged_mla_decode` :131). Inputs: q_lat (B, H, R) and q_pe
// (B, H, P) (the absorbed query and the rotated rope query), the pool
// pages (num_pages, page_size, R + P), block_tables (B, max_pages) int32
// and seq_lens (B,) int32. Output (B, H, R): softmax over the sequence's
// first seq_len tokens of s = (q_lat . c + q_pe . p) * scale, times c.
// Only the first ceil(seq_len / page_size) block-table columns are read
// and slots at positions >= seq_len are never loaded, so stale entries of
// finished sequences or a trash page's garbage cannot reach a sum. A row
// with no token gets 0.
//
// What bounds it: the pool bytes of the sequences' tokens, read once. At
// the 8B decode shape (B 8, seq ~2048, R + P = 1024 bf16) that is 33.6 MB
// = 0.010 ms at 3.35 TB/s, against 2.0e9 FLOPs: bytes.
//
// The TPU kernel walks a sequence's pages in one grid row, carrying
// (m, l, acc) in VMEM from step to step; here blocks run in parallel and
// nothing carries over, so the walk is split (split-KV): each CTA owns
// `split_len` tokens of one sequence and writes its partial (acc, m, l); a
// second small kernel merges the splits by their (m, l). The pair is one
// launch of K6.
//
// bf16 (the serving paths; paged_decode_mma_kernel<R, P> at the (R, P) of
// qwen3_8b_mla (896, 128) and qwen3_2b_mla / internvideo25_hico_2b (512,
// 64), up to 32 heads): one CTA of 8 warps takes all heads of one sequence
// over one split, so each pool byte of the sequence is read once; grid
// (splits, B) with B x splits at most one CTA per SM (the CTA holds its SM:
// ~215 KB of shared memory), a single wave. Its tokens arrive 16 at a time
// through a 4-stage ring of shared-memory tiles: one bulk copy
// (cp.async.bulk) per token row of R + P values, 2 KB at the 8B shape,
// issued by the lanes of warp 0 (each block-table column read once, by one
// lane, and shuffled to the rows of its page), completing on the stage's
// mbarrier; rows are padded by 16 bytes so that ldmatrix's 8 rows fall on
// distinct banks. Rows past
// seq_len are never loaded (a partial last stage zeroes their latent
// columns, so its unused rows hold no NaN). Both products run on the
// tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate):
// - scores S (heads x 16 tokens) = [q_lat | q_pe] (padded to 32 rows, in
//   shared memory) . tile^T, the (R + P) / 16 k-steps dealt round-robin to
//   the 8 warps, their partial sums added in a fixed order through shared
//   memory;
// - the online softmax in fp32 (base 2), 8 threads a head, P rounded to
//   bf16 in shared memory with each head's rescale factor;
// - O (32 x R, fp32) += P . C, warp w owning latent columns
//   [w R / 8, (w + 1) R / 8) (112 accumulator registers a thread at R 896),
//   C read with ldmatrix.trans.
// wgmma was not taken: its M of 64 would pad the heads to 64 rows, and a
// 64 x 896 fp32 accumulator does not fit two warpgroups' registers; at
// ~2e9 FLOPs a step the product is a few microseconds on mma.sync against
// ~10 us of HBM.
//
// fp32 (the parity checks): grid (splits, head groups of 8, batch); a CTA
// streams its tokens 16 at a time into a double-buffered tile with
// cp.async (16-byte chunks, the page id read per token); warp h holds head
// h's [q_lat | q_pe] row in registers and computes its 16 scores with
// CUDA-core FMAs (lanes split the dot product) and its online-softmax
// update; each thread accumulates P . C for 4 adjacent latent columns of
// the 8 heads (so R <= 1024).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC, linked with the other sources into one shared
//        library (internvideo_tpu_torch/ops/_build.py).

#include "hopper.cuh"

namespace {

using namespace ivt;
namespace hp = ivt::hopper;

constexpr int kThreads = 256;
constexpr int kHeads = kThreads / 32;  // heads per CTA: one warp each
constexpr int kTokens = 16;            // tokens per shared-memory tile
constexpr int kMaxR = 4 * kThreads;    // 4 latent columns a thread
constexpr int kMaxC = kMaxR + 128;     // R + P held in registers by a warp

__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// A 16-byte chunk: 4 fp32 values.
struct Chunk {
  static constexpr int kN = 4;
  static constexpr int kPerLane = (kMaxC / kN + 31) / 32;  // chunks of a row per lane
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
  }
};

// 4 adjacent values of a row.
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}

// fp32. Partials: acc (B, splits, H, R) and (m, l) (B, splits, H, 2), base-2 m.
__global__ void __launch_bounds__(kThreads)
    paged_decode_split_kernel(const float* __restrict__ q_lat, const float* __restrict__ q_pe,
                              const float* __restrict__ pages, const int* __restrict__ block_tables,
                              const int* __restrict__ seq_lens, float* __restrict__ part_acc,
                              float* __restrict__ part_ml, int H, int R, int P, int page_size,
                              int max_pages, int split_len, float scale_log2) {
  using Ch = Chunk;
  const int split = blockIdx.x, b = blockIdx.z, n_splits = gridDim.x;
  const int h0 = blockIdx.y * kHeads, nh = min(kHeads, H - h0);
  const int C = R + P, n_ch = C / Ch::kN, r_ch = R / Ch::kN;  // chunks per row / of the latent
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int seq_len = seq_lens[b];
  const int t_begin = split * split_len;
  const int t_end = min(seq_len, t_begin + split_len);
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + kTokens - 1) / kTokens : 0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sTile = reinterpret_cast<float*>(smem_raw);              // 2 x (kTokens, C)
  float* sP = reinterpret_cast<float*>(sTile + 2 * kTokens * C);  // (kHeads, kTokens)
  float* sAlpha = sP + kHeads * kTokens;                          // (kHeads,)

  // Streams tile j (tokens t_begin + 16 j ...) into buffer j & 1; slots at
  // or past t_end are zero-filled and their pages never read.
  auto load_tile = [&](int j) {
    float* dst = sTile + (j & 1) * kTokens * C;
    const int t0 = t_begin + j * kTokens;
    for (int i = tid; i < kTokens * n_ch; i += kThreads) {
      const int tr = i / n_ch, ch = i - tr * n_ch;
      const int pos = t0 + tr;
      const float* src = pages;
      if (pos < t_end) {
        const int page = block_tables[(long long)b * max_pages + pos / page_size];
        src = pages + ((long long)page * page_size + pos % page_size) * C + ch * Ch::kN;
      }
      cp_async_16(dst + tr * C + ch * Ch::kN, src, pos < t_end);
    }
    cp_async_commit();
  };

  // This warp's head row [q_lat | q_pe] in registers, chunk lane + 32 i.
  float qv[Ch::kPerLane][Ch::kN];
  const long long qrow = (long long)b * H + h0 + warp;
#pragma unroll
  for (int i = 0; i < Ch::kPerLane; ++i) {
    const int ch = lane + 32 * i;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (warp < nh && ch < n_ch) {
      u = ch < r_ch ? reinterpret_cast<const uint4*>(q_lat + qrow * R)[ch]
                    : reinterpret_cast<const uint4*>(q_pe + qrow * P)[ch - r_ch];
    }
    Ch::unpack(u, qv[i]);
  }

  float acc[kHeads][4];
#pragma unroll
  for (int h = 0; h < kHeads; ++h) acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = 0.f;
  const int r0 = 4 * tid;  // this thread's latent columns [r0, r0 + 4)
  float m_run = -INFINITY, l_run = 0.f;  // head `warp`'s, the same in every lane

  if (n_tiles > 0) load_tile(0);
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_tile(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j landed in every thread's view
    const float* tile = sTile + (j & 1) * kTokens * C;
    const int t0 = t_begin + j * kTokens;

    if (warp < nh) {
      float sc[kTokens];
#pragma unroll
      for (int tr = 0; tr < kTokens; ++tr) {
        const uint4* row = reinterpret_cast<const uint4*>(tile + tr * C);
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < Ch::kPerLane; ++i) {
          const int ch = lane + 32 * i;
          if (ch < n_ch) {
            float f[Ch::kN];
            Ch::unpack(row[ch], f);
#pragma unroll
            for (int e = 0; e < Ch::kN; ++e) part = fmaf(qv[i][e], f[e], part);
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        sc[tr] = t0 + tr < t_end ? part * scale_log2 : -INFINITY;
      }
      float mx = m_run;
#pragma unroll
      for (int tr = 0; tr < kTokens; ++tr) mx = fmaxf(mx, sc[tr]);
      // t0 < t_end, so the tile has a real token and mx is finite
      const float alpha = exp2f(m_run - mx);  // 0 on the first tile (m_run = -inf)
      float rs = 0.f;
#pragma unroll
      for (int tr = 0; tr < kTokens; ++tr) {
        const float p = exp2f(sc[tr] - mx);  // masked: exp2(-inf) = 0
        rs += p;
        if (lane == tr) sP[warp * kTokens + tr] = p;
      }
      l_run = l_run * alpha + rs;
      m_run = mx;
      if (lane == 0) sAlpha[warp] = alpha;
    }
    __syncthreads();

    if (r0 < R) {
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        const float al = h < nh ? sAlpha[h] : 0.f;
        acc[h][0] *= al, acc[h][1] *= al, acc[h][2] *= al, acc[h][3] *= al;
      }
      for (int tr = 0; tr < kTokens; ++tr) {
        float c[4];
        load4(tile + tr * C + r0, c);
#pragma unroll
        for (int h = 0; h < kHeads; ++h) {
          const float p = h < nh ? sP[h * kTokens + tr] : 0.f;
          acc[h][0] = fmaf(p, c[0], acc[h][0]);
          acc[h][1] = fmaf(p, c[1], acc[h][1]);
          acc[h][2] = fmaf(p, c[2], acc[h][2]);
          acc[h][3] = fmaf(p, c[3], acc[h][3]);
        }
      }
    }
    __syncthreads();  // the next prefetch overwrites this buffer
  }

  const long long base = ((long long)b * n_splits + split) * H + h0;
  if (r0 < R) {
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      if (h < nh)
        *reinterpret_cast<float4*>(part_acc + (base + h) * R + r0) =
            make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
    }
  }
  if (warp < nh && lane == 0) {
    part_ml[(base + warp) * 2] = m_run;
    part_ml[(base + warp) * 2 + 1] = l_run;
  }
}

// ---- bf16: all heads of a sequence in one CTA, tensor cores ----------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMaxHeads = 32;    // two m16 tiles of heads
constexpr int kStageTokens = 16;  // tokens a stage: the scores' two n8 tiles, PV's k16
constexpr int kRingStages = 4;

template <int R, int P>
struct DecodeTile {
  static constexpr int kC = R + P;
  static_assert(kC % 16 == 0 && R % (16 * kMmaWarps) == 0, "k-steps of 16, n-tile pairs a warp");
  static constexpr int kRowBytes = 2 * kC + 16;  // a padded token (or head) row
  static constexpr int kKSteps = kC / 16;        // of the scores
  static constexpr int kCols = R / kMmaWarps;    // latent columns a warp owns
  static constexpr int kNTiles = kCols / 8;
  static constexpr int kRedStride = 20;  // floats a head row of one warp's partial scores
  static constexpr int kPStride = 24;    // bf16 a head row of P: 48 bytes, conflict-free ldmatrix
  // Shared memory: Q (32 head rows), the ring, the partial scores of every
  // warp, P, the rescale factors, the ring's and Q's barriers.
  static constexpr int kStageBytes = kStageTokens * kRowBytes;
  static constexpr int kRingOff = kMaxHeads * kRowBytes;
  static constexpr int kRedOff = kRingOff + kRingStages * kStageBytes;
  static constexpr int kPOff = kRedOff + kMmaWarps * kMaxHeads * kRedStride * 4;
  static constexpr int kAlphaOff = kPOff + kMaxHeads * kPStride * 2;
  static constexpr int kBarOff = kAlphaOff + kMaxHeads * 4;
  static constexpr int kSmemBytes = kBarOff + (kRingStages + 1) * 8;
  static_assert(kSmemBytes <= 232448, "over the 227 KB a CTA may use");
};

// Partials: acc (B, splits, H, R) and (m, l) (B, splits, H, 2), base-2 m,
// for the splits that hold tokens (the merge reads no other).
template <int R, int P>
__global__ void __launch_bounds__(kMmaThreads, 1)
    paged_decode_mma_kernel(const __nv_bfloat16* __restrict__ q_lat,
                            const __nv_bfloat16* __restrict__ q_pe,
                            const __nv_bfloat16* __restrict__ pages,
                            const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
                            float* __restrict__ part_acc, float* __restrict__ part_ml, int H,
                            int page_size, int max_pages, int split_len, float scale_log2) {
  using T = DecodeTile<R, P>;
  constexpr int C = T::kC;
  const int split = blockIdx.x, b = blockIdx.y, n_splits = gridDim.x;
  const int t_begin = split * split_len;
  const int t_end = min(seq_lens[b], t_begin + split_len);
  if (t_begin >= t_end) return;
  const int n_stages = (t_end - t_begin + kStageTokens - 1) / kStageTokens;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sQ = smem;
  unsigned char* sRing = smem + T::kRingOff;
  float* sRed = reinterpret_cast<float*>(smem + T::kRedOff);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + T::kPOff);
  float* sAlpha = reinterpret_cast<float*>(smem + T::kAlphaOff);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kBarOff);  // the ring's, then Q's
  uint64_t* q_full = full + kRingStages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  if (tid == 0) {
    for (int s = 0; s <= kRingStages; ++s) hp::mbar_init(&full[s], 1);
    hp::fence_barrier_init();
  }
  __syncthreads();

  // Stage j's tokens into ring slot j % kRingStages: one bulk copy a row
  // (warp 0, a lane a token), the bytes expected on the slot's barrier.
  // Each block-table column of the split is read once: lane i reads the
  // stage's i-th column unless it is the one the previous stage ended on
  // (kept in last_col / last_page), and each token's lane takes its page id
  // by a shuffle.
  int last_col = -1, last_page = 0;
  const int* table = block_tables + (long long)b * max_pages;
  auto issue = [&](int j) {
    const int t0 = t_begin + j * kStageTokens;
    const int n = min(kStageTokens, t_end - t0);
    uint64_t* bar = &full[j % kRingStages];
    if (lane == 0) hp::mbar_arrive_expect_tx(bar, n * C * 2);
    __syncwarp();
    const int col0 = t0 / page_size, n_cols = (t0 + n - 1) / page_size - col0 + 1;
    int my_page = 0;
    if (lane < n_cols) my_page = col0 + lane == last_col ? last_page : table[col0 + lane];
    const int pos = t0 + lane;
    const long long page =
        __shfl_sync(0xffffffffu, my_page, lane < n ? pos / page_size - col0 : 0);
    last_page = __shfl_sync(0xffffffffu, my_page, n_cols - 1);
    last_col = col0 + n_cols - 1;
    if (lane < n)
      hp::bulk_load(sRing + (j % kRingStages) * T::kStageBytes + lane * T::kRowBytes,
                    pages + (page * page_size + pos % page_size) * C, C * 2, bar);
  };
  // [q_lat | q_pe] of every head by bulk copies (lane h: head h's two
  // rows), rows past H zero; then the ring's first stages.
  if (warp == 0) {
    if (lane == 0) hp::mbar_arrive_expect_tx(q_full, H * C * 2);
    __syncwarp();
    if (lane < H) {
      const long long row = (long long)b * H + lane;
      hp::bulk_load(sQ + lane * T::kRowBytes, q_lat + row * R, R * 2, q_full);
      hp::bulk_load(sQ + lane * T::kRowBytes + R * 2, q_pe + row * P, P * 2, q_full);
    }
    for (int j = 0; j < min(kRingStages, n_stages); ++j) issue(j);
  }
  for (int i = tid; i < (kMaxHeads - H) * (C / 8); i += kMmaThreads) {
    const int h = H + i / (C / 8), ch = i % (C / 8);
    *reinterpret_cast<uint4*>(sQ + h * T::kRowBytes + ch * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  hp::mbar_wait(q_full, 0);

  float acc[2][T::kNTiles][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < T::kNTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  const int sh = tid >> 3, sp = tid & 7;  // softmax: head sh, tokens 2 sp and 2 sp + 1
  float m_run = -INFINITY, l_run = 0.f;   // head sh's (m the same in its 8 threads)
  const int c0 = warp * T::kCols;         // this warp's latent columns

  for (int j = 0; j < n_stages; ++j) {
    unsigned char* tile = sRing + (j % kRingStages) * T::kStageBytes;
    const int t0 = t_begin + j * kStageTokens;
    const int n_valid = min(kStageTokens, t_end - t0);
    hp::mbar_wait(&full[j % kRingStages], (j / kRingStages) & 1);
    if (n_valid < kStageTokens) {  // the last stage: rows it did not load hold zeros
      for (int i = tid; i < (kStageTokens - n_valid) * (R / 8); i += kMmaThreads) {
        const int r = n_valid + i / (R / 8), ch = i % (R / 8);
        *reinterpret_cast<uint4*>(tile + r * T::kRowBytes + ch * 16) = make_uint4(0u, 0u, 0u, 0u);
      }
      __syncthreads();
    }

    // Partial scores of this warp's k-steps: heads x tokens.
    float s[2][2][4] = {};
#pragma unroll
    for (int i = 0; i < (T::kKSteps + kMmaWarps - 1) / kMmaWarps; ++i) {
      const int ks = warp + i * kMmaWarps;
      if (T::kKSteps % kMmaWarps == 0 || ks < T::kKSteps) {
        uint32_t bk[4];  // tokens 0-7 / 8-15, columns 16 ks .. + 15
        ldmatrix_x4(bk, tile + ((lane >> 4) * 8 + (lane & 7)) * T::kRowBytes +
                            (ks * 16 + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t a[4];
          ldmatrix_x4(a, sQ + (16 * m + ((lane >> 3) & 1) * 8 + (lane & 7)) * T::kRowBytes +
                             (ks * 16 + (lane >> 4) * 8) * 2);
          mma_16816(s[m][0], a, &bk[0]);
          mma_16816(s[m][1], a, &bk[2]);
        }
      }
    }
    float* red = sRed + warp * kMaxHeads * T::kRedStride;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(red + (16 * m + g + 8 * r) * T::kRedStride + 8 * n + 2 * t) =
              make_float2(s[m][n][2 * r], s[m][n][2 * r + 1]);
    __syncthreads();

    // Online softmax of head sh over the stage's tokens; slots past t_end
    // are -inf (exp2 -> 0). The stage holds at least one token, so the max
    // of its 8 threads is finite.
    {
      float2 v = make_float2(0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kMmaWarps; ++w) {
        const float2 x =
            *reinterpret_cast<const float2*>(sRed + (w * kMaxHeads + sh) * T::kRedStride + 2 * sp);
        v.x += x.x;
        v.y += x.y;
      }
      const int tok = t0 + 2 * sp;
      const float x0 = tok < t_end ? v.x * scale_log2 : -INFINITY;
      const float x1 = tok + 1 < t_end ? v.y * scale_log2 : -INFINITY;
      float mx = fmaxf(m_run, fmaxf(x0, x1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float alpha = hp::exp2_ftz(m_run - mx);  // 0 on the first stage (m_run = -inf)
      const float p0 = hp::exp2_ftz(x0 - mx), p1 = hp::exp2_ftz(x1 - mx);
      l_run = l_run * alpha + p0 + p1;  // this thread's share
      m_run = mx;
      *reinterpret_cast<uint32_t*>(sP + sh * T::kPStride + 2 * sp) = pack_bf16(p0, p1);
      if (sp == 0) sAlpha[sh] = alpha;
    }
    __syncthreads();

    // O = alpha O + P . C over this warp's latent columns.
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float a0 = sAlpha[16 * m + g], a1 = sAlpha[16 * m + g + 8];
#pragma unroll
      for (int n = 0; n < T::kNTiles; ++n) {
        acc[m][n][0] *= a0, acc[m][n][1] *= a0;
        acc[m][n][2] *= a1, acc[m][n][3] *= a1;
      }
    }
    uint32_t pa[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
      ldmatrix_x4(pa[m], sP + (16 * m + ((lane >> 3) & 1) * 8 + (lane & 7)) * T::kPStride +
                             (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < T::kNTiles / 2; ++np) {
      uint32_t bv[4];  // tokens 0-7 / 8-15 of columns c0 + 16 np .. + 7 / + 8 .. + 15
      ldmatrix_x4_trans(bv, tile + (((lane >> 3) & 1) * 8 + (lane & 7)) * T::kRowBytes +
                                (c0 + np * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma_16816(acc[m][2 * np], pa[m], &bv[0]);
        mma_16816(acc[m][2 * np + 1], pa[m], &bv[2]);
      }
    }
    __syncthreads();  // every warp is done with the slot, P and the partial scores
    if (warp == 0 && j + kRingStages < n_stages) issue(j + kRingStages);
  }

  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 4);
  const long long base = ((long long)b * n_splits + split) * H;
  if (sp == 0 && sh < H) {
    part_ml[(base + sh) * 2] = m_run;
    part_ml[(base + sh) * 2 + 1] = l_run;
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int h = 16 * m + g + 8 * r;
      if (h >= H) continue;
#pragma unroll
      for (int n = 0; n < T::kNTiles; ++n)
        *reinterpret_cast<float2*>(part_acc + (base + h) * R + c0 + 8 * n + 2 * t) =
            make_float2(acc[m][n][2 * r], acc[m][n][2 * r + 1]);
    }
}

// out[b, h, :] = sum_s 2^(m_s - m) acc_s / sum_s 2^(m_s - m) l_s over the
// splits that hold tokens; 0 for a sequence with none. Grid (H, B). The
// splits' weights 2^(m_s - m) are formed once, in parallel, into shared
// memory (n_splits + n_splits floats of it); the sums then run over s in
// order, four splits' loads in flight at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_merge_kernel(const float* __restrict__ part_acc,
                              const float* __restrict__ part_ml, const int* __restrict__ seq_lens,
                              T* __restrict__ out, int H, int R, int n_splits, int split_len) {
  extern __shared__ float s_wl[];  // [split]: 2^(m_s - m), then [split]: l_s
  __shared__ float s_max[kThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int used = min(n_splits, (seq_lens[b] + split_len - 1) / split_len);
  const float* ml = part_ml + ((long long)b * n_splits * H + h) * 2;  // split s at s * H * 2
  float m = -INFINITY;
  for (int s = tid; s < used; s += kThreads) m = fmaxf(m, ml[(long long)s * H * 2]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((tid & 31) == 0) s_max[tid >> 5] = m;
  __syncthreads();
  m = s_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, s_max[w]);
  float* s_w = s_wl;
  float* s_l = s_wl + n_splits;
  for (int s = tid; s < used; s += kThreads) {
    s_w[s] = exp2f(ml[(long long)s * H * 2] - m);
    s_l[s] = ml[(long long)s * H * 2 + 1];
  }
  __syncthreads();
  float l = 0.f;
  for (int s = 0; s < used; ++s)
    if (s_l[s] > 0.f) l += s_w[s] * s_l[s];
  const float inv = l > 0.f ? 1.f / l : 0.f;
  const float* acc = part_acc + ((long long)b * n_splits * H + h) * R;  // split s at s * H * R
  for (int r = tid; r < R; r += kThreads) {
    float o = 0.f;
#pragma unroll 4
    for (int s = 0; s < used; ++s) {
      const float a = acc[(long long)s * H * R + r];  // a used split wrote its row
      if (s_l[s] > 0.f) o = fmaf(s_w[s], a, o);
    }
    from_f(out + ((long long)b * H + h) * R + r, o * inv);
  }
}

// The merge pass after a split pass, on `stream`.
template <typename T>
cudaError_t merge(const float* part_acc, const float* part_ml, const int* seq_lens, void* out,
                  int B, int H, int R, int n_splits, int split_len, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = 2 * n_splits * (int)sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  paged_decode_merge_kernel<T><<<dim3(H, B), kThreads, smem, stream>>>(
      part_acc, part_ml, seq_lens, static_cast<T*>(out), H, R, n_splits, split_len);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q_lat, const void* q_pe, const void* pages, const int* tables,
                       const int* seq_lens, float* part_acc, float* part_ml, void* out, int B,
                       int H, int R, int P, int page_size, int max_pages, int split_len,
                       int n_splits, float scale_log2, cudaStream_t stream) {
  const int smem = 2 * kTokens * (R + P) * 4 + (kHeads * kTokens + kHeads) * 4;
  auto kern = paged_decode_split_kernel;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(n_splits, (H + kHeads - 1) / kHeads, B), kThreads, smem, stream>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_pe),
      static_cast<const float*>(pages), tables, seq_lens, part_acc, part_ml, H, R, P, page_size,
      max_pages, split_len, scale_log2);
  return merge<float>(part_acc, part_ml, seq_lens, out, B, H, R, n_splits, split_len, stream);
}

template <int R, int P>
cudaError_t launch_bf16(const void* q_lat, const void* q_pe, const void* pages, const int* tables,
                        const int* seq_lens, float* part_acc, float* part_ml, void* out, int B,
                        int H, int page_size, int max_pages, int split_len, int n_splits,
                        float scale_log2, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  auto kern = paged_decode_mma_kernel<R, P>;
  constexpr int smem = DecodeTile<R, P>::kSmemBytes;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(n_splits, B), kMmaThreads, smem, stream>>>(
      static_cast<const bf*>(q_lat), static_cast<const bf*>(q_pe), static_cast<const bf*>(pages),
      tables, seq_lens, part_acc, part_ml, H, page_size, max_pages, split_len, scale_log2);
  return merge<bf>(part_acc, part_ml, seq_lens, out, B, H, R, n_splits, split_len, stream);
}

}  // namespace

// C entry bound with ctypes. dtype: 0 = float32, 1 = bfloat16 (q_lat, q_pe,
// pages and out alike); all arrays contiguous and 16-byte aligned, with R *
// sizeof(dtype) and P * sizeof(dtype) multiples of 16, R a multiple of 4,
// R <= 1024 and R + P <= 1152; bf16 takes (R, P) = (896, 128) or (512, 64)
// and H <= 32. part_acc (B, splits, H, R) and part_ml (B, splits, H, 2) are
// float32 scratch; split_len is a multiple of 16 and splits * split_len >=
// max_pages * page_size. Returns the cudaError_t of the launches
// (cudaErrorInvalidValue for what it does not take); launches on `stream`,
// does not synchronise.
extern "C" int ivt_paged_decode(int dtype, const void* q_lat, const void* q_pe, const void* pages,
                                const void* block_tables, const void* seq_lens, void* part_acc,
                                void* part_ml, void* out, int B, int H, int R, int P,
                                int page_size, int max_pages, int split_len, int n_splits,
                                float scale, void* stream) {
  const int item = dtype == 0 ? 4 : 2;
  if (R > kMaxR || R < 4 || R % 4 || R + P > kMaxC || (R * item) % 16 || (P * item) % 16 ||
      split_len % kTokens != 0 || n_splits < 1)
    return cudaErrorInvalidValue;
  const int* tables = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(seq_lens);
  float* acc = static_cast<float*>(part_acc);
  float* ml = static_cast<float*>(part_ml);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * kLog2e;
  if (dtype == 0)
    return launch_f32(q_lat, q_pe, pages, tables, lens, acc, ml, out, B, H, R, P, page_size,
                      max_pages, split_len, n_splits, scale_log2, s);
  if (dtype != 1 || H > kMaxHeads) return cudaErrorInvalidValue;
#define IVT_CASE(RR, PP)                                                                      \
  if (R == RR && P == PP)                                                                     \
    return launch_bf16<RR, PP>(q_lat, q_pe, pages, tables, lens, acc, ml, out, B, H, page_size, \
                               max_pages, split_len, n_splits, scale_log2, s);
  IVT_CASE(896, 128)
  IVT_CASE(512, 64)
#undef IVT_CASE
  return cudaErrorInvalidValue;
}
