// Causal flash-attention forward with a narrow value head for Hopper
// (sm_90a): the M2LA LLM's prefill attention, q/k at d_qk = nope + rope
// (256 on qwen3_8b_mla, 192 on qwen3_2b_mla) and v/o at d_v = 128, inputs
// in (B, S, H, D) with any element strides (a (B, H, S, D) view included).
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
//
// With a window of w the work is linear in S: each row sees at most w keys,
// so at (8, 2048, 32 / 8, 128) with w = 128 the 6.5e7 visible pairs (4 * d
// FLOPs each, 33 GFLOP) take 34 us at the tensor cores' rate against 0.34 GB
// of q/k/v/out (0.1 ms): bytes. GQA reads each K/V tile once per q head of its group (from L2 for
// all but the first), so the DRAM bytes stay those of the Hkv heads.
//
// Design (right and simple first, as K1 in attn_fwd.cuh): one CTA per
// (64-query tile, head, batch), the last query tiles (the most key tiles)
// launched first; 4 warps of 16 query rows; K tiles (d_qk) and V tiles
// (d_v) of 64 keys in separate shared-memory buffers filled with cp.async
// (double-buffered below d_qk = 256, see Tile::kStages); QK^T and PV on
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with P kept in registers
// between the two; online softmax in the base-2 domain. Q stays in shared
// memory and its A fragments are loaded per k-step, so d_qk = 256 costs no
// registers beyond K1's (the 128-wide fp32 output accumulator is 64
// registers a thread). fp32 inputs
// take a CUDA-core FMA kernel (the parity checks and the fp32 token-
// identity check, not the bf16 main path). wgmma, TMA and warp
// specialisation are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC, linked with the other sources into one shared
//        library (internvideo_tpu_torch/ops/_build.py).

#include "segments.cuh"

namespace {

using namespace ivt;

constexpr int kBlockM = 64;  // query rows per CTA (4 warps x 16)
constexpr int kBlockN = 64;  // keys per K/V tile
constexpr int kThreads = 128;

struct Strides {  // element strides of (batch, sequence, head); the head dim is unit
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

template <int DQK, int DV>
struct Tile {
  static_assert(DQK % 16 == 0 && DV % 16 == 0, "head dims must be multiples of 16");
  static constexpr int kQStride = DQK + 8;  // smem row: +16 B avoids bank conflicts
  static constexpr int kVStride = DV + 8;
  static constexpr int kQTile = kBlockM * kQStride;
  static constexpr int kKTile = kBlockN * kQStride;
  static constexpr int kVTile = kBlockN * kVStride;
  // K/V buffers: two (prefetch the next tile) where two CTAs still fit an
  // SM; at d_qk = 256 one, so that two CTAs (8 warps) share the SM and one's
  // loads overlap the other's products (1 CTA of 4 warps ran at 83 TFLOP/s).
  static constexpr int kStages = DQK >= 256 ? 1 : 2;
  // + the key tile's segment ids (kSeg)
  static constexpr int kSmemBytes = (kQTile + kStages * (kKTile + kVTile)) * 2 + kBlockN * 4;
};

template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int dst_stride,
                                          const __nv_bfloat16* src, long long s_stride, int row0,
                                          int valid, int tid) {
  cp_rows<D, kBlockM, kThreads>(dst, dst_stride, src, s_stride, row0, valid, tid);
}

template <int DQK, int DV, bool kSeg>
__global__ void __launch_bounds__(kThreads)
    causal_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, const int* __restrict__ q_seg,
                           const int* __restrict__ kv_seg, int Sq, int Sk, int H, Strides st,
                           float scale_log2, int causal, int q_off, int group, int window) {
  using T = Tile<DQK, DV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + T::kQTile;             // kStages buffers
  __nv_bfloat16* sV = sK + T::kStages * T::kKTile;  // kStages buffers
  int* sKS = reinterpret_cast<int*>(sV + T::kStages * T::kVTile);  // the tile's kv ids

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qb = q + b * st.q_b + h * st.q_h;
  const __nv_bfloat16* kb = k + b * st.k_b + (h / group) * st.k_h;  // GQA: the group's K/V head
  const __nv_bfloat16* vb = v + b * st.v_b + (h / group) * st.v_h;
  const int qr = warp * 16;  // this warp's first row in the query tile

  // Keys any stored row of this tile can see: [key_lo, key_end).
  const int row_end = min(m0 + kBlockM, Sq);
  const int key_lo = window > 0 ? max(0, m0 + q_off - window + 1) : 0;
  int key_end = causal ? min(Sk, row_end + q_off) : Sk;
  if (window > 0 && !causal) key_end = min(key_end, row_end - 1 + q_off + window);
  const int n_tiles = (max(key_end, 0) + kBlockN - 1) / kBlockN;
  // With a window: keys below band_lo_all are outside some row's band, and
  // (non-causal) so are keys at or above band_hi_all.
  const int band_lo_all = m0 + kBlockM + q_off - window;
  const int band_hi_all = m0 + q_off + window;

  // Segments: the query tile's id range, this thread's two rows' ids.
  const int* kvs = kSeg ? kv_seg + (long long)b * Sk : nullptr;
  int2 q_range = make_int2(INT_MIN, INT_MAX);
  int qs[2] = {0, 0};
  if constexpr (kSeg) {
    const int* qsb = q_seg + (long long)b * Sq;
    q_range = seg_range(qsb, m0, kBlockM, Sq, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + qr + g + 8 * r;
      qs[r] = row < Sq ? qsb[row] : INT_MIN;
    }
  }
  // The first key tile at or after j that some row of this tile may see.
  auto next_tile = [&](int j) {
    if constexpr (kSeg) {
      while (j < n_tiles && !ranges_meet(seg_range(kvs, j * kBlockN, kBlockN, Sk, lane), q_range))
        ++j;
    }
    return j;
  };

  int j = next_tile(key_lo / kBlockN);
  load_rows<DQK>(sQ, T::kQStride, qb, st.q_s, m0, Sq, tid);
  if (j < n_tiles) {
    load_rows<DQK>(sK, T::kQStride, kb, st.k_s, j * kBlockN, Sk, tid);
    load_rows<DV>(sV, T::kVStride, vb, st.v_s, j * kBlockN, Sk, tid);
  }
  cp_async_commit();

  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max of base-2 scores, rows g and g+8
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums

  int cur = 0;
  while (j < n_tiles) {
    const int jn = next_tile(j + 1);
    if (T::kStages == 2 && jn < n_tiles) {
      load_rows<DQK>(sK + (cur ^ 1) * T::kKTile, T::kQStride, kb, st.k_s, jn * kBlockN, Sk, tid);
      load_rows<DV>(sV + (cur ^ 1) * T::kVTile, T::kVStride, vb, st.v_s, jn * kBlockN, Sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const int key0 = j * kBlockN;
    if constexpr (kSeg) {
      if (tid < kBlockN) sKS[tid] = key0 + tid < Sk ? kvs[key0 + tid] : INT_MIN;
    }
    __syncthreads();
    const __nv_bfloat16* sKc = sK + cur * T::kKTile;
    const __nv_bfloat16* sVc = sV + cur * T::kVTile;

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys);
    // Q's A fragment comes from shared memory once per k-step.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < DQK / 16; ++ks) {
      uint32_t a[4];
      load_a_frag(a, sQ, T::kQStride, qr, ks, g, t);
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        uint32_t bf[2];
        load_bt_frag(bf, sKc, T::kQStride, nt * 8, ks, g, t);
        mma_16816(s[nt], a, bf);
      }
    }

    // Mask only a tile that crosses the diagonal, an edge of the window's
    // band or the Sk tail, or any kept tile with segments. Fragment element
    // e sits at row g + 8 * (e >> 1) and key 8 * nt + 2 * t + (e & 1).
    const bool masked =
        kSeg || key0 + kBlockN > Sk || (causal && key0 + kBlockN - 1 > m0 + q_off) ||
        (window > 0 && (key0 < band_lo_all || (!causal && key0 + kBlockN > band_hi_all)));
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (masked) {
          const int kc = nt * 8 + 2 * t + (e & 1);
          const int key = key0 + kc;
          const int pos = m0 + qr + g + 8 * (e >> 1) + q_off;
          if (key >= Sk || (causal && key > pos) || (kSeg && sKS[kc] != qs[e >> 1]) ||
              (window > 0 && (pos - key >= window || (!causal && key - pos >= window))))
            x = -INFINITY;
        }
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
    for (int n = 0; n < DV / 8; ++n) {
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
      acc_to_a_frag(a, s[2 * kk], s[2 * kk + 1]);
      const __nv_bfloat16* vrow = sVc + (kk * 16 + (lane & 15)) * T::kVStride;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, vrow + n * 8);
        mma_16816(acc[n], a, bf);
      }
    }
    __syncthreads();  // the next prefetch overwrites this buffer (and sKS)
    if (T::kStages == 1 && jn < n_tiles) {  // the one buffer is free again
      load_rows<DQK>(sK, T::kQStride, kb, st.k_s, jn * kBlockN, Sk, tid);
      load_rows<DV>(sV, T::kVStride, vb, st.v_s, jn * kBlockN, Sk, tid);
      cp_async_commit();
    }
    if (T::kStages == 2) cur ^= 1;
    j = jn;
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
    for (int n = 0; n < DV / 8; ++n) {
      *reinterpret_cast<uint32_t*>(op + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
    if (t == 0) {
      lse[((long long)b * H + h) * Sq + row] = l > 0.f ? (m_run[r] + log2f(l)) * kLn2 : -INFINITY;
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
                   const int* q_seg, const int* kv_seg, int B, int Sq, int Sk, int H,
                   const Strides& st, float scale_log2, int causal, int q_off, int group,
                   int window, cudaStream_t stream) {
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    auto kern = causal_fwd_bf16_kernel<DQK, DV, kSeg>;
    const int smem = Tile<DQK, DV>::kSmemBytes;
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((Sq + kBlockM - 1) / kBlockM, H, B);
    kern<<<grid, kThreads, smem, stream>>>(static_cast<const bf*>(q), static_cast<const bf*>(k),
                                           static_cast<const bf*>(v), static_cast<bf*>(o), lse,
                                           q_seg, kv_seg, Sq, Sk, H, st, scale_log2, causal,
                                           q_off, group, window);
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
// uninstantiated (Dqk, Dv) or dtype, or H not a multiple of Hkv).
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
#define IVT_CASE(DQK, DV)                                                                    \
  if (Dqk == DQK && Dv == DV)                                                                \
    return seg ? launch<DQK, DV, true>(dtype, q, k, v, o, lse, q_seg, kv_seg, B, Sq, Sk, H, \
                                       st, scale_log2, causal, q_offset, group, window, s)   \
               : launch<DQK, DV, false>(dtype, q, k, v, o, lse, q_seg, kv_seg, B, Sq, Sk, H, \
                                        st, scale_log2, causal, q_offset, group, window, s);
  IVT_CASE(256, 128)
  IVT_CASE(192, 128)
  IVT_CASE(128, 128)
  IVT_CASE(64, 64)
  IVT_CASE(64, 32)
  IVT_CASE(32, 32)
#undef IVT_CASE
  return cudaErrorInvalidValue;
}
