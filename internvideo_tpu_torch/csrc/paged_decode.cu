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
// Design (simple first): the TPU kernel walks a sequence's pages in one
// grid row, carrying (m, l, acc) in VMEM from step to step; here blocks run
// in parallel and nothing carries over, so the walk is split (split-KV):
// grid (splits, head groups, batch), each CTA owning `split_len` tokens of
// one sequence for 8 heads, so that B = 8 sequences still fill 132 SMs. A
// CTA streams its tokens 16 at a time from the pages into a double-buffered
// shared-memory tile with cp.async (16-byte chunks, the page id read from
// the block table per token), so the next tile is in flight while this
// one is used. Warp h holds head h's [q_lat | q_pe] row in registers and
// computes its 16 scores (lanes split the R + P dot product in 16-byte
// chunks, fp32) and its online-softmax update; then each thread
// accumulates P . C for 4 adjacent latent columns of the 8 heads in fp32
// registers (so R <= 1024). Each CTA writes its partial (acc, m, l); a
// second small kernel merges the splits by their (m, l). The pair is one
// launch of K6. CUDA-core FMAs throughout; tensor cores (the scores as an
// (8 x 1024) x (1024 x 16) product) are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC, linked with the other sources into one shared
//        library (internvideo_tpu_torch/ops/_build.py).

#include "mma.cuh"

namespace {

using namespace ivt;

constexpr int kThreads = 256;
constexpr int kHeads = kThreads / 32;  // heads per CTA: one warp each
constexpr int kTokens = 16;            // tokens per shared-memory tile
constexpr int kMaxR = 4 * kThreads;    // 4 latent columns a thread
constexpr int kMaxC = kMaxR + 128;     // R + P held in registers by a warp

__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// A 16-byte chunk: 8 bf16 or 4 fp32 values, unpacked to fp32.
template <typename T>
struct Chunk {
  static constexpr int kN = 16 / sizeof(T);
  static constexpr int kPerLane = (kMaxC / kN + 31) / 32;  // chunks of a row per lane
  __device__ static void unpack(const uint4& u, float* f) {
    if constexpr (sizeof(T) == 4) {
      f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
      f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 v = __bfloat1622float2(h[i]);
        f[2 * i] = v.x, f[2 * i + 1] = v.y;
      }
    }
  }
};

// 4 adjacent values of a row as fp32 (8 bytes of bf16, 16 of fp32).
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
}

// Partials: acc (B, splits, H, R) and (m, l) (B, splits, H, 2), base-2 m.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_split_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_pe,
                              const T* __restrict__ pages, const int* __restrict__ block_tables,
                              const int* __restrict__ seq_lens, float* __restrict__ part_acc,
                              float* __restrict__ part_ml, int H, int R, int P, int page_size,
                              int max_pages, int split_len, float scale_log2) {
  using Ch = Chunk<T>;
  const int split = blockIdx.x, b = blockIdx.z, n_splits = gridDim.x;
  const int h0 = blockIdx.y * kHeads, nh = min(kHeads, H - h0);
  const int C = R + P, n_ch = C / Ch::kN, r_ch = R / Ch::kN;  // chunks per row / of the latent
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int seq_len = seq_lens[b];
  const int t_begin = split * split_len;
  const int t_end = min(seq_len, t_begin + split_len);
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + kTokens - 1) / kTokens : 0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sTile = reinterpret_cast<T*>(smem_raw);                      // 2 x (kTokens, C)
  float* sP = reinterpret_cast<float*>(sTile + 2 * kTokens * C);  // (kHeads, kTokens)
  float* sAlpha = sP + kHeads * kTokens;                          // (kHeads,)

  // Streams tile j (tokens t_begin + 16 j ...) into buffer j & 1; slots at
  // or past t_end are zero-filled and their pages never read.
  auto load_tile = [&](int j) {
    T* dst = sTile + (j & 1) * kTokens * C;
    const int t0 = t_begin + j * kTokens;
    for (int i = tid; i < kTokens * n_ch; i += kThreads) {
      const int tr = i / n_ch, ch = i - tr * n_ch;
      const int pos = t0 + tr;
      const T* src = pages;
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
    const T* tile = sTile + (j & 1) * kTokens * C;
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

// out[b, h, :] = sum_s 2^(m_s - m) acc_s / sum_s 2^(m_s - m) l_s over the
// splits that hold tokens; 0 for a sequence with none. Grid (H, B).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_merge_kernel(const float* __restrict__ part_acc,
                              const float* __restrict__ part_ml, const int* __restrict__ seq_lens,
                              T* __restrict__ out, int H, int R, int n_splits, int split_len) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int used = min(n_splits, (seq_lens[b] + split_len - 1) / split_len);
  float m = -INFINITY;
  for (int s = 0; s < used; ++s)
    m = fmaxf(m, part_ml[(((long long)b * n_splits + s) * H + h) * 2]);
  float l = 0.f;
  for (int s = 0; s < used; ++s) {
    const float* ml = part_ml + (((long long)b * n_splits + s) * H + h) * 2;
    if (ml[1] > 0.f) l += exp2f(ml[0] - m) * ml[1];
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    float o = 0.f;
    for (int s = 0; s < used; ++s) {
      const long long row = ((long long)b * n_splits + s) * H + h;
      const float ls = part_ml[row * 2 + 1];
      if (ls > 0.f) o = fmaf(exp2f(part_ml[row * 2] - m), part_acc[row * R + r], o);
    }
    from_f(out + ((long long)b * H + h) * R + r, o * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q_lat, const void* q_pe, const void* pages, const int* tables,
                   const int* seq_lens, float* part_acc, float* part_ml, void* out, int B, int H,
                   int R, int P, int page_size, int max_pages, int split_len, int n_splits,
                   float scale_log2, cudaStream_t stream) {
  const int C = R + P;
  const int smem = 2 * kTokens * C * (int)sizeof(T) + (kHeads * kTokens + kHeads) * 4;
  auto kern = paged_decode_split_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_splits, (H + kHeads - 1) / kHeads, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_pe), static_cast<const T*>(pages),
      tables, seq_lens, part_acc, part_ml, H, R, P, page_size, max_pages, split_len, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_merge_kernel<T><<<dim3(H, B), kThreads, 0, stream>>>(
      part_acc, part_ml, seq_lens, static_cast<T*>(out), H, R, n_splits, split_len);
  return cudaGetLastError();
}

}  // namespace

// C entry bound with ctypes. dtype: 0 = float32, 1 = bfloat16 (q_lat, q_pe,
// pages and out alike); all arrays contiguous and 16-byte aligned, with R *
// sizeof(dtype) and P * sizeof(dtype) multiples of 16, R a multiple of 4,
// R <= 1024 and R + P <= 1152. part_acc (B, splits,
// H, R) and part_ml (B, splits, H, 2) are float32 scratch; split_len is a
// multiple of 16 and splits * split_len >= max_pages * page_size. Returns
// the cudaError_t of the launches; launches on `stream`, does not
// synchronise.
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
    return launch<float>(q_lat, q_pe, pages, tables, lens, acc, ml, out, B, H, R, P, page_size,
                         max_pages, split_len, n_splits, scale_log2, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q_lat, q_pe, pages, tables, lens, acc, ml, out, B, H, R, P,
                                 page_size, max_pages, split_len, n_splits, scale_log2, s);
  return cudaErrorInvalidValue;
}
