// Packed-sequence segment ids (K8) for the causal / narrow-v flash kernels
// (sm_90a): the per-tile range test that lets a kernel skip a (query tile,
// key tile) pair before loading it, and the cp.async row loader of the K5
// backward.
//
// Replaces the TPU devices `_segs_overlap` (internvideo_tpu/ops/
// flash_attention.py:75) and `_build_remap` (:96). There the grid runs in
// order on one core, so the kernel prefetches per-block segment min/max
// with scalar prefetch and remaps dead blocks' DMAs onto live ones. Here a
// CTA walks its own loop over the other operand's tiles: before loading a
// tile it reads the tile's ids (one or two per lane, coalesced), reduces
// their min / max across the warp with shuffles, and skips the tile when
// that range and its own tile's range are disjoint: then no pair of ids in
// the two tiles is equal and every element would be masked. Every warp
// computes the same range, so the loop stays uniform across the CTA and
// needs no barrier. A tile that is kept is masked element by element by
// equality (a pad id -1 meets another -1, as in the JAX kernels).
#pragma once

#include <climits>

#include "mma.cuh"

namespace ivt {

// (min, max) of ids[row0, row0 + n) clipped to [0, valid), reduced over the
// calling warp (every lane gets the result); an empty range is (INT_MAX,
// INT_MIN), which meets nothing.
__device__ __forceinline__ int2 seg_range(const int* __restrict__ ids, int row0, int n, int valid,
                                          int lane) {
  int lo = INT_MAX, hi = INT_MIN;
  for (int r = lane; r < n; r += 32) {
    if (row0 + r < valid) {
      const int s = ids[row0 + r];
      lo = min(lo, s);
      hi = max(hi, s);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  return make_int2(lo, hi);
}

// Can some id in range a equal some id in range b?
__device__ __forceinline__ bool ranges_meet(int2 a, int2 b) { return a.x <= b.y && b.x <= a.y; }

// cp.async rows [row0, row0 + ROWS) of a (S, D) bf16 matrix with row stride
// `s_stride` into a shared tile of row stride `dst_stride`; rows at or past
// `valid` are zero-filled (finite, so a masked element's p is exactly 0).
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void cp_rows(__nv_bfloat16* dst, int dst_stride,
                                        const __nv_bfloat16* src, long long s_stride, int row0,
                                        int valid, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = row0 + r < valid;
    const __nv_bfloat16* p = ok ? src + (long long)(row0 + r) * s_stride + c * 8 : src;
    cp_async_16(dst + r * dst_stride + c * 8, p, ok);
  }
}

}  // namespace ivt
