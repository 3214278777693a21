// Packed-sequence segment ids (K8) for the causal / narrow-v flash kernels
// (sm_90a): the per-tile range test that lets a kernel skip a (query tile,
// key tile) pair before loading it, per warp or (the backward's walks) 32
// tiles at a time.
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

// (min, max) of ids[row0, row0 + n) clipped to [0, valid), by one thread
// (the loads are independent, so they overlap).
__device__ __forceinline__ int2 ids_range(const int* __restrict__ ids, int row0, int n,
                                          int valid) {
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll 8
  for (int r = 0; r < n; ++r) {
    if (row0 + r < valid) {
      const int s = ids[row0 + r];
      lo = min(lo, s);
      hi = max(hi, s);
    }
  }
  return make_int2(lo, hi);
}

// The first step j' in [j, n) for which meets(j') holds (n if none), by the
// calling warp: lane l tests step base + l, and the ballot of that window of
// 32 steps answers the calls that fall into it, so a run of skipped steps
// costs one round of loads per 32 steps instead of one per step. `base` and
// `mask` carry the window from call to call (start with base = INT_MIN).
template <class Meets>
__device__ __forceinline__ int next_meeting(int j, int n, int& base, unsigned& mask, int lane,
                                            Meets meets) {
  while (j < n) {
    if (j < base || j >= base + 32) {
      base = j;
      mask = __ballot_sync(0xffffffffu, j + lane < n && meets(j + lane));
    }
    const unsigned m = mask >> (j - base);
    if (m) return j + __ffs(m) - 1;
    j = base + 32;
  }
  return j;
}

}  // namespace ivt
