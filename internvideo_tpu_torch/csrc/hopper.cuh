// Hopper (sm_90a) building blocks of the wgmma / TMA kernels: the tensor-map
// encoders (host: 4-D bf16 attention operands, 2-D int8 matrices), mbarrier
// init / arrive / expect-tx / wait, TMA tile loads and plain bulk copies,
// K3's QK-RMSNorm in place on a swizzled tile, named barriers, register
// reallocation between warpgroups, wgmma shared-memory descriptors, the bf16
// wgmma instructions (fp32 accumulators) in both operand forms, the s8 ones
// (int32 accumulators), the proxy fence between threads' shared-memory
// writes and wgmma reads of them, and exp2 on the SFU.
//
// Layout convention (the one TMA's swizzle and wgmma's descriptors share): a
// tile of R rows whose row is `row_bytes` = 128 (64 bf16) or 64 (32 bf16)
// bytes wide is one TMA box, written with the swizzle of the same span
// (CU_TENSOR_MAP_SWIZZLE_128B / _64B): rows `row_bytes` apart, 8-row groups
// 8 * row_bytes apart, the 16-byte chunks of row r XOR-ed with r % 8. A wider
// matrix is several such panels side by side (panel p holds columns
// [p * row_bytes / 2, (p + 1) * row_bytes / 2)). Panels start on 1024-byte
// boundaries, so the swizzle's phase is the address's own and descriptors
// need no base offset. A width that is no multiple of 64 is stored in
// 32-column panels rounded up to whole panels (head dim 88 as three, 96
// columns): the tensor map keeps the true width, so TMA zero-fills the last
// panel's columns past it, products that reduce over the width see zeros
// there, and stores write the true width.
//
// - K-major operand (the reduction dim runs along the row, as Q and K in
//   S = Q K^T): descriptor with SBO = 8 * row_bytes; a k-step of 16 bf16
//   moves the start address 32 bytes within the panel, the next panel
//   starts the next 64 (or 32) columns. LBO is unused.
// - MN-major operand (the output dim runs along the row, as V in O = P V,
//   read with the transpose bit): SBO = 8 * row_bytes between groups of 8
//   reduction rows, LBO = the panel stride between groups of 64 (or 32)
//   output columns; a k-step of 16 rows moves the start 16 * row_bytes.
// - 8-bit operands (the int8 GEMM) are K-major only (wgmma takes no
//   transpose for them): a tile row is one 128-byte k-tile (128 int8), with
//   the 128-byte swizzle and SBO = 1024 as above; a k-step of 32 int8 moves
//   the start 32 bytes.
//
// Build: included by the .cu files; nvcc -gencode arch=compute_90a,code=sm_90a
// (wgmma and setmaxnreg exist only on sm_90a). The encoder comes from the
// runtime's driver entry point, so the library links without -lcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace ivt {
namespace hopper {

// ---- host: tensor maps ---------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime (looked up once), or null.
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D tensor map of a (B, S, H, D) bf16 tensor with element strides
// (sb, ss, sh) and a unit D stride: dims innermost first (D, S, H, B), so
// the S extent is the true S and a box never reads into the next head or
// batch (rows past S are zero-filled). A box is `box_rows` rows by
// `box_cols` columns (64 or 32: the swizzle span) of one (h, b). The base
// and the strides must be 16-byte multiples (TMA's rule). Returns
// cudaErrorInvalidValue if the driver refuses the map.
inline cudaError_t encode_bshd(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                               long long sb, long long ss, long long sh, int box_rows,
                               int box_cols) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  // a dim of extent 1 is only ever at coordinate 0: its stride is free
  auto stride = [](long long s, int n) { return (cuuint64_t)(n == 1 ? 16 : s * 2); };
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {stride(ss, S), stride(sh, H), stride(sb, B)};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      box_cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 2-D tensor map of an int8 matrix of `rows` rows of `cols` bytes, rows
// `pitch` bytes apart (pitch and base 16-byte multiples, pitch >= cols):
// dims innermost first (cols, rows). A box is one 128-byte k-tile (the
// swizzle span) of `box_rows` rows (<= 256); bytes past `cols` and rows past
// `rows` are zero-filled. Returns cudaErrorInvalidValue if the driver
// refuses the map.
inline cudaError_t encode_2d_u8(CUtensorMap* map, const void* base, long long cols,
                                long long rows, long long pitch, int box_rows) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---- device: mbarriers ---------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA); follow
// with __syncthreads() before any thread uses them.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that lasts
// ~10 s (2^34 cycles) can only be a broken protocol: it traps, so the launch
// fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  const long long t0 = clock64();
  while (true) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads:
// bar_sync waits for them all, bar_arrive counts this thread and goes on.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- device: TMA -----------------------------------------------------------------------------

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// One box of a 4-D map at coordinates (c0, c1, c2, c3), innermost first,
// into shared memory at `dst`; its bytes complete a transaction on `bar`.
// `map` must be a __grid_constant__ kernel parameter.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// One box of a 2-D map at coordinates (c0, c1), innermost first, as above.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, as one bulk copy (no tensor map); its bytes complete a
// transaction on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- device: K3's QK-RMSNorm on a swizzled tile ------------------------------------------------

// K3's whole-dim QK-RMSNorm in place on kRows rows from r_lo of a bf16
// tile that TMA wrote in the panel layout of the top note (panels of kCols
// columns and kPanelRows rows, kW stored columns, the true width D), by
// kThreads threads that take its 16-byte chunks in turn (row-major over the
// true columns): element (r, c) becomes bf16(w[c] * f32(bf16(x * rstd[r -
// r_lo]))), the cast chain of internvideo_tpu/ops/flash_attention.py:
// 1706-1710, w the head's fp32 weights. Each thread's rows' 1/rms load in
// one batch first. The swizzle only permutes the chunks of a 128-byte line
// (chunk bits 4-6, or 4-5 at the 64-byte span, XOR-ed with the line's bits
// 7-9 / 7-8), so a chunk's address is its true offset with that XOR. Rows
// at or past n_valid and the zero-filled chunks at or past D (whose weights
// are never read) are left as they are.
template <int kRows, int kPanelRows, int kCols, int kW, int D, int kThreads>
__device__ __forceinline__ void qk_norm_chunks(unsigned char* tile, int r_lo, int n_valid, int tid,
                                               const float* __restrict__ w,
                                               const float* __restrict__ rstd) {
  constexpr int kRowChunks = kW / 8;
  constexpr int kChunks = kRows * kRowChunks;
  constexpr int kIters = (kChunks + kThreads - 1) / kThreads;
  constexpr int kRowBytes = 2 * kCols;
  constexpr unsigned kMask = kRowBytes == 128 ? 7 : 3;
  float rs[kIters];
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int i = tid + k * kThreads, r = i / kRowChunks;
    rs[k] = i < kChunks && r < n_valid ? rstd[r] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int i = tid + k * kThreads, r = i / kRowChunks, c = i % kRowChunks * 8;
    if (i >= kChunks || r >= n_valid || c >= D) continue;
    const unsigned off = (r_lo + r) * kRowBytes + c % kCols * 2;
    uint4* p = reinterpret_cast<uint4*>(tile + c / kCols * kPanelRows * kRowBytes +
                                        (off ^ (((off >> 7) & kMask) << 4)));
    uint4 raw = *p;
    __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(&raw);
    const float4 w0 = *reinterpret_cast<const float4*>(w + c);
    const float4 w1 = *reinterpret_cast<const float4*>(w + c + 4);
    const float ws[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(x2[j]);
      const float n0 = __bfloat162float(__float2bfloat16(f.x * rs[k]));
      const float n1 = __bfloat162float(__float2bfloat16(f.y * rs[k]));
      x2[j] = __floats2bfloat162_rn(ws[2 * j] * n0, ws[2 * j + 1] * n1);
    }
    *p = raw;
  }
}

// ---- device: warpgroup registers -------------------------------------------------------------

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---- device: wgmma -----------------------------------------------------------------------------

// The shared-memory matrix descriptor of a panel layout (see the top note):
// start address, leading / stride byte offsets, swizzle span 128 or 64.
__device__ __forceinline__ uint64_t make_desc(const void* p, unsigned row_bytes, unsigned lbo,
                                              unsigned sbo) {
  const uint64_t layout = row_bytes == 128 ? 1 : 2;  // SWIZZLE_128B : SWIZZLE_64B
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// A descriptor whose start address is `bytes` further (within the 256 KB the
// 14-bit field holds, so the sum never carries into LBO). The empty volatile
// asm makes `desc` opaque at this point of the program, so the sum is
// formed where it is used: computed ahead for every k-step of a product,
// the descriptors would hold a register pair each (spills beside large
// accumulators).
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, unsigned bytes) {
  asm volatile("" : "+l"(desc));
  return desc + (bytes >> 4);
}

// Orders register accesses of non-wgmma instructions before the wgmma
// instructions that follow (accumulators rescaled, A fragments written).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma instructions that own them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for A fragments in registers: after the wait for the wgmma that
// reads them, it keeps them in place until that wgmma is done.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The same for int32 accumulators (the s8 products).
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D(64 x N, f32) (+)= A(64 x 16, bf16) B(16 x N, bf16), the accumulator's
// N / 2 registers a thread: thread (warp w, lane l) holds rows 16 w + l / 4
// (+ 8) and columns 8 i + 2 (l % 4) (+ 1) in d[4 i .. 4 i + 3], as mma.sync's
// m16n8 fragment repeated over i. scale_d = 0 overwrites D.
// wgmma_ss: A and B from shared-memory descriptors (kTransA / kTransB: 0 for
// K-major, 1 for MN-major); wgmma_rs: A from registers (four bf16 pairs in
// mma.sync's m16n8k16 A layout, warp w's 16 rows), B from a descriptor.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTransB));
}

// D(64 x 256, s32) (+)= A(64 x 32, s8) B(32 x 256, s8), both operands
// K-major from shared-memory descriptors; the accumulator's 128 registers a
// thread in the f32 layout above; scale_d = 0 overwrites D. The sums are
// exact (int32; the caller bounds K).
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Registers [c * R, (c + 1) * R) of an accumulator as an array of its own:
// the fragment of output columns [2 c R, 2 (c + 1) R), since the layout
// repeats every 8 columns (4 registers). c must be a compile-time constant
// after unrolling.
template <int R, int N>
__device__ __forceinline__ float (&cols(float (&d)[N], int c))[R] {
  return *reinterpret_cast<float(*)[R]>(&d[c * R]);
}

// D(64 x N) += A(64 x 16, registers) B(16 x N) with B MN-major in panels of
// kCols columns, `panel` bytes apart; `b` is the descriptor of the k-step's
// first row in panel 0 (LBO = panel). One wgmma of up to 128 columns per
// chunk (N = 256 is two).
template <int N, int kCols>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[N / 2], const uint32_t (&a)[4],
                                            uint64_t b, unsigned panel) {
  constexpr int kChunk = N > 128 ? 128 : N;
#pragma unroll
  for (int c = 0; c < N / kChunk; ++c)
    wgmma_rs<1>(cols<kChunk / 2>(d, c), a, desc_add(b, c * (kChunk / kCols) * panel), 1);
}

// 2^x on the SFU with subnormal results flushed to zero (ex2.approx.ftz:
// one MUFU.EX2; exp2f without fast math adds a range test and two scalings
// around it).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Orders this thread's generic-proxy writes to shared memory (st.shared)
// before later async-proxy reads of them (wgmma operands); follow with a
// barrier that the reading warps wait on.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace hopper
}  // namespace ivt
