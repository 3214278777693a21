// Fused qkv slice + whole-dim QK-RMSNorm + small-S attention (K3) for
// Hopper (sm_90a), forward only, in two launches of one op:
//
//   fused_qkv_rstd  row statistics: 1/rms of every q row and every k row of
//                   the (B, S, 3W) projection, (B, S) fp32 each;
//   fused_qkv_fwd   attention over three column views of the same qkv
//                   tensor (q = [0, W), k = [W, 2W), v = [2W, 3W)); each q and
//                   k tile is normalized as it lands in shared memory,
//                   x -> bf16(w * f32(bf16(x * rstd))), then the small-S
//                   attention body of attn_fwd.cuh runs on it.
//
// Replaces internvideo_tpu/ops/flash_attention.py:1703
// `_small_s_fused_fwd_kernel` (launched by `_fused_qkv_small_s` :1730,
// reached from `fused_qkv_rmsnorm_attention` :1801 and
// ops/attention.py:81 `fused_qkv_attention_or_none`). Its backward is not a
// kernel of its own: as in JAX (`_fused_qkv_bwd_rule` :1770-1778) autograd
// runs through the unfused composition slice -> rms_norm -> K2 -> K4b.
//
// What does not carry over, and what the design does about it: the RMSNorm
// is over the whole W = H * D, across all heads. The TPU kernel holds whole
// rows of q and k in VMEM and normalizes them there. A CTA per (q tile,
// head, batch) that recomputed each k row's 1/rms itself would read every k
// row H times over (16x for the student, 25x for the CLIP teacher). So a
// pre-pass reads each q and k row once (one warp per row, 16-byte loads)
// and writes its 1/rms (8 bytes per token); the attention kernel applies it
// with the head's slice of the weight on load. Neither launch writes the
// normalized q or k to device memory: saving those materializations is the
// point of K3.
//
// What bounds it: at the CLIP teacher's (512, 257, 25, 128) the op's least
// traffic (qkv read once, out written once, 3.4 GB) takes ~1.0 ms at
// 3.35 TB/s against ~0.43 ms of tensor-core work, so bytes bound it; the
// pre-pass reads q and k a second time (2/3 more traffic than the bound). At
// the student's (32, 833, 16, 88) the tensor cores bound it (~0.13 ms).
//
// Build: compiled alone by ops/_build.py (one nvcc per source, in parallel).

#include "attn_fwd.cuh"

namespace {

using namespace ivt;

constexpr int kRstdThreads = 256;  // 8 warps, one (row, q|k) pair each

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rstd = 1 / sqrt(mean(x^2) + eps) over the W columns of q (which = 0) or k
// (which = 1) of one token, with fp32 sums: the variance of
// ops/rmsnorm.py:rms_norm. bf16 rows are read 8 columns (16 bytes) a lane.
template <bool kBf16>
__global__ void __launch_bounds__(kRstdThreads)
    fused_qkv_rstd_kernel(const void* __restrict__ qkv, float* __restrict__ q_rstd,
                          float* __restrict__ k_rstd, int B, int S, int W, long long s_b,
                          long long s_s, float eps) {
  const long long pair = ((long long)blockIdx.x * kRstdThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pair >= 2LL * B * S) return;
  const int which = static_cast<int>(pair & 1);
  const long long row = pair >> 1;
  const long long b = row / S, s = row - b * S;
  const long long off = b * s_b + s * s_s + (long long)which * W;
  float acc = 0.f;
  if constexpr (kBf16) {
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(qkv) + off;
    for (int c = lane * 8; c < W; c += 32 * 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + c);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h2[i]);
        acc = fmaf(f.x, f.x, acc);
        acc = fmaf(f.y, f.y, acc);
      }
    }
  } else {
    const float* x = static_cast<const float*>(qkv) + off;
    for (int c = lane; c < W; c += 32) acc = fmaf(x[c], x[c], acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) (which ? k_rstd : q_rstd)[row] = rsqrtf(acc / W + eps);
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads)
    fused_qkv_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                              int S, int H, FwdStrides st, float scale_log2, QkNorm nrm) {
  attn_fwd_bf16<D>(q, k, v, o, S, S, st, scale_log2, nrm);
}

template <int D>
__global__ void __launch_bounds__(kFwdF32Rows)
    fused_qkv_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ o, int S, int H,
                             FwdStrides st, float scale_log2, QkNorm nrm) {
  attn_fwd_f32<D, true>(q, k, v, o, nullptr, S, S, H, st, scale_log2, nrm);
}

template <int D>
cudaError_t launch(int dtype, const void* qkv, void* o, int B, int S, int H,
                   const FwdStrides& st, float scale_log2, const QkNorm& nrm,
                   cudaStream_t stream) {
  const long long W = (long long)H * D;
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    const bf* q = static_cast<const bf*>(qkv);
    return launch_fwd(fused_qkv_fwd_bf16_kernel<D>, true, FwdTile<D>::kSmemBytes, B, S, H, stream,
                      q, q + W, q + 2 * W, static_cast<bf*>(o), S, H, st, scale_log2, nrm);
  }
  const float* q = static_cast<const float*>(qkv);
  return launch_fwd(fused_qkv_fwd_f32_kernel<D>, false, 0, B, S, H, stream, q, q + W, q + 2 * W,
                    static_cast<float*>(o), S, H, st, scale_log2, nrm);
}

}  // namespace

// C entries bound with ctypes; dtype 0 = float32, 1 = bfloat16. `qkv` is
// (B, S, 3W) with element strides s_b, s_s and a unit last stride (bf16:
// W a multiple of 8, 16-byte aligned rows). q_rstd / k_rstd are (B, S) fp32
// contiguous. Each returns the cudaError_t of its launch
// (cudaErrorInvalidValue for an unsupported head dim or dtype); launches on
// `stream`; does not synchronise.
extern "C" int ivt_fused_qkv_rstd(int dtype, const void* qkv, float* q_rstd, float* k_rstd, int B,
                                  int S, int W, long long s_b, long long s_s, float eps,
                                  void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  const long long warps = 2LL * B * S;
  const long long blocks = (warps * 32 + kRstdThreads - 1) / kRstdThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    fused_qkv_rstd_kernel<true><<<(unsigned)blocks, kRstdThreads, 0, st>>>(
        qkv, q_rstd, k_rstd, B, S, W, s_b, s_s, eps);
  } else {
    fused_qkv_rstd_kernel<false><<<(unsigned)blocks, kRstdThreads, 0, st>>>(
        qkv, q_rstd, k_rstd, B, S, W, s_b, s_s, eps);
  }
  return cudaGetLastError();
}

// `o` is (B, S, H, D) with (batch, seq, head) element strides o_b, o_s, o_h;
// q_w / k_w are the (W,) fp32 RMSNorm weights.
extern "C" int ivt_fused_qkv_fwd(int dtype, const void* qkv, const float* q_rstd,
                                 const float* k_rstd, const float* q_w, const float* k_w, void* o,
                                 int B, int S, int H, int D, long long s_b, long long s_s,
                                 long long o_b, long long o_s, long long o_h, float scale,
                                 void* stream) {
  const FwdStrides st{s_b, s_s, D, s_b, s_s, D, s_b, s_s, D, o_b, o_s, o_h};
  const QkNorm nrm{q_rstd, k_rstd, q_w, k_w};
  const float scale_log2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<64>(dtype, qkv, o, B, S, H, st, scale_log2, nrm, s);
    case 72:
      return launch<72>(dtype, qkv, o, B, S, H, st, scale_log2, nrm, s);
    case 88:
      return launch<88>(dtype, qkv, o, B, S, H, st, scale_log2, nrm, s);
    case 128:
      return launch<128>(dtype, qkv, o, B, S, H, st, scale_log2, nrm, s);
    default:
      return cudaErrorInvalidValue;
  }
}
