// Fused qkv slice + whole-dim QK-RMSNorm + blocked-K attention for
// 1024 < S <= 8192 (K11) for Hopper (sm_90a), forward only.
//
// Replaces internvideo_tpu/ops/flash_attention.py:1897
// `_fused_large_fwd_kernel` (launched by `_fused_qkv_large` :1961 -> :1968,
// reached from `fused_qkv_rmsnorm_attention` :1801 at 1024 < S <= 8192 and
// from ops/attention.py:123-131 `fused_qkv_attention_or_none(
// allow_large=True)`). Its backward is not a kernel of its own: as in JAX
// (`_fused_large_bwd_rule` :2012-2020) autograd runs through the unfused
// composition slice -> rms_norm -> K1 -> K4a.
//
// One op, two launches:
//   fused_qkv_rstd        K3's row-statistics pre-pass (csrc/fused_qkv.cu):
//                         1/rms of every q row and every k row over the whole
//                         W = H * D, (B, S) fp32 each;
//   fused_qkv_large_fwd   this file: K1's tiled online-softmax body
//                         (attn_fwd.cuh) over three column views of the same
//                         (B, S, 3W) projection (q = [0, W), k = [W, 2W),
//                         v = [2W, 3W)), read through their strides. The q
//                         tile is normalized once and each k tile as it
//                         lands in shared memory, x -> bf16(w * f32(bf16(x *
//                         rstd))), as `_norm` (:1906-1910) does; normalized q
//                         and k never reach device memory.
// It is non-causal with no segment ids. Key rows past S are masked to -inf
// before the row max, and V rows past S are zero-filled by the predicated
// cp.async (p * V over garbage rows would otherwise turn NaN into the
// output: :1923-1933); query rows past S are never stored.
//
// What does not carry over: the TPU kernel is a (B, nq, nk) grid whose
// innermost k axis runs in order on one core, carrying the running max and
// sum in VMEM scratch, with a block edge of 256-1440 rows picked per shape
// (`_fused_large_block` :1878-1894) to keep the padded FLOPs of S = 4097 at
// +1.5 % under a scoped-VMEM budget. On Hopper the k loop lives inside the
// CTA (registers carry the running statistics), and the tile is K1's 64
// queries x 64 keys: it pads S = 4097 to 4160 (+1.5 %, the same waste), S =
// 1025 to 1088, keeps 66.5 KB of shared memory a CTA (three CTAs an SM at
// head dim 88), and gives (16, 4097, 16, 88) 16,640 CTAs, 42 waves of 396.
//
// What bounds it: operations. 4 * B * H * S^2 * D FLOPs on the tensor cores
// against (3 + 1) * B * S * W elements of traffic: at (16, 4097, 16, 88)
// 1.529 ms at 989 TFLOP/s against 0.74 GB (0.22 ms at 3.35 TB/s).
//
// Build: compiled alone by ops/_build.py (one nvcc per source, in parallel).

#include "attn_fwd.cuh"

namespace {

using namespace ivt;

template <int D>
__global__ void __launch_bounds__(kFwdThreads)
    fused_qkv_large_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                                    const __nv_bfloat16* __restrict__ k,
                                    const __nv_bfloat16* __restrict__ v,
                                    __nv_bfloat16* __restrict__ o, int S, int H, FwdStrides st,
                                    float scale_log2, QkNorm nrm) {
  attn_fwd_bf16<D>(q, k, v, o, S, S, st, scale_log2, nrm);
}

template <int D>
__global__ void __launch_bounds__(kFwdF32Rows)
    fused_qkv_large_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                   const float* __restrict__ v, float* __restrict__ o, int S,
                                   int H, FwdStrides st, float scale_log2, QkNorm nrm) {
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
    return launch_fwd(fused_qkv_large_fwd_bf16_kernel<D>, true, FwdTile<D>::kSmemBytes, B, S, H,
                      stream, q, q + W, q + 2 * W, static_cast<bf*>(o), S, H, st, scale_log2,
                      nrm);
  }
  const float* q = static_cast<const float*>(qkv);
  return launch_fwd(fused_qkv_large_fwd_f32_kernel<D>, false, 0, B, S, H, stream, q, q + W,
                    q + 2 * W, static_cast<float*>(o), S, H, st, scale_log2, nrm);
}

}  // namespace

// C entry bound with ctypes, the signature of ivt_fused_qkv_fwd: dtype 0 =
// float32, 1 = bfloat16; `qkv` (B, S, 3W) with element strides s_b, s_s and
// a unit last stride (bf16: W a multiple of 8, 16-byte aligned rows);
// q_rstd / k_rstd (B, S) fp32 contiguous from ivt_fused_qkv_rstd; q_w / k_w
// the (W,) fp32 RMSNorm weights (16-byte aligned); `o` (B, S, H, D) with
// (batch, seq, head) element strides o_b, o_s, o_h. Returns the cudaError_t
// of the launch (cudaErrorInvalidValue for a head dim or dtype it does not
// take); launches on `stream`; does not synchronise.
extern "C" int ivt_fused_qkv_large_fwd(int dtype, const void* qkv, const float* q_rstd,
                                       const float* k_rstd, const float* q_w, const float* k_w,
                                       void* o, int B, int S, int H, int D, long long s_b,
                                       long long s_s, long long o_b, long long o_s,
                                       long long o_h, float scale, void* stream) {
  const FwdStrides st{s_b, s_s, D, s_b, s_s, D, s_b, s_s, D, o_b, o_s, o_h};
  const QkNorm nrm{q_rstd, k_rstd, q_w, k_w};
  const float scale_log2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<64>(dtype, qkv, o, B, S, H, st, scale_log2, nrm, s);
    case 88:
      return launch<88>(dtype, qkv, o, B, S, H, st, scale_log2, nrm, s);
    default:
      return cudaErrorInvalidValue;
  }
}
