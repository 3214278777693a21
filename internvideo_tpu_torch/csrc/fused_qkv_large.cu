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
// One op, two launches (bf16):
//   fused_qkv_rstd        the pre-pass (csrc/fused_qkv.cu, K3's row-statistics
//                         kernel with its kNormK flag): one read of every q
//                         and k row of the (B, S, 3W) projection; it writes
//                         1/rms of each over the whole W = H * D, (B, S) fp32,
//                         and the k rows normed, x -> bf16(w * f32(bf16(x *
//                         rstd))) as `_norm` (:1905-1910) forms them, into a
//                         (B, S, W) bf16 buffer the wrapper allocates a call;
//   fused_qkv_large_fwd   this file's entry: K3's warp-specialised wgmma +
//                         TMA walk (flash_fwd_causal.cu
//                         fused_qkv_large_fwd_wgmma_kernel) with TMA loading
//                         Q and V from the column views q = [0, W), v =
//                         [2W, 3W) of the projection and K from the normed
//                         buffer; the consumers norm only the Q tile, once
//                         a CTA, in shared memory, so the loop over K tiles
//                         is K1's.
// It is non-causal with no segment ids. TMA zero-fills key and V rows past S
// (each map's S extent is the true S), key columns past S are masked to -inf
// before the row max (:1920-1933), query rows past S are never stored.
//
// Why K is normed once: the norm is over the whole W, so a K tile cannot be
// normed without its rows' 1/rms; normed in the walk (K3's design) each k
// row of a head is normed again by every 128-row query CTA, 33 times a head
// at S = 4097, and that norm cost K3's attention 1.5 x K2's on pre-normed q /
// k (PERF.md, section 6). Written once by the pre-pass it costs B * S * W * 2
// bytes (185 MB at (16, 4097, 16, 88), ~0.06 ms at 3.35 TB/s) against ~1.5
// ms of tensor-core work. The TPU kernel keeps normed K out of device memory
// because its blocks are 256-1440 rows (`_fused_large_block` :1878-1894), so
// it norms each K block only a few times a head; that holds on the TPU, not
// here. K3's in-place walk would also stage the sequence's k 1/rms in shared
// memory (S fp32: 32 KB at S = 8192); this walk stages nothing that grows
// with S.
//
// What bounds it: operations. 4 * B * H * S^2 * D FLOPs on the tensor cores
// against (3 + 1) * B * S * W elements of traffic: at (16, 4097, 16, 88)
// 1.529 ms at 989 TFLOP/s against 0.74 GB (0.22 ms at 3.35 TB/s).
//
// fp32 takes attn_fwd.cuh's CUDA-core body with q and k normed on load
// from the rstd pre-pass's factors (the parity route).
//
// Build: compiled alone by ops/_build.py (one nvcc per source, in parallel).

#include "attn_fwd.cuh"

namespace ivt {

// K11's bf16 launch (flash_fwd_causal.cu).
cudaError_t fused_qkv_large_fwd_wgmma(const void* qkv, const void* k_normed, const QkNorm& nrm,
                                      void* o, int B, int S, int H, int D, long long s_b,
                                      long long s_s, long long o_b, long long o_s, long long o_h,
                                      float scale, void* stream);

}  // namespace ivt

namespace {

using namespace ivt;

template <int D>
__global__ void __launch_bounds__(kFwdF32Rows)
    fused_qkv_large_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                   const float* __restrict__ v, float* __restrict__ o, int S,
                                   int H, FwdStrides st, float scale_log2, QkNorm nrm) {
  attn_fwd_f32<D, true>(q, k, v, o, nullptr, S, S, H, st, scale_log2, nrm);
}

template <int D>
cudaError_t launch_f32(const void* qkv, void* o, int B, int S, int H, const FwdStrides& st,
                       float scale_log2, const QkNorm& nrm, cudaStream_t stream) {
  const long long W = (long long)H * D;
  const float* q = static_cast<const float*>(qkv);
  return launch_fwd(fused_qkv_large_fwd_f32_kernel<D>, B, S, H, stream, q, q + W, q + 2 * W,
                    static_cast<float*>(o), S, H, st, scale_log2, nrm);
}

}  // namespace

// C entry bound with ctypes: dtype 0 = float32, 1 = bfloat16; `qkv` (B, S,
// 3W) with element strides s_b, s_s and a unit last stride (bf16: W a
// multiple of 8, 16-byte aligned rows); q_rstd / k_rstd (B, S) fp32
// contiguous from the pre-pass; q_w / k_w the (W,) fp32 RMSNorm weights
// (16-byte aligned); `o` (B, S, H, D) with (batch, seq, head) element
// strides o_b, o_s, o_h. bf16 reads K from `k_normed`, (B, S, W) contiguous
// from ivt_fused_qkv_rstd_normed_k, and not k_rstd / k_w; fp32 norms k on
// load from k_rstd / k_w and does not read k_normed (it may be null).
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a head
// dim or dtype it does not take, or a bf16 tensor cuTensorMapEncodeTiled
// refuses a TMA map for); launches on `stream`; does not synchronise.
extern "C" int ivt_fused_qkv_large_fwd(int dtype, const void* qkv, const void* k_normed,
                                       const float* q_rstd, const float* k_rstd,
                                       const float* q_w, const float* k_w, void* o, int B, int S,
                                       int H, int D, long long s_b, long long s_s, long long o_b,
                                       long long o_s, long long o_h, float scale, void* stream) {
  const QkNorm nrm{q_rstd, k_rstd, q_w, k_w};
  if (dtype == 1)
    return fused_qkv_large_fwd_wgmma(qkv, k_normed, nrm, o, B, S, H, D, s_b, s_s, o_b, o_s, o_h,
                                     scale, stream);
  if (dtype != 0) return cudaErrorInvalidValue;
  const FwdStrides st{s_b, s_s, D, s_b, s_s, D, s_b, s_s, D, o_b, o_s, o_h};
  const float scale_log2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_f32<64>(qkv, o, B, S, H, st, scale_log2, nrm, s);
    case 88:
      return launch_f32<88>(qkv, o, B, S, H, st, scale_log2, nrm, s);
    default:
      return cudaErrorInvalidValue;
  }
}
