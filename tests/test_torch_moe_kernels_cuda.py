"""The kernel shapes the MoE presets add, on the card: K5's causal forward
(csrc/flash_fwd_causal.cu) at (d_qk, d_v) = (128, 64), `qwen3_moe_text`'s
64 nope + 64 rope with v 64, and K6's bf16 paged decode
(csrc/paged_decode.cu) at (R, P) = (512, 64) with 64 heads
(`gpt_oss_moe_text`) and 128 heads (`deepseek_v3`), a CTA per group of 32
heads; each against its plain PyTorch version.

Needs an NVIDIA GPU with nvcc (the kernels have no CPU mode), so every test
here is marked `cuda` and skips without a card. The file imports neither
jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_moe_kernels_cuda.py -m cuda
"""

import pytest
import torch

from internvideo_tpu_torch.ops import flash_attention as fa
from internvideo_tpu_torch.ops import paged_decode as pd
from test_torch_paged_decode_kernel_cuda import _inputs as _pool


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


# (B, Sq, Sk, H, q_position_offset): a ragged prompt, tile edges, a chunk
# with a query offset, one decode row, and the prefill's head count
K5_CASES = [(2, 333, 333, 4, 0), (1, 127, 127, 2, 0), (1, 129, 129, 2, 0),
            (1, 97, 300, 2, 203), (2, 1, 300, 2, 299), (1, 256, 256, 32, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_forward_at_128_64(dtype):
    """fp32 within 2e-5 of the plain version (out and LSE); bf16 rel-L2 <=
    1e-2, LSE within 1e-2; one launch a call."""
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(0)
    for b, sq, sk, h, off in K5_CASES:
        q = torch.randn(b, sq, h, 128, device="cuda", generator=g).to(dt)
        k = torch.randn(b, sk, h, 128, device="cuda", generator=g).to(dt)
        v = torch.randn(b, sk, h, 64, device="cuda", generator=g).to(dt)
        before = fa.launch_count("flash_fwd_causal")
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=True, q_position_offset=off)
        torch.cuda.synchronize()
        assert fa.launch_count("flash_fwd_causal") == before + 1
        ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, 128 ** -0.5, True, off)
        case = (b, sq, sk, h, off)
        if dt == torch.float32:
            torch.testing.assert_close(out, ref, atol=2e-5, rtol=0, msg=str(case))
            torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=0, msg=str(case))
        else:
            assert _rel(out, ref) <= 1e-2, (case, _rel(out, ref))
            torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=0, msg=str(case))


@pytest.mark.cuda
@pytest.mark.parametrize("h", [64, 128])
def test_k6_bf16_past_32_heads(h):
    """B 8 at the serving lengths (2,048-2,112) and at ragged ones (0, 1, a
    page, the split edges), B 1 at 32,768: rel-L2 <= 1e-2 against the plain
    version on the cleaned pool, a sequence without tokens 0, one launch a
    call, two calls bit-identical, and each head group equal to the same
    heads decoded alone (a 32-head call)."""
    _card()
    page = 64
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split = pd.split_len_bf16(8, 40 * page, sms, h // 32)
    cases = [(8, [2048, 2060, 2070, 2080, 2090, 2100, 2111, 2112]),
             (8, [0, 1, page, page + 1, split - 1, split, split + 1, 2 * split + 1]),
             (1, [32768])]
    for i, (b, lens) in enumerate(cases):
        mp = max(40, -(-max(lens) // page))
        q_lat, q_pe, pages, tables, sl = _pool(b, h, 512, 64, page, mp, lens, torch.bfloat16,
                                               200 + i)
        scale = (128 + 64) ** -0.5
        before = pd.launch_count()
        out = pd.paged_mla_decode(q_lat, q_pe, pages, tables, sl, softmax_scale=scale)
        again = pd.paged_mla_decode(q_lat, q_pe, pages, tables, sl, softmax_scale=scale)
        torch.cuda.synchronize()
        assert pd.launch_count() == before + 2
        ref = pd.paged_mla_decode_ref(q_lat, q_pe, torch.nan_to_num(pages, nan=0.0), tables, sl,
                                      softmax_scale=scale)
        assert out.dtype == torch.bfloat16 and torch.isfinite(out).all(), lens
        live = sl > 0
        assert (out[~live] == 0).all(), lens
        assert _rel(out[live], ref[live]) <= 1e-2, (lens, _rel(out[live], ref[live]))
        assert torch.equal(out, again), lens
        # the last group alone: its CTAs see the same splits only when the
        # grid is the same, so compare within bf16 rounding
        tail = pd.paged_mla_decode(q_lat[:, -32:].contiguous(), q_pe[:, -32:].contiguous(),
                                   pages, tables, sl, softmax_scale=scale)
        assert _rel(out[live][:, -32:], tail[live]) <= 1e-2, lens
