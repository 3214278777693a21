"""K5's grouped-query and sliding-window forward (csrc/flash_fwd_causal.cu)
vs its plain PyTorch version, on the card.

Needs an NVIDIA GPU with nvcc (the kernel has no CPU mode), so every test
here is marked `cuda` and skips without a card. The file imports neither
jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_gqa_kernel_cuda.py -m cuda
"""

import pytest
import torch

from internvideo_tpu_torch.ops import flash_attention as fa

# (B, Sq, Sk, Hq, Hkv, D, keyword arguments): the JAX kernel tests' shapes
# (tests/test_flash_attention.py test_gqa, test_sliding_window,
# test_window_fully_masked_rows_zero), a windowed query offset with a ragged
# S, a row block whose whole band lies in the key tail, GQA with segments,
# and the qwen3_8b_dense head dim at a small size.
CASES = [
    (1, 128, 128, 8, 2, 64, {}),
    (1, 256, 256, 2, 2, 64, dict(window=50)),
    (1, 256, 256, 2, 2, 64, dict(causal=True, window=50)),
    (1, 256, 64, 2, 2, 64, dict(window=50)),
    (1, 128, 200, 4, 2, 64, dict(causal=True, window=50, q_position_offset=72)),
    (1, 200, 200, 2, 1, 64, dict(window=30, q_position_offset=72)),
    (2, 200, 200, 8, 2, 64, dict(causal=True, segments=True)),
    (2, 333, 333, 8, 2, 128, dict(causal=True)),
    (2, 333, 333, 8, 2, 128, dict(causal=True, window=128)),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K5 kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _counter(kw, gqa):
    return ("flash_fwd_causal_window" if kw.get("window") else
            "flash_fwd_causal_gqa" if gqa else "flash_fwd_causal_seg")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain(dtype):
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(0)
    for b, sq, sk, hq, hkv, d, kw in CASES:
        kw = dict(kw)
        if kw.pop("segments", False):
            seg = torch.arange(sk, device="cuda")[None].expand(b, sk) // 70
            kw.update(q_segment_ids=seg, kv_segment_ids=seg)
        q = torch.randn(b, sq, hq, d, device="cuda", generator=g).to(dt)
        k, v = (torch.randn(b, sk, hkv, d, device="cuda", generator=g).to(dt) for _ in range(2))
        name = _counter(kw, hkv != hq)
        before = fa.launch_count(name)
        out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
        torch.cuda.synchronize()
        assert fa.launch_count(name) == before + 1, (name, kw)
        ref, ref_lse = fa.flash_attention_ref_with_lse(
            q, k, v, d ** -0.5, kw.get("causal", False), kw.get("q_position_offset", 0),
            kw.get("q_segment_ids"), kw.get("kv_segment_ids"), kw.get("window"))
        case = (b, sq, sk, hq, hkv, d, kw.keys())
        if dt == torch.float32:
            torch.testing.assert_close(out, ref, atol=2e-5, rtol=0, msg=str(case))
        else:
            rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
            assert rel <= 1e-2, (case, rel)
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0, msg=str(case))


@pytest.mark.cuda
def test_strided_views_and_empty_rows():
    """K / V as bhsd views of one projection (the head stride is not H's),
    and rows whose band holds no key: out 0, LSE -inf."""
    _card()
    g = torch.Generator("cuda").manual_seed(1)
    b, s, hq, hkv, d = 2, 300, 8, 2, 128
    qkv = torch.randn(b, s, (hq + 2 * hkv) * d, device="cuda", generator=g).bfloat16()
    q, k, v = (x.unflatten(-1, (-1, d)) for x in qkv.split([hq * d, hkv * d, hkv * d], -1))
    out = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             causal=True, window=64, layout="bhsd")
    ref, _ = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5, True, 0, None, None, 64)
    rel = ((out.transpose(1, 2).float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= 1e-2, rel
    q2, k2, v2 = (torch.randn(1, n, 2, 64, device="cuda", generator=g) for n in (256, 64, 64))
    out, lse = fa.flash_attention_with_lse(q2, k2, v2, window=50)
    assert (out[:, 113:] == 0).all() and torch.isinf(lse[:, :, 113:]).all()
    assert torch.isfinite(lse[:, :, :113]).all()


# (B, Sq, Sk, Hq, Hkv, D, keyword arguments): groups of 4 and 8 across the
# kernel's 128-row query tile and 64-key tiles, band edges that fall inside
# a key tile (windows of 100, 70, 200, 50, 30), query offsets that are no
# multiple of 128, one row, fewer keys than queries.
EDGE_CASES = [
    (1, 129, 129, 8, 2, 128, dict(causal=True)),
    (2, 1056, 1056, 8, 1, 128, dict(causal=True)),
    (1, 300, 300, 8, 1, 128, dict(causal=True, window=100)),
    (1, 257, 257, 4, 1, 128, dict(window=70)),
    (1, 127, 500, 8, 2, 128, dict(causal=True, window=200, q_position_offset=203)),
    (1, 1, 300, 4, 1, 128, dict(causal=True, window=50, q_position_offset=299)),
    (1, 200, 100, 8, 2, 64, dict(window=30)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_edges(dtype):
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(2)
    for b, sq, sk, hq, hkv, d, kw in EDGE_CASES:
        q = torch.randn(b, sq, hq, d, device="cuda", generator=g).to(dt)
        kv = torch.randn(b, sk, 2 * hkv, d, device="cuda", generator=g).to(dt)
        k, v = kv[:, :, :hkv], kv[:, :, hkv:]  # strided views of one tensor
        name = _counter(kw, True)
        before = fa.launch_count(name)
        out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
        torch.cuda.synchronize()
        assert fa.launch_count(name) == before + 1, (name, kw)
        ref, ref_lse = fa.flash_attention_ref_with_lse(
            q, k, v, d ** -0.5, kw.get("causal", False), kw.get("q_position_offset", 0),
            None, None, kw.get("window"))
        case = (b, sq, sk, hq, hkv, d, kw)
        if dt == torch.float32:
            torch.testing.assert_close(out, ref, atol=2e-5, rtol=0, msg=str(case))
        else:
            rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
            assert rel <= 1e-2, (case, rel)
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0, msg=str(case))
