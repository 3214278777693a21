"""The CUDA causal / narrow-v flash forward (K5, csrc/flash_fwd_causal.cu) vs
its plain PyTorch version, on the card.

Needs an NVIDIA GPU with nvcc (the kernel has no CPU mode), so every test
here is marked `cuda` and skips without a card. The file imports neither
jax nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_causal_flash_kernel_cuda.py -m cuda
"""

import pytest
import torch

from internvideo_tpu_torch.ops import flash_attention as fa

# (B, Sq, Sk, H, d_qk, d_v, causal, q_position_offset): the JAX kernel
# tests' causal cases (tests/test_flash_attention.py:26, :152, :162, :569),
# a ragged S, and the two LLM presets' head dims.
CASES = [
    (2, 256, 256, 2, 64, 64, True, 0),
    (1, 200, 200, 2, 64, 64, True, 0),
    (1, 72, 200, 2, 64, 64, True, 128),
    (1, 100, 200, 2, 64, 64, True, 0),
    (2, 200, 200, 4, 64, 32, True, 0),
    (2, 200, 200, 4, 64, 32, False, 0),
    (1, 1, 130, 2, 64, 32, True, 129),
    (1, 333, 333, 2, 256, 128, True, 0),
    (1, 97, 300, 2, 192, 128, True, 203),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the causal flash kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain(dtype):
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(0)
    for b, sq, sk, h, d, dv, causal, off in CASES:
        q = torch.randn(b, sq, h, d, device="cuda", generator=g).to(dt)
        k = torch.randn(b, sk, h, d, device="cuda", generator=g).to(dt)
        v = torch.randn(b, sk, h, dv, device="cuda", generator=g).to(dt)
        before = fa.launch_count("flash_fwd_causal")
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal, q_position_offset=off)
        torch.cuda.synchronize()
        assert fa.launch_count("flash_fwd_causal") == before + 1
        ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5, causal, off)
        case = (b, sq, sk, h, d, dv, causal, off)
        if dt == torch.float32:
            torch.testing.assert_close(out, ref, atol=2e-5, rtol=0, msg=str(case))
            torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=0, msg=str(case))
        else:
            assert _rel(out, ref) <= 1e-2, (case, _rel(out, ref))
            torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=0, msg=str(case))


@pytest.mark.cuda
def test_mla_views_rows_without_keys_and_refusals():
    """q / k / v as MLAttention.__call__ makes them (k, v einsum outputs, q a
    concat) and as (B, H, S, D) views; rows that see no key; what the
    kernel does not take raises instead of falling back."""
    _card()
    g = torch.Generator("cuda").manual_seed(1)
    b, s, h, d, dv = 2, 300, 4, 192, 128
    kv = torch.randn(b, s, h, d + dv, device="cuda", generator=g).bfloat16()
    k, v = kv[..., :d], kv[..., d:]  # strided views of one tensor
    q = torch.randn(b, h, s, d, device="cuda", generator=g).bfloat16()  # bhsd storage
    before = fa.launch_count("flash_fwd_causal")
    out = fa.flash_attention(q.transpose(1, 2), k, v, causal=True)
    assert fa.launch_count("flash_fwd_causal") == before + 1
    ref, _ = fa.flash_attention_ref_with_lse(q.transpose(1, 2), k, v, d ** -0.5, True)
    assert _rel(out, ref) <= 1e-2
    out_bhsd = fa.flash_attention(q, k.transpose(1, 2), v.transpose(1, 2), causal=True,
                                  layout="bhsd")
    torch.testing.assert_close(out_bhsd.transpose(1, 2), out, atol=0, rtol=0)

    q32, k32 = (torch.randn(1, 70, 2, 64, device="cuda", generator=g) for _ in range(2))
    v32 = torch.randn(1, 70, 2, 32, device="cuda", generator=g)
    out, lse = fa.flash_attention_with_lse(q32, k32, v32, causal=True, q_position_offset=-65)
    assert torch.isinf(lse[:, :, :65]).all() and (out[:, :65] == 0).all()
    assert torch.isfinite(lse[:, :, 65:]).all()

    with pytest.raises(NotImplementedError, match="K5"):
        fa.flash_attention_with_lse(*(torch.randn(1, 8, 2, 88, device="cuda")
                                      for _ in range(3)), causal=True)
    # grouped-query heads take K5's GQA path: one K/V head for both q heads
    before = fa.launch_count("flash_fwd_causal_gqa")
    gqa = fa.flash_attention(q32, k32[:, :, :1], v32[:, :, :1], causal=True)
    torch.cuda.synchronize()
    assert fa.launch_count("flash_fwd_causal_gqa") == before + 1
    ref, _ = fa.flash_attention_ref_with_lse(q32, k32[:, :, :1], v32[:, :, :1], 64 ** -0.5, True)
    torch.testing.assert_close(gqa, ref, atol=2e-5, rtol=0)
    # the backward is instantiated for the training pairs only: the 2B
    # serving preset's (192, 128) raises, naming K5
    leaf = q.transpose(1, 2).float().requires_grad_()
    with pytest.raises(NotImplementedError, match="K5"):
        fa.flash_attention(leaf, k.float(), v.float(), causal=True).sum().backward()


# (B, Sq, Sk, H, d_qk, d_v, causal, q_position_offset): the edges of the
# kernel's 128-row query tile (two warpgroups of 64) and its 64-key
# tiles: one row, a tile less or more one row, the HiCo
# prompt's 1056 rows (a ragged 32-row tail), fewer keys than queries, query
# offsets that are no multiple of 128, and each small pair.
EDGE_CASES = [
    (1, 1, 1, 2, 256, 128, True, 0),
    (2, 1, 300, 2, 192, 128, True, 299),
    (1, 127, 127, 2, 256, 128, True, 0),
    (1, 129, 129, 2, 192, 128, True, 0),
    (1, 1056, 1056, 4, 192, 128, True, 0),
    (1, 1056, 1056, 2, 256, 128, True, 0),
    (2, 300, 130, 2, 256, 128, False, 0),
    (1, 300, 200, 2, 192, 128, True, 0),
    (1, 129, 400, 2, 256, 128, True, 203),
    (1, 100, 1100, 2, 192, 128, True, 1000),
    (1, 257, 257, 2, 64, 32, True, 0),
    (1, 129, 129, 2, 32, 32, True, 0),
]


def _offset_view(shape, g, dtype, pad):
    """A (B, S, H, D) tensor whose storage starts `pad` elements into its
    buffer: a base 2 * pad bytes past the allocation's alignment."""
    n = 1
    for x in shape:
        n *= x
    buf = torch.randn(n + pad, device="cuda", generator=g).to(dtype)
    return buf[pad:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_edges(dtype):
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(2)
    for b, sq, sk, h, d, dv, causal, off in EDGE_CASES:
        q = torch.randn(b, sq, h, d, device="cuda", generator=g).to(dt)
        kv = torch.randn(b, sk, h, d + dv, device="cuda", generator=g).to(dt)
        k, v = kv[..., :d], kv[..., d:]  # strided views of one tensor
        before = fa.launch_count("flash_fwd_causal")
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal, q_position_offset=off)
        torch.cuda.synchronize()
        assert fa.launch_count("flash_fwd_causal") == before + 1
        ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5, causal, off)
        case = (b, sq, sk, h, d, dv, causal, off)
        if dt == torch.float32:
            torch.testing.assert_close(out, ref, atol=2e-5, rtol=0, msg=str(case))
            torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=0, msg=str(case))
        else:
            assert _rel(out, ref) <= 1e-2, (case, _rel(out, ref))
            torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=0, msg=str(case))


@pytest.mark.cuda
def test_base_offset_by_16_bytes():
    """q, k and v whose base pointers sit 16 bytes past a 128-byte boundary
    (the wrapper asks for 16-byte alignment, TMA for no more), k / v with a
    row stride that is not their width."""
    _card()
    g = torch.Generator("cuda").manual_seed(3)
    for b, s, h, d, dv in ((2, 300, 4, 256, 128), (1, 1056, 2, 192, 128)):
        q = _offset_view((b, s, h, d), g, torch.bfloat16, 8)
        kv = _offset_view((b, s, h, d + dv + 8), g, torch.bfloat16, 0)
        k, v = kv[..., 8:8 + d], kv[..., 8 + d:]
        assert q.data_ptr() % 128 == 16 and k.data_ptr() % 16 == 0
        out, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
        ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5, True)
        assert _rel(out, ref) <= 1e-2, ((b, s, h, d, dv), _rel(out, ref))
        torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=0)
