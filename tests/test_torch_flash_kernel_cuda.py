"""The CUDA flash kernel vs its plain PyTorch version, on the card.

Needs an NVIDIA GPU with nvcc (the kernel has no CPU mode), so every test
here is marked `cuda` and skips without a card. The file imports neither
jax nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_flash_kernel_cuda.py -m cuda
"""

import pytest
import torch

from internvideo_tpu_torch.ops import flash_attention as fa

# (B, Sq, Sk, H, D): the JAX kernel tests' shape, ragged head dim 88, both
# one-sided tails, a single query row, and the encoder's S = 4097.
SHAPES = [
    (2, 256, 256, 2, 64),
    (1, 257, 257, 2, 88),
    (1, 256, 263, 2, 64),
    (1, 263, 256, 2, 64),
    (1, 1, 257, 2, 88),
    (1, 4097, 4097, 2, 88),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain(dtype):
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(0)
    for b, sq, sk, h, d in SHAPES:
        q = torch.randn(b, sq, h, d, device="cuda", generator=g).to(dt)
        k = torch.randn(b, sk, h, d, device="cuda", generator=g).to(dt)
        v = torch.randn(b, sk, h, d, device="cuda", generator=g).to(dt)
        before = fa.launch_count()
        out, lse = fa.flash_attention_with_lse(q, k, v)
        torch.cuda.synchronize()
        assert fa.launch_count() == before + 1
        ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5)
        if dt == torch.float32:
            torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
            torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=0)
        else:
            rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
            assert rel <= 1e-2, ((b, sq, sk, h, d), rel)
            torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=0)


@pytest.mark.cuda
def test_kernel_takes_strided_qkv_views_and_rejects_what_it_cannot_take():
    """K1 through flash_attention_with_lse, which stays on it at any S (the
    short-S route of flash_attention is K2: test_torch_small_s_kernel_cuda.py)."""
    _card()
    b, s, h, d = 2, 130, 4, 88
    qkv = torch.randn(b, s, 3 * h * d, device="cuda").bfloat16()
    q, k, v = (x.unflatten(-1, (h, d)) for x in qkv.split(h * d, dim=-1))
    before = fa.launch_count()
    out, _ = fa.flash_attention_with_lse(q, k, v)
    assert fa.launch_count() == before + 1
    ref = fa.flash_attention_ref(q, k, v, d ** -0.5)
    assert ((out.float() - ref.float()).norm() / ref.float().norm()).item() <= 1e-2
    with pytest.raises(NotImplementedError, match="head dim"):
        fa.flash_attention_with_lse(*(torch.randn(1, 8, 2, 40, device="cuda") for _ in range(3)))
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        fa.flash_attention_with_lse(
            *(torch.randn(1, 8, 2, 64, device="cuda").half() for _ in range(3)))
    with pytest.raises(NotImplementedError, match="K5"):
        fa.flash_attention_with_lse(q, k, v, causal=True)
    misaligned = torch.randn(1, 8, 2, 65, device="cuda").bfloat16()[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_with_lse(misaligned, misaligned, misaligned)


# The edges of the Hopper kernel's tiles: 128 query rows a CTA (one row, one
# short, one past), 64 keys a stage (one key past one, two and three stages).
EDGES = [(sq, sk) for sq in (1, 127, 129) for sk in (65, 129, 193)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", fa.KERNEL_HEAD_DIMS)
def test_kernel_tile_edges(dtype, d):
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(d)
    for sq, sk in EDGES:
        q = torch.randn(2, sq, 3, d, device="cuda", generator=g).to(dt)
        k, v = (torch.randn(2, sk, 3, d, device="cuda", generator=g).to(dt) for _ in range(2))
        before = fa.launch_count()
        out, lse = fa.flash_attention_with_lse(q, k, v)
        torch.cuda.synchronize()
        assert fa.launch_count() == before + 1
        ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5)
        if dt == torch.float32:
            torch.testing.assert_close(out, ref, atol=2e-5, rtol=0, msg=str((sq, sk, d)))
            torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=0, msg=str((sq, sk, d)))
        else:
            rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
            assert rel <= 1e-2, ((sq, sk, d), rel)
            torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=0, msg=str((sq, sk, d)))


@pytest.mark.cuda
@pytest.mark.parametrize("d", fa.KERNEL_HEAD_DIMS)
def test_kernel_on_projection_views_off_a_128_byte_boundary_is_deterministic(d):
    """q / k / v as views of one (B, S, 3 H d) projection whose base sits 16
    bytes past a 128-byte boundary (TMA's least alignment), k / v at their
    H d offsets; two calls give bit-identical outputs."""
    _card()
    b, s, h = 2, 300, 4
    flat = torch.randn(b * s * 3 * h * d + 8, device="cuda").bfloat16()
    qkv = flat[8:].view(b, s, 3 * h * d)
    assert qkv.data_ptr() % 128 == 16
    q, k, v = (x.unflatten(-1, (h, d)) for x in qkv.split(h * d, dim=-1))
    out, lse = fa.flash_attention_with_lse(q, k, v)
    again, lse_again = fa.flash_attention_with_lse(q, k, v)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5)
    assert ((out.float() - ref.float()).norm() / ref.float().norm()).item() <= 1e-2
    torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=0)
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
