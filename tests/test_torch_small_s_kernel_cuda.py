"""The CUDA small-S attention kernels (K2 forward, K4b dq and dk/dv) vs
their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with nvcc (the kernels have no CPU mode), so every test
here is marked `cuda` and skips without a card. The file imports neither
jax nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_small_s_kernel_cuda.py -m cuda
"""

import pytest
import torch

from internvideo_tpu_torch.ops import flash_attention as fa

# (B, Sq, Sk, H, D): the pretrain family at the student's head dim, the
# CLIP teacher's head dim 128, a ragged Sq != Sk, a single query row and
# the student's S = 833 (ragged against every tile).
SHAPES = [
    (2, 205, 205, 4, 88),
    (1, 413, 413, 8, 88),
    (2, 257, 257, 4, 128),
    (1, 205, 300, 2, 64),
    (1, 1, 257, 2, 88),
    (1, 833, 833, 2, 88),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the small-S kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_small_s_kernels_match_plain(dtype):
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator("cuda").manual_seed(0)
    for b, sq, sk, h, d in SHAPES:
        rnd = lambda s: torch.randn(b, s, h, d, device="cuda", generator=gen).to(dt)  # noqa: E731
        q, k, v, g = rnd(sq), rnd(sk), rnd(sk), rnd(sq)
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        before = {n: fa.launch_count(n) for n in fa.KERNELS}
        out = fa.flash_attention(q, k, v)
        grads = torch.autograd.grad((out.float() * g.float()).sum(), (q, k, v))
        torch.cuda.synchronize()
        after = {n: fa.launch_count(n) - before[n] for n in fa.KERNELS}
        assert after == {**dict.fromkeys(fa.KERNELS, 0), "small_s_fwd": 1,
                         "small_s_bwd_dq": 1, "small_s_bwd_dkv": 1}, after
        qd, kd, vd = (x.detach() for x in (q, k, v))
        scale = d ** -0.5
        ref, lse = fa.small_s_attention_ref(qd, kd, vd, scale)
        refs = fa.small_s_attention_bwd_ref(qd, kd, vd, ref, lse, g, scale)
        shape = (b, sq, sk, h, d)
        if dt == torch.float32:
            torch.testing.assert_close(out, ref, atol=2e-5, rtol=0, msg=str(shape))
            for name, x, r in zip(("dq", "dk", "dv"), grads, refs):
                torch.testing.assert_close(x, r, atol=5e-4, rtol=0, msg=f"{name} {shape}")
        else:
            assert _rel(out, ref) <= 1e-2, (shape, _rel(out, ref))
            for name, x, r in zip(("dq", "dk", "dv"), grads, refs):
                assert _rel(x, r) <= 1e-2, (name, shape, _rel(x, r))


@pytest.mark.cuda
def test_small_s_takes_strided_qkv_views_and_rejects_what_it_cannot_take():
    _card()
    b, s, h, d = 2, 833, 4, 88
    qkv = torch.randn(b, s, 3 * h * d, device="cuda").bfloat16()
    q, k, v = qkv.split(h * d, dim=-1)  # (B, S, H*D) views, the JAX layout
    out = fa.small_s_attention(q, k, v, h, d ** -0.5)
    ref, _ = fa.small_s_attention_ref(*(x.unflatten(-1, (h, d)) for x in (q, k, v)), d ** -0.5)
    assert _rel(out, ref.flatten(-2)) <= 1e-2
    apply = lambda *x: fa.SmallSAttention.apply(*x, 0.1)  # noqa: E731
    with pytest.raises(NotImplementedError, match="head dim"):
        apply(*(torch.randn(1, 8, 2, 40, device="cuda") for _ in range(3)))
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        apply(*(torch.randn(1, 8, 2, 64, device="cuda").half() for _ in range(3)))
    misaligned = torch.randn(1, 8, 2, 65, device="cuda").bfloat16()[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        apply(misaligned, misaligned, misaligned)


# The edges of the Hopper forward's tiles: 128 query rows a CTA (one row, one
# short, one past), 64 keys a stage (one key past one, two and three stages),
# and the vision towers' S = 196.
EDGES = [(sq, sk) for sq in (1, 127, 129) for sk in (65, 129, 193)] + [(196, 196)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", fa.SMALL_S_HEAD_DIMS)
def test_small_s_forward_tile_edges(dtype, d):
    """K2's output and LSE (the LSE K4b reads) at the tile edges."""
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(d)
    for sq, sk in EDGES:
        q = torch.randn(2, sq, 3, d, device="cuda", generator=g).to(dt)
        k, v = (torch.randn(2, sk, 3, d, device="cuda", generator=g).to(dt) for _ in range(2))
        before = fa.launch_count("small_s_fwd")
        out, lse = fa._flash_fwd_cuda(q, k, v, d ** -0.5, kernel="small_s_fwd")
        torch.cuda.synchronize()
        assert fa.launch_count("small_s_fwd") == before + 1
        ref, ref_lse = fa.small_s_attention_ref(q, k, v, d ** -0.5)
        shape = (sq, sk, d)
        if dt == torch.float32:
            torch.testing.assert_close(out, ref, atol=2e-5, rtol=0, msg=str(shape))
            torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=0, msg=str(shape))
        else:
            assert _rel(out, ref) <= 1e-2, (shape, _rel(out, ref))
            torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=0, msg=str(shape))


@pytest.mark.cuda
@pytest.mark.parametrize("d", fa.SMALL_S_HEAD_DIMS)
def test_small_s_on_projection_views_off_a_128_byte_boundary_is_deterministic(d):
    """q / k / v as (B, S, H*D) views of one projection whose base sits 16
    bytes past a 128-byte boundary (TMA's least alignment); two calls give
    bit-identical outputs."""
    _card()
    b, s, h = 2, 196, 4
    flat = torch.randn(b * s * 3 * h * d + 8, device="cuda").bfloat16()
    qkv = flat[8:].view(b, s, 3 * h * d)
    assert qkv.data_ptr() % 128 == 16
    q, k, v = qkv.split(h * d, dim=-1)
    before = fa.launch_count("small_s_fwd")
    out = fa.small_s_attention(q, k, v, h, d ** -0.5)
    again = fa.small_s_attention(q, k, v, h, d ** -0.5)
    torch.cuda.synchronize()
    assert fa.launch_count("small_s_fwd") == before + 2
    ref, _ = fa.small_s_attention_ref(*(x.unflatten(-1, (h, d)) for x in (q, k, v)), d ** -0.5)
    assert _rel(out, ref.flatten(-2)) <= 1e-2
    assert torch.equal(out, again)


# The edges of the Hopper backward's tiles: 128 query rows a dq CTA and 128
# keys a dk/dv CTA (64 at d 128), 64-key and 64-row stages (one short, one
# past each), one row or key, and the student's S = 833 (ragged against
# every tile).
BWD_EDGES = (1, 63, 65, 127, 129, 833)


@pytest.mark.cuda
@pytest.mark.parametrize("d", fa.SMALL_S_HEAD_DIMS)
def test_small_s_backward_tile_edges_on_projection_views(d):
    """K4b's dq / dk / dv in bf16 at every (Sq, Sk) pair of the tile edges,
    q from one projection and k / v from another, as (B, S, H, D) views
    (the layout the tower and the student give it), held to the plain
    version (rel-L2 <= 1e-2 each); a second call gives bit-identical
    gradients. With one key the softmax is constant, so dq and dk are zero
    in exact arithmetic and both routes give fp32 rounding noise (~1e-8):
    there they are held to max-abs <= 1e-4 instead."""
    _card()
    g = torch.Generator("cuda").manual_seed(100 + d)
    b, h = 2, 3
    for sq in BWD_EDGES:
        for sk in BWD_EDGES:
            qp = torch.randn(b, sq, 3 * h * d, device="cuda", generator=g).bfloat16()
            kvp = torch.randn(b, sk, 3 * h * d, device="cuda", generator=g).bfloat16()
            q = qp[..., :h * d].unflatten(-1, (h, d))
            k, v = (x.unflatten(-1, (h, d)) for x in kvp[..., h * d:].split(h * d, dim=-1))
            do = torch.randn(b, sq, h, d, device="cuda", generator=g).bfloat16()
            scale = d ** -0.5
            with torch.no_grad():
                out, lse = fa._flash_fwd_cuda(q, k, v, scale, kernel="small_s_fwd")
            before = {n: fa.launch_count(n) for n in ("small_s_bwd_dq", "small_s_bwd_dkv")}
            grads = fa._flash_bwd_cuda(q, k, v, out, lse, do, scale, prefix="small_s")
            again = fa._flash_bwd_cuda(q, k, v, out, lse, do, scale, prefix="small_s")
            torch.cuda.synchronize()
            assert {n: fa.launch_count(n) - c for n, c in before.items()} == {
                "small_s_bwd_dq": 2, "small_s_bwd_dkv": 2}
            refs = fa.small_s_attention_bwd_ref(q, k, v, out, lse, do, scale)
            for name, x, r, y in zip(("dq", "dk", "dv"), grads, refs, again):
                assert torch.isfinite(x.float()).all(), (name, sq, sk, d)
                if sk == 1 and name != "dv":
                    assert x.abs().max().item() <= 1e-4, (name, sq, sk, d)
                    assert r.abs().max().item() <= 1e-4, (name, sq, sk, d)
                else:
                    assert _rel(x, r) <= 1e-2, (name, sq, sk, d, _rel(x, r))
                assert torch.equal(x, y), (name, sq, sk, d)
