"""The CUDA fused qkv + whole-dim QK-RMSNorm + attention kernel (K3: its
row-statistics pre-pass and attention kernel) vs its plain PyTorch version,
on the card; its backward runs the unfused composition through K2 / K4b.

Needs an NVIDIA GPU with nvcc (the kernels have no CPU mode), so every test
here is marked `cuda` and skips without a card. The file imports neither
jax nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_fused_qkv_kernel_cuda.py -m cuda
"""

import pytest
import torch

from internvideo_tpu_torch.ops import flash_attention as fa

# (B, S, H, D): the JAX test's shapes at the kernels' head dims, the CLIP
# teacher's 25 heads of 128 at S = 257, and the student's S = 833.
SHAPES = [(2, 197, 4, 64), (1, 413, 8, 88), (2, 257, 25, 128), (1, 833, 16, 88)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused qkv kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_qkv_kernel_matches_plain(dtype):
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator("cuda").manual_seed(0)
    for b, s, h, d in SHAPES:
        w = h * d
        qkv = torch.randn(b, s, 3 * w, device="cuda", generator=gen).mul_(2).to(dt)
        qw = torch.randn(w, device="cuda", generator=gen) * 0.1 + 1.0
        kw = torch.randn(w, device="cuda", generator=gen) * 0.1 + 1.0
        g = torch.randn(b, s, w, device="cuda", generator=gen).to(dt)
        leaves = [x.requires_grad_() for x in (qkv, qw, kw)]
        before = {n: fa.launch_count(n) for n in fa.KERNELS}
        out = fa.fused_qkv_rmsnorm_attention(*leaves, num_heads=h)
        torch.cuda.synchronize()
        fwd = {n: fa.launch_count(n) - before[n] for n in fa.KERNELS}
        assert fwd == {**dict.fromkeys(fa.KERNELS, 0), "fused_qkv_rstd": 1,
                       "fused_qkv_fwd": 1}, fwd
        grads = torch.autograd.grad((out.float() * g.float()).sum(), leaves)
        torch.cuda.synchronize()
        bwd = {n: fa.launch_count(n) - before[n] - fwd[n] for n in fa.KERNELS}
        assert bwd == {**dict.fromkeys(fa.KERNELS, 0), "small_s_fwd": 1,
                       "small_s_bwd_dq": 1, "small_s_bwd_dkv": 1}, bwd

        plain = [x.detach().requires_grad_() for x in (qkv, qw, kw)]
        ref = fa.fused_qkv_ref(*plain, h, d ** -0.5)
        ref_grads = torch.autograd.grad((ref.float() * g.float()).sum(), plain)
        shape = (b, s, h, d)
        if dt == torch.float32:
            torch.testing.assert_close(out, ref, atol=2e-5, rtol=0, msg=str(shape))
            for name, x, r in zip(("qkv", "qw", "kw"), grads, ref_grads):
                torch.testing.assert_close(x, r, atol=5e-4, rtol=5e-4, msg=f"{name} {shape}")
        else:
            assert _rel(out, ref) <= 1e-2, (shape, _rel(out, ref))
            for name, x, r in zip(("qkv", "qw", "kw"), grads, ref_grads):
                assert _rel(x, r) <= 2e-2, (name, shape, _rel(x, r))


@pytest.mark.cuda
def test_fused_qkv_rejects_what_it_cannot_take():
    _card()
    ones = torch.ones(2 * 40, device="cuda")
    with pytest.raises(NotImplementedError, match="head dim"):
        fa.fused_qkv_rmsnorm_attention(torch.randn(1, 8, 3 * 80, device="cuda"), ones, ones,
                                       num_heads=2)
    ones = torch.ones(2 * 64, device="cuda")
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        fa.fused_qkv_rmsnorm_attention(torch.randn(1, 8, 3 * 128, device="cuda").half(), ones,
                                       ones, num_heads=2)
    misaligned = torch.randn(1, 8, 3 * 128 + 1, device="cuda").bfloat16()[..., 1:]
    with pytest.raises(ValueError, match="16-byte"):
        fa.fused_qkv_rmsnorm_attention(misaligned, ones, ones, num_heads=2)


# The edges of the wgmma kernel's 128-row query tiles (its two 64-row
# warpgroups) and 64-key stages, the teacher's S = 257 (a 1-row last tile)
# and the student's 833, up to the small-S limit.
EDGE_S = (1, 63, 64, 65, 127, 128, 129, 257, 833, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 72, 88, 128])
def test_fused_qkv_bf16_tile_edges_on_unaligned_views(d):
    """bf16 at every EDGE_S, the (B, S, 3W) projection a view whose base
    sits 16 bytes past a 128-byte boundary and whose rows are padded (as
    a strided slice of a wider projection): out rel-L2 <= 1e-2 against the
    plain version, one pre-pass and one attention launch a call, and two
    calls bit-identical."""
    _card()
    gen = torch.Generator("cuda").manual_seed(d)
    b, h = 2, 4
    w = h * d
    for s in EDGE_S:
        pitch = 3 * w + 8
        flat = torch.randn(b * s * pitch + 64, device="cuda", generator=gen).mul_(2).bfloat16()
        off = (128 - flat.data_ptr() % 128) % 128 // 2 + 8  # 16 bytes past a 128-byte boundary
        qkv = flat[off:off + b * s * pitch].view(b, s, pitch)[..., :3 * w]
        assert qkv.data_ptr() % 128 == 16
        qw = torch.randn(w, device="cuda", generator=gen) * 0.1 + 1.0
        kw = torch.randn(w, device="cuda", generator=gen) * 0.1 + 1.0
        before = {n: fa.launch_count(n) for n in fa.KERNELS}
        out = fa.fused_qkv_rmsnorm_attention(qkv, qw, kw, num_heads=h)
        again = fa.fused_qkv_rmsnorm_attention(qkv, qw, kw, num_heads=h)
        torch.cuda.synchronize()
        got = {n: fa.launch_count(n) - before[n] for n in fa.KERNELS}
        assert got == {**dict.fromkeys(fa.KERNELS, 0), "fused_qkv_rstd": 2,
                       "fused_qkv_fwd": 2}, (s, got)
        ref = fa.fused_qkv_ref(qkv, qw, kw, h, d ** -0.5)
        assert torch.isfinite(out).all(), s
        assert _rel(out, ref) <= 1e-2, (s, d, _rel(out, ref))
        assert torch.equal(out, again), (s, d)


@pytest.mark.cuda
def test_fused_qkv_counts_launches_by_sequence_length():
    """Each K3 launch is tallied under its S as well as in its count (the
    pretrain step's student and CLIP teacher share the kernel), and a
    reset clears both."""
    _card()
    gen = torch.Generator("cuda").manual_seed(7)
    h, d = 2, 64
    w = h * d
    qw = torch.ones(w, device="cuda")
    kw = torch.ones(w, device="cuda")
    fa.reset_launch_count()
    for s, calls in ((65, 2), (257, 1)):
        qkv = torch.randn(1, s, 3 * w, device="cuda", generator=gen).bfloat16()
        for _ in range(calls):
            fa.fused_qkv_rmsnorm_attention(qkv, qw, kw, num_heads=h)
    torch.cuda.synchronize()
    assert fa.launch_count("fused_qkv_fwd") == 3
    assert fa.fused_launch_counts("fused_qkv_fwd") == {65: 2, 257: 1}
    fa.reset_launch_count()
    assert fa.fused_launch_counts("fused_qkv_fwd") == {}
