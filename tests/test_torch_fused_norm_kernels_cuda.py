"""The CUDA kernels K9 (fused add + RMSNorm), K10 (fused LayerScale + add +
RMSNorm) and K11 (fused qkv + QK-RMSNorm + blocked-K attention) vs their
plain PyTorch versions, on the card.

Needs an NVIDIA GPU with nvcc (the kernels have no CPU mode), so every test
here is marked `cuda` and skips without a card. The file imports neither
jax nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_fused_norm_kernels_cuda.py -m cuda
"""

import pytest
import torch

from internvideo_tpu_torch.ops import flash_attention as fa
from internvideo_tpu_torch.ops import rmsnorm as rms

# (rows shape, D): the JAX tests' shapes, a D with a scalar tail (the
# kernel's unvectorised path) and the 1B encoder's width
NORM_SHAPES = [((4, 16), 64), ((2, 123), 64), ((3, 7), 100), ((2, 65), 1408)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused norm / attention kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _ulps(a, b):
    """Largest distance in bf16 ulps between two bf16 tensors of one sign."""
    bits = [x.float().view(torch.int32) >> 16 for x in (a, b)]
    return (bits[0] - bits[1]).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype, res_dtype", [("float32", "float32"),
                                                ("bfloat16", "float32"),
                                                ("bfloat16", "bfloat16")])
def test_fused_add_rms_norm_kernel_matches_plain(x_dtype, res_dtype):
    _card()
    gen = torch.Generator("cuda").manual_seed(0)
    xdt, rdt = getattr(torch, x_dtype), getattr(torch, res_dtype)
    for lead, d in NORM_SHAPES:
        x = torch.randn(*lead, d, device="cuda", generator=gen).to(xdt)
        res = torch.randn(*lead, d, device="cuda", generator=gen).to(rdt)
        w = torch.randn(d, device="cuda", generator=gen) * 0.1 + 1.0
        before = rms.launch_count("fused_add_rms_norm")
        with torch.no_grad():
            y, newres = rms.fused_add_rms_norm(x, res, w)
        torch.cuda.synchronize()
        assert rms.launch_count("fused_add_rms_norm") == before + 1
        y_ref, newres_ref = rms.fused_add_rms_norm_ref(x, res, w)
        assert y.dtype == xdt and newres.dtype == rdt
        torch.testing.assert_close(newres, newres_ref, atol=0, rtol=0)
        if xdt == torch.float32:
            assert (y - y_ref).abs().max().item() <= 1e-6, (lead, d)
        else:
            assert _ulps(y, y_ref) <= 1, (lead, d)


@pytest.mark.cuda
def test_fused_add_rms_norm_kernel_is_inference_only():
    _card()
    x = torch.randn(4, 64, device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        rms.fused_add_rms_norm(x, torch.randn(4, 64, device="cuda"), torch.ones(64, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ls_add_rms_norm_kernel_matches_plain(dtype):
    _card()
    gen = torch.Generator("cuda").manual_seed(1)
    dt = getattr(torch, dtype)
    for lead, d in NORM_SHAPES:
        h = torch.randn(*lead, d, device="cuda", generator=gen).to(dt)
        res = torch.randn(*lead, d, device="cuda", generator=gen).to(dt)
        g = torch.randn(d, device="cuda", generator=gen) * 0.1
        w = torch.randn(d, device="cuda", generator=gen) * 0.1 + 1.0
        leaves = [t.requires_grad_() for t in (h, res, g, w)]
        before = rms.launch_count("fused_ls_add_rms_norm")
        y, newres = rms.fused_ls_add_rms_norm(*leaves)
        torch.cuda.synchronize()
        assert rms.launch_count("fused_ls_add_rms_norm") == before + 1
        plain = [t.detach().requires_grad_() for t in leaves]
        y_ref, newres_ref = rms.fused_ls_add_rms_norm_ref(*plain)
        torch.testing.assert_close(newres, newres_ref, atol=0, rtol=0)
        if dt == torch.float32:
            assert (y - y_ref).abs().max().item() <= 1e-6, (lead, d)
        else:
            assert _ulps(y, y_ref) <= 1, (lead, d)
        gy = torch.randn(y.shape, device="cuda", generator=gen)
        grads = torch.autograd.grad((y.float() * gy).sum(), leaves)
        ref_grads = torch.autograd.grad((y_ref.float() * gy).sum(), plain)
        for name, a, b in zip(("h", "residual", "gamma", "weight"), grads, ref_grads):
            assert _rel(a, b) <= (1e-5 if dt == torch.float32 else 1e-2), (name, lead, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_qkv_large_kernel_matches_plain(dtype):
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator("cuda").manual_seed(2)
    # the JAX test's (1, 1100 / 1040, 2 x 64) and the stage-2 tower's width at S = 1025
    for b, s, h, d in [(1, 1100, 2, 64), (1, 1040, 2, 64), (2, 1025, 16, 88)]:
        w = h * d
        qkv = torch.randn(b, s, 3 * w, device="cuda", generator=gen).to(dt)
        qw = torch.randn(w, device="cuda", generator=gen) * 0.1 + 1.0
        kw = torch.randn(w, device="cuda", generator=gen) * 0.1 + 1.0
        g = torch.randn(b, s, w, device="cuda", generator=gen).to(dt)
        leaves = [x.requires_grad_() for x in (qkv, qw, kw)]
        before = {n: fa.launch_count(n) for n in fa.KERNELS}
        out = fa.fused_qkv_rmsnorm_attention(*leaves, num_heads=h)
        torch.cuda.synchronize()
        fwd = {n: fa.launch_count(n) - before[n] for n in fa.KERNELS}
        assert fwd == {**dict.fromkeys(fa.KERNELS, 0), "fused_qkv_rstd": 1,
                       "fused_qkv_large_fwd": 1}, fwd
        grads = torch.autograd.grad((out.float() * g.float()).sum(), leaves)
        torch.cuda.synchronize()
        bwd = {n: fa.launch_count(n) - before[n] - fwd[n] for n in fa.KERNELS}
        assert bwd == {**dict.fromkeys(fa.KERNELS, 0), "flash_fwd": 1, "flash_bwd_dq": 1,
                       "flash_bwd_dkv": 1}, bwd

        plain = [x.detach().requires_grad_() for x in (qkv, qw, kw)]
        ref = fa.fused_qkv_large_ref(*plain, h, d ** -0.5)
        ref_grads = torch.autograd.grad((ref.float() * g.float()).sum(), plain)
        if dt == torch.float32:
            assert (out - ref).abs().max().item() <= 2e-5, (b, s, h, d)
            for name, a, r in zip(("qkv", "qw", "kw"), grads, ref_grads):
                torch.testing.assert_close(a, r, atol=5e-4, rtol=5e-4, msg=name)
        else:
            assert _rel(out, ref) <= 1e-2, (b, s, h, d)
            assert _rel(grads[0], ref_grads[0]) <= 2e-2, (b, s, h, d)


@pytest.mark.cuda
def test_dispatcher_allow_large_launches_k11():
    _card()
    b, s, h, d = 2, 1025, 16, 88
    qkv = torch.randn(b, s, 3 * h * d, device="cuda").bfloat16()
    qw, kw = torch.ones(h * d, device="cuda"), torch.ones(h * d, device="cuda")
    from internvideo_tpu_torch.ops.attention import fused_qkv_attention_or_none

    fa.reset_launch_count()
    with torch.no_grad():
        assert fused_qkv_attention_or_none(qkv, qw, kw, num_heads=h) is None
        out = fused_qkv_attention_or_none(qkv, qw, kw, num_heads=h, allow_large=True)
    torch.cuda.synchronize()
    assert out.shape == (b, s, h * d)
    assert {n: fa.launch_count(n) for n in fa.KERNELS} == {
        **dict.fromkeys(fa.KERNELS, 0), "fused_qkv_rstd": 1, "fused_qkv_large_fwd": 1}
