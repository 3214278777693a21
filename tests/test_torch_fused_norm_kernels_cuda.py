"""The CUDA kernels K9 (fused add + RMSNorm), K10 (fused LayerScale + add +
RMSNorm) and K11 (fused qkv + QK-RMSNorm + blocked-K attention: its normed-k
pre-pass and wgmma + TMA walk) vs their plain PyTorch versions, on the card.

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


# K11's bf16 edges against its 128-row query tiles and 64-key stages: S =
# 1025 and 4097 leave a 1-row last tile (one warpgroup walks alone), 1088 a
# last tile of 64 rows (alone, its last stage full), 1089 one row past it
# (two warpgroups, the second with one row; one key past a stage), 8192 the
# top of the range (128 key tiles, nothing staged grows with S).
K11_EDGES = (1025, 1088, 1089, 4097, 8192)


@pytest.mark.cuda
@pytest.mark.parametrize("d, h", [(64, 4), (88, 16)])
@pytest.mark.parametrize("s", K11_EDGES)
def test_fused_qkv_large_bf16_edges(s, d, h):
    """K11 in bf16: the pre-pass's 1/rms within 1e-6 (relative) of the plain
    pre-pass's, its normed k rows bit-identical to the cast chain on its own
    1/rms and within two bf16 ulps of the plain pre-pass's (`rms_norm` of the
    k slice: the mean's summation order may move a row's 1/rms by an fp32
    ulp, which moves bf16(x * rstd) by at most one ulp and, through a weight
    below 2, bf16(w * that) by at most two); one pre-pass and one attention
    launch an op; out rel-L2 <= 1e-2 against the plain version,
    bit-identical across two calls."""
    _card()
    gen = torch.Generator("cuda").manual_seed(s + d)
    b, w = (1 if s > 4096 else 2), h * d
    qkv = (torch.randn(b, s, 3 * w, device="cuda", generator=gen) * 2).bfloat16()
    qw, kw = (torch.randn(w, device="cuda", generator=gen) * 0.1 + 1.0 for _ in range(2))
    with torch.no_grad():
        q_rstd, k_rstd, k_normed = fa._fused_prepass_cuda(qkv, kw, 1e-6, normed_k=True)
        ref_q, ref_k, ref_normed = fa.fused_qkv_large_prepass_ref(qkv, kw)
        own = (kw * (qkv[..., w:2 * w].float() * k_rstd[..., None]).bfloat16()).bfloat16()
        torch.cuda.synchronize()
        for got, ref in ((q_rstd, ref_q), (k_rstd, ref_k)):
            assert ((got - ref).abs() / ref).max().item() <= 1e-6, (s, d)
        assert torch.equal(k_normed, own), (s, d)
        assert _ulps(k_normed, ref_normed) <= 2, (s, d)

        fa.reset_launch_count()
        out = fa.fused_qkv_rmsnorm_attention(qkv, qw, kw, num_heads=h)
        torch.cuda.synchronize()
        counts = {n: fa.launch_count(n) for n in fa.KERNELS}
        assert counts == {**dict.fromkeys(fa.KERNELS, 0), "fused_qkv_rstd": 1,
                          "fused_qkv_large_fwd": 1}, counts
        assert fa.fused_launch_counts("fused_qkv_large_fwd") == {s: 1}
        again = fa.fused_qkv_rmsnorm_attention(qkv, qw, kw, num_heads=h)
        ref = fa.fused_qkv_large_ref(qkv, qw, kw, h, d ** -0.5)
        torch.cuda.synchronize()
    assert torch.equal(out, again), (s, d)
    assert _rel(out, ref) <= 1e-2, (s, d, _rel(out, ref))


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
