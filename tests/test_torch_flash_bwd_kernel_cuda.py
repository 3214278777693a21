"""The CUDA flash backward kernels (dq, dk/dv) vs their plain PyTorch
version, on the card.

Needs an NVIDIA GPU with nvcc (the kernels have no CPU mode), so every test
here is marked `cuda` and skips without a card. The file imports neither
jax nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_flash_bwd_kernel_cuda.py -m cuda
"""

import pytest
import torch

from internvideo_tpu_torch.ops import flash_attention as fa

# (B, Sq, Sk, H, D): the JAX kernel tests' shape, ragged head dim 88, both
# one-sided tails, a single query row, and the finetune's S = 2049.
SHAPES = [
    (2, 256, 256, 2, 64),
    (1, 257, 257, 2, 88),
    (1, 256, 263, 2, 64),
    (1, 263, 256, 2, 64),
    (1, 1, 257, 2, 88),
    (1, 2049, 2049, 2, 88),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _grads(q, k, v, g, gl=None):
    """(dq, dk, dv) of sum(out * g) (+ sum(lse * gl)) through the kernels."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out, lse = fa.flash_attention_with_lse(q, k, v)
    loss = (out.float() * g.float()).sum()
    if gl is not None:
        loss = loss + (lse * gl).sum()
    return out, lse, torch.autograd.grad(loss, (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernels_match_plain(dtype):
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator("cuda").manual_seed(0)
    for b, sq, sk, h, d in SHAPES:
        q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dt)
        k = torch.randn(b, sk, h, d, device="cuda", generator=gen).to(dt)
        v = torch.randn(b, sk, h, d, device="cuda", generator=gen).to(dt)
        g = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dt)
        before = {n: fa.launch_count(n) for n in fa.KERNELS}
        out, lse, grads = _grads(q, k, v, g)
        torch.cuda.synchronize()
        k1_k4a = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        assert {n: fa.launch_count(n) - before[n] for n in fa.KERNELS} == {
            n: int(n in k1_k4a) for n in fa.KERNELS}
        ref = fa.flash_attention_bwd_ref(q, k, v, out, lse, g, d ** -0.5)
        for name, x, r in zip(("dq", "dk", "dv"), grads, ref):
            assert x.dtype == dt and x.shape == r.shape, name
            if dt == torch.float32:
                # the JAX grad bar, tests/test_flash_attention.py:77
                torch.testing.assert_close(x, r, atol=5e-4, rtol=0, msg=name)
            else:
                assert _rel(x, r) <= 1e-2, ((b, sq, sk, h, d), name, _rel(x, r))


@pytest.mark.cuda
def test_lse_cotangent_and_strided_views():
    _card()
    gen = torch.Generator("cuda").manual_seed(1)
    b, s, h, d = 2, 130, 4, 88
    for dt in (torch.float32, torch.bfloat16):
        qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=gen).to(dt)
        q, k, v = (x.unflatten(-1, (h, d)) for x in qkv.split(h * d, dim=-1))
        g = torch.randn(b, s, h, d, device="cuda", generator=gen).to(dt)
        gl = torch.randn(b, h, s, device="cuda", generator=gen)
        out, lse, grads = _grads(q, k, v, g, gl)
        ref = fa.flash_attention_bwd_ref(q, k, v, out, lse, g, d ** -0.5, lse_ct=gl)
        for name, x, r in zip(("dq", "dk", "dv"), grads, ref):
            if dt == torch.float32:
                torch.testing.assert_close(x, r, atol=5e-4, rtol=0, msg=name)
            else:
                assert _rel(x, r) <= 1e-2, (name, _rel(x, r))


@pytest.mark.cuda
def test_gradients_reach_the_projection():
    """The kernel route's output carries the autograd node, so a loss through
    attention gives q/k/v projection weights a nonzero gradient."""
    _card()
    gen = torch.Generator("cuda").manual_seed(2)
    x = torch.randn(1, 65, 176, device="cuda", generator=gen)
    w = torch.randn(3 * 176, 176, device="cuda", generator=gen).mul_(0.05).requires_grad_()
    q, k, v = (t.unflatten(-1, (2, 88)) for t in (x @ w.t()).split(176, dim=-1))
    out, _ = fa.flash_attention_with_lse(q, k, v)  # K1 / K4a at any S
    assert out.grad_fn is not None
    (gw,) = torch.autograd.grad(out.square().sum(), (w,))
    assert torch.isfinite(gw).all()
    for i in range(3):
        assert gw[i * 176:(i + 1) * 176].abs().sum() > 0, "qkv"[i]


# The edges of the bf16 kernels' tiles (csrc/flash_bwd_causal_{dq,dkv}.cu:
# 128 query rows a dq CTA, 64 keys a step; 128 keys a dk/dv CTA at d 64 and
# 88, 64 rows a step, walked in halves of 32 rows at d 88): (B, Sq, Sk, H)
# one past and one short of 64 and 128, Sq != Sk both ways, Sq < 64.
EDGE_SHAPES = [
    (1, 65, 63, 2),
    (1, 63, 65, 2),
    (1, 129, 127, 2),
    (1, 127, 129, 2),
    (2, 33, 200, 2),
    (1, 200, 33, 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 88])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tile_edges_with_lse_cotangent(dtype, d):
    _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator("cuda").manual_seed(3)
    for b, sq, sk, h in EDGE_SHAPES:
        q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dt)
        k, v = (torch.randn(b, sk, h, d, device="cuda", generator=gen).to(dt) for _ in range(2))
        g = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dt)
        gl = torch.randn(b, h, sq, device="cuda", generator=gen)
        out, lse, grads = _grads(q, k, v, g, gl)
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_ref(q, k, v, out, lse, g, d ** -0.5, lse_ct=gl)
        for name, x, r in zip(("dq", "dk", "dv"), grads, ref):
            assert x.dtype == dt and x.shape == r.shape, name
            if dt == torch.float32:
                torch.testing.assert_close(x, r, atol=5e-4, rtol=0,
                                           msg=f"{(b, sq, sk, h, d)} {name}")
            else:
                assert _rel(x, r) <= 1e-2, ((b, sq, sk, h, d), name, _rel(x, r))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 88])
def test_offset_projection_views_and_determinism(d):
    """q / k / v as strided views of one (B, S, 3 H d) projection whose base
    is 16 bytes past its allocation's, in bf16 against the plain version;
    two calls give bit-identical dq, dk and dv (two kernels, no atomics)."""
    _card()
    gen = torch.Generator("cuda").manual_seed(4)
    b, s, h = 2, 193, 4
    flat = torch.randn(b * s * 3 * h * d + 8, device="cuda", generator=gen).bfloat16()
    qkv = flat[8:].view(b, s, 3 * h * d)  # 8 bf16 = 16 bytes past the allocation
    q, k, v = (x.unflatten(-1, (h, d)) for x in qkv.split(h * d, dim=-1))
    assert q.data_ptr() % 128 == 16
    g = torch.randn(b, s, h, d, device="cuda", generator=gen).bfloat16()
    out, lse, first = _grads(q, k, v, g)
    _, _, second = _grads(q, k, v, g)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_ref(q, k, v, out, lse, g, d ** -0.5)
    for name, x, y, r in zip(("dq", "dk", "dv"), first, second, ref):
        assert torch.equal(x, y), f"{name} differs between two calls"
        assert _rel(x, r) <= 1e-2, (name, _rel(x, r))
