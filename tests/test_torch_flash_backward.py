"""Flash-attention backward of the PyTorch port vs the JAX package.

On the CPU the port's `FlashAttention` runs its plain forward and plain
backward (`flash_attention_bwd_ref`); its gradients are held against
`jax.grad` of the JAX Pallas kernels in interpret mode, run as
tests/test_flash_attention.py:65-77 runs them, at the JAX grad bar
(atol/rtol 5e-4). The CUDA kernels themselves are held against the plain
version on the card by test_torch_flash_bwd_kernel_cuda.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internvideo_tpu.ops.flash_attention import flash_attention as jax_flash
from internvideo_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash_lse
from internvideo_tpu_torch.nn.transformer import Attention
from internvideo_tpu_torch.ops import flash_attention as fa
from internvideo_tpu_torch.ops.attention import dot_product_attention

# (B, Sq, Sk, H, D): the JAX kernel tests' shape, the ragged route at head
# dim 88, and both one-sided tails.
SHAPES = [
    (2, 256, 256, 2, 64),
    (1, 257, 257, 2, 88),
    (1, 256, 263, 2, 64),
    (1, 263, 256, 2, 64),
]


def _inputs(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(b, sq, h, d), f(b, sk, h, d), f(b, sk, h, d), f(b, sq, h, d), f(b, h, sq)


def _port_grads(q, k, v, g, gl=None):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = fa.flash_attention_with_lse(tq, tk, tv)
    loss = (out * torch.from_numpy(g)).sum()
    if gl is not None:
        loss = loss + (lse * torch.from_numpy(gl)).sum()
    return [x.numpy() for x in torch.autograd.grad(loss, (tq, tk, tv))]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_matches_jax_grad(shape):
    q, k, v, g, _ = _inputs(*shape, seed=0)

    def loss(q, k, v):
        out = jax_flash(q, k, v, interpret=True, block_q=128, block_k=128)
        return jnp.sum(out * g)

    ref = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    for name, a, r in zip(("dq", "dk", "dv"), _port_grads(q, k, v, g), ref):
        np.testing.assert_allclose(a, np.asarray(r), atol=5e-4, rtol=5e-4, err_msg=name)


def test_lse_cotangent_matches_jax_grad():
    q, k, v, g, gl = _inputs(1, 256, 256, 2, 64, seed=1)

    def loss(q, k, v):
        out, lse = jax_flash_lse(q, k, v, interpret=True, block_q=128, block_k=128)
        return jnp.sum(out * g) + jnp.sum(lse * gl)

    ref = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    for name, a, r in zip(("dq", "dk", "dv"), _port_grads(q, k, v, g, gl), ref):
        np.testing.assert_allclose(a, np.asarray(r), atol=5e-4, rtol=5e-4, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_ref_matches_autograd_of_plain_forward(dtype):
    dt = getattr(torch, dtype)
    q, k, v, g, gl = (torch.from_numpy(x) for x in _inputs(2, 33, 40, 2, 88, seed=2))
    q, k, v, g = (x.to(dt) for x in (q, k, v, g))
    scale = 88 ** -0.5
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = fa.flash_attention_ref_with_lse(*leaves, scale)
    auto = torch.autograd.grad((out.float() * g.float()).sum() + (lse * gl).sum(), leaves)
    ref = fa.flash_attention_bwd_ref(q, k, v, out.detach(), lse.detach(), g, scale, lse_ct=gl)
    for name, a, r in zip(("dq", "dk", "dv"), ref, auto):
        assert a.dtype == dt, name
        if dt == torch.float32:
            torch.testing.assert_close(a, r, atol=1e-5, rtol=1e-5, msg=name)
        else:  # the bf16 cast chain rounds ds and p where autograd does not
            rel = ((a.float() - r.float()).norm() / r.float().norm()).item()
            assert rel <= 1e-2, (name, rel)


def test_kernel_route_output_carries_the_gradient():
    """The kernel route returns the autograd node of its Function (on a
    CUDA tensor the forward fills the output through ctypes, so only this
    node carries gradients to q, k and v): SmallSAttention at S <= 1024,
    FlashAttention for flash_attention_with_lse; and the qkv projection and
    QK norms of an Attention layer (on the kernel route: the fused qkv op)
    get the same gradients as on the plain route."""
    q, k, v, g, _ = (torch.from_numpy(x) for x in _inputs(1, 20, 20, 2, 64, seed=3))
    q.requires_grad_()
    out = dot_product_attention(q, k, v, impl="kernel")
    assert type(out.grad_fn).__name__ == "SmallSAttentionBackward"
    out, _ = fa.flash_attention_with_lse(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"

    torch.manual_seed(0)
    layer = Attention(128, 2, attn_impl="kernel")
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=0.1)
    x = torch.randn(2, 17, 128)
    grads = {}
    for impl in ("kernel", "plain"):
        layer.attn_impl = impl
        layer.zero_grad()
        layer(x).square().sum().backward()
        grads[impl] = {n: p.grad.clone() for n, p in layer.named_parameters()}
    for name in ("qkv.weight", "q_norm.weight", "k_norm.weight"):
        assert grads["kernel"][name].abs().sum() > 0, name
        torch.testing.assert_close(grads["kernel"][name], grads["plain"][name],
                                   atol=1e-5, rtol=1e-5, msg=name)


def test_cpu_backward_never_builds_or_launches(monkeypatch):
    from internvideo_tpu_torch.ops import _build

    def no_build():
        raise AssertionError("the CUDA library was requested for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", no_build)
    fa.reset_launch_count()
    q, k, v, g, _ = (torch.from_numpy(x) for x in _inputs(1, 9, 9, 2, 88, seed=4))
    q.requires_grad_()
    fa.flash_attention(q, k, v).backward(g)
    assert q.grad is not None
    assert all(fa.launch_count(n) == 0 for n in fa.KERNELS)
