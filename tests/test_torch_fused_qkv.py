"""Fused qkv slice + whole-dim QK-RMSNorm + small-S attention (K3) of the
PyTorch port vs the JAX package.

On the CPU the port's `FusedQKVAttention` runs its plain version forward
and differentiates the unfused composition backward; both are held against
the JAX op `_fused_qkv_small_s(..., interpret=True)` with `jax.grad`, as
tests/test_flash_attention.py:398-447 runs it, at the JAX bars (2e-5
forward, 5e-4 grads in qkv, q weight and k weight). The dispatcher and the
encoder's Attention layer are checked for where they take the fused route.
The CUDA kernel is held against the plain version on the card by
test_torch_fused_qkv_kernel_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import internvideo_tpu.ops.flash_attention as jfa
from internvideo_tpu.ops.attention import fused_qkv_attention_or_none as jax_fused_or_none
from internvideo_tpu_torch.nn.transformer import Attention
from internvideo_tpu_torch.ops import _build
from internvideo_tpu_torch.ops import flash_attention as fa
from internvideo_tpu_torch.ops.attention import fused_qkv_attention_or_none


def _inputs(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    w = h * d
    return (rng.standard_normal((b, s, 3 * w)).astype(np.float32),
            (rng.standard_normal(w) * 0.1 + 1.0).astype(np.float32),
            (rng.standard_normal(w) * 0.1 + 1.0).astype(np.float32),
            rng.standard_normal((b, s, w)).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 197, 4, 32), (1, 413, 8, 24)],
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_qkv_plain_matches_jax_forward_and_grads(shape):
    b, s, h, d = shape
    qkv, qw, kw, g = _inputs(*shape, seed=7 + s)

    def jax_fused(qkv, qw, kw):
        return jfa._fused_qkv_small_s(qkv, qw, kw, h, d, d ** -0.5, 1e-6, True)

    ref = jax_fused(qkv, qw, kw)
    ref_grads = jax.grad(lambda *a: jnp.sum(jax_fused(*a) * g), argnums=(0, 1, 2))(qkv, qw, kw)

    tqkv, tqw, tkw = (torch.from_numpy(x).requires_grad_() for x in (qkv, qw, kw))
    out = fa.fused_qkv_rmsnorm_attention(tqkv, tqw, tkw, num_heads=h)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tqkv, tqw, tkw))
    for name, a, r in zip(("qkv", "qw", "kw"), grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=5e-4, rtol=5e-4,
                                   err_msg=f"{name} s={s}")


def test_dispatcher_declines_where_jax_declines():
    """On the CPU "auto" declines in both packages (JAX resolves it to xla
    off the TPU); on the kernel route an over-threshold S declines unless
    `allow_large` opts in to K11; an eligible S on the forced kernel route
    runs the op."""
    qkv, qw, kw, _ = _inputs(1, 413, 8, 24, seed=1)
    assert jax_fused_or_none(qkv, qw, kw, num_heads=8) is None
    tqkv, tqw, tkw = (torch.from_numpy(x) for x in (qkv, qw, kw))
    assert fused_qkv_attention_or_none(tqkv, tqw, tkw, num_heads=8) is None

    big = np.zeros((1, fa.SMALL_S_MAX + 1, 3 * 64), np.float32)
    assert jax_fused_or_none(big, np.ones(64), np.ones(64), num_heads=4, impl="pallas") is None
    assert fused_qkv_attention_or_none(
        torch.from_numpy(big), torch.ones(64), torch.ones(64), num_heads=4, impl="kernel") is None
    # with allow_large the forced kernel route takes K11 (1024 < S <= 8192) at a
    # head dim csrc/fused_qkv_large.cu instantiates (64), and still declines at 16
    assert fused_qkv_attention_or_none(torch.from_numpy(big), torch.ones(64), torch.ones(64),
                                       num_heads=4, impl="kernel", allow_large=True) is None
    out = fused_qkv_attention_or_none(torch.from_numpy(big).requires_grad_(), torch.ones(64),
                                      torch.ones(64), num_heads=1, impl="kernel",
                                      allow_large=True)
    assert out is not None and type(out.grad_fn).__name__ == "FusedQKVLargeAttentionBackward"

    # the kernel route takes an eligible shape (head dim 88: the student's)
    qkv, qw, kw, _ = _inputs(1, 65, 2, 88, seed=2)
    out = fused_qkv_attention_or_none(torch.from_numpy(qkv).requires_grad_(),
                                      torch.from_numpy(qw), torch.from_numpy(kw),
                                      num_heads=2, impl="kernel")
    assert out is not None and type(out.grad_fn).__name__ == "FusedQKVAttentionBackward"


@pytest.mark.parametrize("s, d, itemsize, want", [
    (833, 88, 2, True),    # the student: W 1408
    (257, 128, 2, True),   # the CLIP-6B teacher: W 3200
    (1024, 64, 4, True),
    (1025, 88, 2, False),  # over the small-S threshold
    (0, 88, 2, False),
    (833, 24, 4, False),   # head dim not instantiated in csrc/fused_qkv.cu
    (833, 88, 1, False),
])
def test_fused_qkv_eligible_matches_jax_on_the_path(s, d, itemsize, want):
    heads = {88: 16, 128: 25, 64: 4, 24: 8}[d]
    assert fa.fused_qkv_eligible(s, heads, d, itemsize) == want
    if d in (88, 128) and itemsize == 2:  # the path's: the JAX package picks the same
        assert jfa.fused_qkv_eligible(s, heads, d, itemsize) == want


def test_attention_layer_fused_route_equals_unfused():
    torch.manual_seed(0)
    layer = Attention(176, 2)
    for p in layer.parameters():
        torch.nn.init.normal_(p, std=0.1)
    x = torch.randn(2, 33, 176)
    grads, outs = {}, {}
    for impl in ("kernel", "plain"):
        layer.attn_impl = impl
        layer.zero_grad()
        outs[impl] = layer(x)
        outs[impl].square().sum().backward()
        grads[impl] = {n: p.grad.clone() for n, p in layer.named_parameters()}
    torch.testing.assert_close(outs["kernel"], outs["plain"], atol=1e-5, rtol=1e-5)
    for name in ("qkv.weight", "q_norm.weight", "k_norm.weight", "proj.weight"):
        torch.testing.assert_close(grads["kernel"][name], grads["plain"][name],
                                   atol=1e-5, rtol=1e-5, msg=name)


def test_cpu_fused_qkv_never_builds_or_launches(monkeypatch):
    def no_build():
        raise AssertionError("the CUDA library was requested for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    fa.reset_launch_count()
    qkv, qw, kw, g = (torch.from_numpy(x) for x in _inputs(1, 17, 2, 64, seed=3))
    qkv.requires_grad_()
    fa.fused_qkv_rmsnorm_attention(qkv, qw, kw, num_heads=2).backward(g)
    assert qkv.grad is not None
    assert all(fa.launch_count(n) == 0 for n in fa.KERNELS)


def test_fused_qkv_plain_matches_jax_at_the_teacher_shape():
    """The CLIP-6B teacher's S = 257 (a 1-row last query tile on the card)
    at its head dim 128, two heads: forward and grads against the JAX op in
    interpret mode at the JAX bars."""
    b, s, h, d = 1, 257, 2, 128
    qkv, qw, kw, g = _inputs(b, s, h, d, seed=11)

    def jax_fused(qkv, qw, kw):
        return jfa._fused_qkv_small_s(qkv, qw, kw, h, d, d ** -0.5, 1e-6, True)

    ref = jax_fused(qkv, qw, kw)
    ref_grads = jax.grad(lambda *a: jnp.sum(jax_fused(*a) * g), argnums=(0, 1, 2))(qkv, qw, kw)
    tqkv, tqw, tkw = (torch.from_numpy(x).requires_grad_() for x in (qkv, qw, kw))
    out = fa.fused_qkv_rmsnorm_attention(tqkv, tqw, tkw, num_heads=h)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tqkv, tqw, tkw))
    for name, a, r in zip(("qkv", "qw", "kw"), grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=5e-4, rtol=5e-4, err_msg=name)


def test_fused_qkv_cuda_wrapper_refuses_head_dims_it_does_not_instantiate():
    """The bf16 wgmma kernel exists at head dims 64 / 72 / 88 / 128 only;
    another raises before anything reaches the card, naming the queue
    that would add it."""
    qkv = torch.zeros(1, 8, 3 * 2 * 80, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        fa._fused_qkv_cuda(qkv, torch.ones(160), torch.ones(160), 2, 80 ** -0.5, 1e-6)


def test_cpu_fused_qkv_counts_no_launch_by_sequence_length():
    """The by-length tally of K3 / K11 launches is empty after a reset
    and stays empty on the CPU route."""
    fa.reset_launch_count()
    qkv, qw, kw, _ = (torch.from_numpy(x) for x in _inputs(1, 17, 2, 64, seed=5))
    fa.fused_qkv_rmsnorm_attention(qkv, qw, kw, num_heads=2)
    assert fa.fused_launch_counts("fused_qkv_fwd") == {}
    assert fa.fused_launch_counts("fused_qkv_large_fwd") == {}
