"""Fused qkv slice + whole-dim QK-RMSNorm + blocked-K attention (K11) of the
PyTorch port vs the JAX package, on the CPU.

The port's `FusedQKVLargeAttention` runs its plain version forward and
differentiates the unfused composition (slice -> rms_norm -> flash
attention) backward. Forward it is held against the JAX op
(`fused_qkv_rmsnorm_attention(..., interpret=True)`, which takes the Pallas
K11 kernel at 1024 < S <= 8192) at tests/test_flash_attention.py:450's
shapes and bar (2e-5); the gradients against `jax.grad` of JAX's unfused
composition with `xla_attention` (:496-500; 5e-4), not of the interpret
kernel. Routing (`fused_qkv_large_eligible`, the dispatcher's
`allow_large`) is checked against JAX where both define it. The CUDA kernel
is held against the plain version on the card by
test_torch_fused_norm_kernels_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import internvideo_tpu.ops.flash_attention as jfa
from internvideo_tpu.ops.attention_xla import xla_attention
from internvideo_tpu.ops.rmsnorm import rms_norm as jax_rms_norm
from internvideo_tpu_torch.ops import flash_attention as fa
from internvideo_tpu_torch.ops.attention import fused_qkv_attention_or_none

B, H, D = 1, 2, 64
W = H * D


@pytest.fixture(scope="module")
def jax_fns():
    def fused(qkv, qw, kw):
        return jfa.fused_qkv_rmsnorm_attention(qkv, qw, kw, num_heads=H, interpret=True)

    def loss_ref(qkv, qw, kw, g):
        b, s, _ = qkv.shape
        q = jax_rms_norm(qkv[..., :W], qw).reshape(b, s, H, D)
        k = jax_rms_norm(qkv[..., W:2 * W], kw).reshape(b, s, H, D)
        v = qkv[..., 2 * W:].reshape(b, s, H, D)
        return jnp.sum(xla_attention(q, k, v).reshape(b, s, W) * g)

    return {"fwd": jax.jit(fused), "grad": jax.jit(jax.grad(loss_ref, argnums=(0, 1, 2)))}


def _inputs(s, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, s, 3 * W)).astype(np.float32),
            (1.0 + 0.1 * rng.standard_normal(W)).astype(np.float32),
            (1.0 - 0.1 * rng.standard_normal(W)).astype(np.float32),
            rng.standard_normal((B, s, W)).astype(np.float32))


@pytest.mark.parametrize("s", [1100, 1040])  # non-divisible and near-divisible block tails
def test_fused_qkv_large_plain_matches_jax_forward(jax_fns, s):
    qkv, qw, kw, _ = _inputs(s, seed=s)
    assert jfa.fused_qkv_large_eligible(s, H, D, 4) and fa.fused_qkv_large_eligible(s, H, D, 4)
    ref = jax_fns["fwd"](qkv, qw, kw)
    with torch.no_grad():
        out = fa.fused_qkv_rmsnorm_attention(*(torch.from_numpy(x) for x in (qkv, qw, kw)),
                                             num_heads=H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_fused_qkv_large_grads_match_jax_unfused(jax_fns):
    qkv, qw, kw, g = _inputs(1100, seed=3)
    ref_grads = jax_fns["grad"](qkv, qw, kw, g)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (qkv, qw, kw)]
    out = fa.fused_qkv_rmsnorm_attention(*leaves, num_heads=H)
    assert type(out.grad_fn).__name__ == "FusedQKVLargeAttentionBackward"
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    for name, a, r in zip(("qkv", "qw", "kw"), grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=5e-4, rtol=5e-4, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_qkv_large_prepass_plain_matches_jax(dtype):
    """The plain version of K11's pre-pass (q / k 1/rms and the normed k
    rows the CUDA pre-pass writes) against JAX's `rms_norm`: the normed k
    slice within 2e-5 in fp32 and at most one bf16 ulp in bf16 (the mean's
    summation order may move a row's 1/rms by an fp32 ulp); x * 1/rms
    against JAX's `rms_norm` with unit weights within 2e-5 for q and k."""
    qkv, _, kw, _ = _inputs(1100, seed=7)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jqkv, tqkv = jnp.asarray(qkv).astype(jdt), torch.from_numpy(qkv).to(tdt)
    q_rstd, k_rstd, k_normed = fa.fused_qkv_large_prepass_ref(tqkv, torch.from_numpy(kw))
    assert q_rstd.shape == k_rstd.shape == (B, 1100) and q_rstd.dtype == torch.float32
    assert k_normed.shape == (B, 1100, W) and k_normed.dtype == tdt
    ref = np.asarray(jax_rms_norm(jqkv[..., W:2 * W], jnp.asarray(kw)).astype(jnp.float32))
    got = k_normed.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
    else:
        ulps = np.abs(got.view(np.int32) - ref.view(np.int32)) >> 16
        assert ulps.max() <= 1, ulps.max()
    ones = jnp.ones(W, jnp.float32)
    for rstd, lo in ((q_rstd, 0), (k_rstd, W)):
        unit = np.asarray(jax_rms_norm(jqkv[..., lo:lo + W].astype(jnp.float32), ones))
        np.testing.assert_allclose((tqkv[..., lo:lo + W].float() * rstd[..., None]).numpy(), unit,
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s", [1025, 4097, 8192, 8193, 1024])
@pytest.mark.parametrize("d", [64, 88, 24])
def test_fused_qkv_large_eligible_matches_jax(s, d):
    """Both packages agree wherever the port instantiates the head dim (64:
    the JAX test, 88: the 1B encoder); JAX's other conditions are TPU lane
    and VMEM bookkeeping, so at head dim 24 the port declines alone."""
    heads = 16
    want = 1024 < s <= 8192 and d in (64, 88)
    for itemsize in (2, 4):
        assert fa.fused_qkv_large_eligible(s, heads, d, itemsize) == want
        if d in (64, 88):
            assert jfa.fused_qkv_large_eligible(s, heads, d, itemsize) == want
    assert not fa.fused_qkv_large_eligible(4097, 129, 64, 2)  # JAX's head limit
    assert not jfa.fused_qkv_large_eligible(4097, 129, 64, 2)


def test_dispatcher_takes_k11_only_on_the_kernel_route_with_allow_large():
    qkv, qw, kw, _ = _inputs(1040, seed=5)
    tqkv, tqw, tkw = (torch.from_numpy(x) for x in (qkv, qw, kw))
    # "auto" on a CPU tensor is the plain route: declines, as JAX declines off the TPU
    assert fused_qkv_attention_or_none(tqkv, tqw, tkw, num_heads=H, allow_large=True) is None
    assert jfa.fused_qkv_eligible(1040, H, D, 4) is False
    # the kernel route without the opt-in keeps the unfused path (K1), as the Block does
    assert fused_qkv_attention_or_none(tqkv, tqw, tkw, num_heads=H, impl="kernel") is None
    out = fused_qkv_attention_or_none(tqkv.clone().requires_grad_(), tqw, tkw, num_heads=H,
                                      impl="kernel", allow_large=True)
    assert out is not None and type(out.grad_fn).__name__ == "FusedQKVLargeAttentionBackward"
    with torch.no_grad():
        ref = fa.fused_qkv_large_ref(tqkv, tqw, tkw, H, D ** -0.5)
    torch.testing.assert_close(out.detach(), ref, atol=0, rtol=0)
    # past _FUSED_LARGE_MAX nothing fuses
    big = torch.zeros(1, fa.FUSED_LARGE_MAX + 1, 3 * W)
    assert fused_qkv_attention_or_none(big, tqw, tkw, num_heads=H, impl="kernel",
                                       allow_large=True) is None
