"""Small-S attention (K2 forward, K4b backward) of the PyTorch port vs the
JAX package.

On the CPU the port's `SmallSAttention` runs its plain forward and plain
backward; they are held against the JAX small-S Pallas kernels in
interpret mode (`_small_s_attention(..., interpret=True)` with `jax.grad`),
as tests/test_flash_attention.py runs them, at the JAX bars (2e-5 forward,
5e-4 grads). The routing test holds the port's `flash_attention` to the
JAX package's choice of the small-S path on the eligible and ineligible
shapes of tests/test_flash_attention.py:363-395. The CUDA kernels are held
against the plain versions on the card by
test_torch_small_s_kernel_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import internvideo_tpu.ops.flash_attention as jfa
from internvideo_tpu_torch.ops import _build
from internvideo_tpu_torch.ops import flash_attention as fa

# (B, Sq, Sk, H, D): the masked-pretrain shape family scaled down as the JAX
# test has it, a second head count, and a ragged Sq != Sk; then the vision
# towers' S = 196 at the head dims whose Hopper kernels store 96 columns (72,
# 88), and Sq != Sk on either side of the forward's 128-row query tile; then
# the backward's edges: one query row at d 128, a 128-key dk/dv tile and one
# key past it at d 72 (129 keys against 257 rows), and at d 128 (64 keys a
# dk/dv tile there) one key short of it against 65 rows.
SHAPES = [
    (2, 205, 205, 4, 24),
    (1, 413, 413, 8, 24),
    (1, 205, 300, 2, 24),
    (1, 196, 196, 2, 72),
    (1, 196, 196, 2, 88),
    (1, 129, 127, 2, 72),
    (1, 127, 193, 2, 88),
    (1, 1, 65, 2, 128),
    (1, 257, 129, 2, 72),
    (1, 65, 63, 2, 128),
]


def _inputs(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(b, sq, h * d), f(b, sk, h * d), f(b, sk, h * d), f(b, sq, h * d)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_small_s_plain_matches_jax_kernel_forward_and_grads(shape):
    b, sq, sk, h, d = shape
    q, k, v, g = _inputs(*shape, seed=sq + sk)
    scale = d ** -0.5

    def jax_loss(q, k, v):
        return jnp.sum(jfa._small_s_attention(q, k, v, h, d, scale, True) * g)

    ref = jfa._small_s_attention(q, k, v, h, d, scale, True)
    ref_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(q, k, v)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.small_s_attention(tq, tk, tv, h, scale)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (tq, tk, tv))
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=5e-4, rtol=5e-4, err_msg=name)


def test_small_s_lse_is_the_natural_log_normaliser():
    q, k, v, _ = _inputs(1, 65, 70, 2, 24, seed=9)
    heads = lambda x: torch.from_numpy(x).unflatten(-1, (2, 24))  # noqa: E731
    out, lse = fa.small_s_attention_ref(heads(q), heads(k), heads(v), 24 ** -0.5)
    ref, ref_lse = fa.flash_attention_ref_with_lse(heads(q), heads(k), heads(v), 24 ** -0.5)
    torch.testing.assert_close(out, ref, atol=2e-6, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=2e-6, rtol=0)


def _jax_takes_small_s(monkeypatch, q, k, v, **kw) -> bool:
    calls = []
    orig = jfa._small_s_attention

    def spy(*a, **k_):
        calls.append(1)
        return orig(*a, **k_)

    monkeypatch.setattr(jfa, "_small_s_attention", spy)
    jfa.flash_attention(q, k, v, interpret=True, block_q=128, block_k=128, **kw)
    monkeypatch.setattr(jfa, "_small_s_attention", orig)
    return bool(calls)


def _rand(b, sq, sk, h, d, hkv=None, seed=0):
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32))


def test_port_routes_to_small_s_exactly_where_jax_does(monkeypatch):
    """The eligible and ineligible cases of the JAX routing test: the
    port's predicate agrees with the JAX dispatcher on each, the eligible
    shape runs SmallSAttention and the over-threshold, causal and segmented
    ones FlashAttention (causal, segmented: K5 / K8); GQA takes no small-S
    route either: its forward and backward are K5's."""
    seg = np.zeros((2, 205), np.int32)
    big = fa.SMALL_S_MAX + 1
    cases = [
        ("eligible", _rand(2, 205, 205, 4, 24, seed=40), {}),
        ("causal", _rand(2, 205, 205, 4, 24, seed=40), {"causal": True}),
        ("segments", _rand(2, 205, 205, 4, 24, seed=40),
         {"q_segment_ids": seg, "kv_segment_ids": seg}),
        ("gqa", _rand(1, 64, 64, 4, 16, hkv=2, seed=42), {}),
        ("over-threshold", _rand(1, big, big, 1, 16, seed=43), {}),
    ]
    for name, (q, k, v), kw in cases:
        jax_route = _jax_takes_small_s(monkeypatch, q, k, v, **kw)
        tkw = {n: torch.from_numpy(x) for n, x in kw.items() if n.endswith("segment_ids")}
        tkw.update({n: x for n, x in kw.items() if not n.endswith("segment_ids")})
        tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
        assert fa.takes_small_s(tq, tk, tv, **tkw) == jax_route, name
        assert jax_route == (name == "eligible"), name
        if name in ("eligible", "over-threshold", "causal", "segments"):
            out = fa.flash_attention(tq.requires_grad_(), tk, tv, **tkw)
            want = "SmallSAttentionBackward" if jax_route else "FlashAttentionBackward"
            assert type(out.grad_fn).__name__ == want, name
        else:
            out = fa.flash_attention(tq.requires_grad_(), tk, tv, **tkw)
            assert type(out.grad_fn).__name__ == "FlashAttentionBackward", name
            out.sum().backward()
            assert torch.isfinite(tq.grad).all(), name


def test_flash_attention_with_lse_stays_on_k1():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _rand(1, 65, 65, 2, 24, seed=5))
    out, _ = fa.flash_attention_with_lse(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"


def test_cpu_small_s_never_builds_or_launches(monkeypatch):
    def no_build():
        raise AssertionError("the CUDA library was requested for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    fa.reset_launch_count()
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 33, 33, 2, 88, seed=4))
    q.requires_grad_()
    fa.small_s_attention(q, k, v, 2, 88 ** -0.5).backward(g)
    assert q.grad is not None
    assert all(fa.launch_count(n) == 0 for n in fa.KERNELS)
