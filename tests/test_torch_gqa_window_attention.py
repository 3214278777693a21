"""Grouped-query and sliding-window attention of the PyTorch port vs the
JAX package, at the JAX kernel tests' shapes (tests/test_flash_attention.py
test_gqa, test_sliding_window, test_window_fully_masked_rows_zero) and a
windowed query-offset case with a ragged S.

JAX runs its Pallas flash kernel in interpret mode (where its `impl="xla"`
route sends a window) or `xla_attention` (GQA without a window). The port
runs both of its routes on the CPU: the K5 kernel family's plain version
(`flash_attention`) and the plain dispatcher route (`attention_xla`, the
window as an explicit band mask). fp32, the JAX kernel tests' 2e-5. The
CUDA kernel is held against the plain version on the card by
test_torch_gqa_kernel_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from internvideo_tpu.ops.attention_xla import xla_attention
from internvideo_tpu.ops.flash_attention import flash_attention as jax_flash
from internvideo_tpu_torch.ops import flash_attention as fa
from internvideo_tpu_torch.ops.attention import dot_product_attention


def _qkv(b, sq, sk, h, d, seed, hkv=None):
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32))


def _jax_window(q, k, v, **kw):
    return np.asarray(jax_flash(q, k, v, interpret=True, block_q=128, block_k=128, **kw))


# name -> ((B, Sq, Sk, Hq, D, Hkv), keyword arguments)
CASES = {
    "gqa": ((1, 128, 128, 8, 64, 2), {}),
    "window": ((1, 256, 256, 2, 64, 2), dict(window=50)),
    "window_causal": ((1, 256, 256, 2, 64, 2), dict(causal=True, window=50)),
    "window_fully_masked_rows": ((1, 256, 64, 2, 64, 2), dict(window=50)),
    "window_causal_offset_ragged_gqa": ((1, 128, 200, 4, 64, 2),
                                        dict(causal=True, window=50, q_position_offset=72)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_port_routes_match_jax(name):
    (b, sq, sk, h, d, hkv), kw = CASES[name]
    q, k, v = _qkv(b, sq, sk, h, d, seed=len(name), hkv=hkv)
    if "window" in kw:
        ref = _jax_window(q, k, v, **kw)
    else:
        ref = np.asarray(xla_attention(q, k, v, **kw))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    flash = fa.flash_attention(tq, tk, tv, **kw)
    plain = dot_product_attention(tq, tk, tv, impl="plain", **kw)
    np.testing.assert_allclose(flash.numpy(), ref, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(plain.numpy(), ref, atol=2e-5, rtol=2e-5)
    # the bhsd layout is a view of the same call
    bhsd = fa.flash_attention(*(x.transpose(1, 2) for x in (tq, tk, tv)), layout="bhsd", **kw)
    np.testing.assert_allclose(bhsd.transpose(1, 2).numpy(), ref, atol=2e-5, rtol=2e-5)


def test_rows_with_no_key_in_the_band_give_zero_and_minus_inf():
    """test_window_fully_masked_rows_zero: rows qi >= 113 see no key of 64
    within a window of 50 (|qi - ki| < 50): out 0 and LSE -inf on both
    routes; the rows that do see keys match the explicit-mask reference."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 256, 64, 2, 64, seed=11))
    out, lse = fa.flash_attention_with_lse(q, k, v, window=50)
    assert (out[:, 113:] == 0).all()
    assert torch.isinf(lse[:, :, 113:]).all() and (lse[:, :, 113:] < 0).all()
    assert torch.isfinite(lse[:, :, :113]).all()
    plain = dot_product_attention(q, k, v, impl="plain", window=50)
    assert (plain[:, 113:] == 0).all()
    torch.testing.assert_close(plain[:, :113], out[:, :113], atol=2e-5, rtol=2e-5)


def test_backward_with_gqa_or_window_raises():
    """The K5 family's backward with GQA or a window, which raised until it
    was ported (RL), now differentiates: on the CPU the kernel route's
    plain backward gives the gradients that autograd through the plain
    dispatcher route's explicit band mask gives (fp32, the JAX grad bar
    5e-4; test_torch_gqa_window_backward.py holds it against JAX)."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(1, 32, 32, 4, 64, seed=3))
    kg, vg = (torch.from_numpy(x).requires_grad_() for x in _qkv(1, 32, 32, 2, 64, seed=4)[1:])
    for args, kw in (((q, kg, vg), dict(causal=True)), ((q, k, v), dict(causal=True, window=8)),
                     ((q, k, v), dict(window=8)), ((q, kg, vg), dict(causal=True, window=8))):
        got = torch.autograd.grad(fa.flash_attention(*args, **kw).square().sum(), args)
        want = torch.autograd.grad(
            dot_product_attention(*args, impl="plain", **kw).square().sum(), args)
        for a, b in zip(got, want):
            assert torch.isfinite(a).all() and a.abs().sum() > 0
            torch.testing.assert_close(a, b, atol=5e-4, rtol=5e-4)


def test_gqa_and_window_take_k5_and_no_small_s_route():
    """As in JAX (:2080-2088), the small-S route declines GQA and windows;
    on the card such calls launch K5 (counters `flash_fwd_causal_gqa` /
    `_window`); on the CPU nothing is launched."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 64, 64, 4, 64, seed=5, hkv=2))
    assert not fa.takes_small_s(q, k, v)
    q1, k1, v1 = (torch.from_numpy(x) for x in _qkv(1, 64, 64, 2, 64, seed=6))
    assert fa.takes_small_s(q1, k1, v1) and not fa.takes_small_s(q1, k1, v1, window=8)
    assert {"flash_fwd_causal_gqa", "flash_fwd_causal_window"} <= set(fa.KERNELS)
    fa.reset_launch_count()
    fa.flash_attention(q, k, v, window=8)
    assert all(fa.launch_count(n) == 0 for n in fa.KERNELS)
    with pytest.raises(ValueError, match="divisible"):
        fa.flash_attention(q, k[:, :, :1].expand(-1, -1, 3, -1), v[:, :, :1].expand(-1, -1, 3, -1))
