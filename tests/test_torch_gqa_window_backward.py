"""The backward of grouped-query and sliding-window attention in the
PyTorch port vs JAX gradients, fp32, at the JAX kernel tests' shapes
(tests/test_flash_attention.py: test_sliding_window_unaligned_grads,
test_gqa's 8 / 2 heads, test_causal_q_position_offset's offset with a
window, test_grads_segment_ids with grouped heads and -1 pads,
test_window_fully_masked_rows_zero's rows without keys).

JAX differentiates its Pallas flash kernel in interpret mode (`_bwd` with
`group` and `window`); the LSE-cotangent cases use its
`flash_attention_with_lse` where it takes the call (no window) and an
explicitly masked jnp softmax where it does not. The port runs
`FlashAttention`'s plain backward (`flash_attention_bwd_ref` with `group`
and `window`), the route a CPU tensor takes; the CUDA kernels are held
against it on the card by test_torch_gqa_bwd_kernel_cuda.py and
chip_smoke.py. Bars: the JAX kernel tests' 5e-4 on gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internvideo_tpu.ops.flash_attention import flash_attention as jax_flash
from internvideo_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash_lse
from internvideo_tpu_torch.ops import flash_attention as fa


def _inputs(b, sq, sk, h, d, hkv, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, hkv, d)).astype(np.float32) for _ in range(2))
    w = rng.standard_normal((b, sq, h, d)).astype(np.float32)  # output cotangent weights
    c = rng.standard_normal((b, h, sq)).astype(np.float32)  # LSE cotangent weights
    return q, k, v, w, c


def _segments(b, s):
    """Two packed segments and a tail of -1 pads (which meet each other)."""
    seg = np.full((b, s), -1, np.int32)
    seg[:, :100], seg[:, 100:220] = 0, 1
    return seg


def _masked_ref(q, k, v, *, causal=False, window=None, q_position_offset=0):
    """(out, lse) of an explicitly masked softmax in jnp (grouped heads by
    repeat), rows without a key giving out 0 and lse -inf."""
    group = q.shape[2] // k.shape[2]
    k, v = (jnp.repeat(x, group, axis=2) for x in (k, v))
    qi = np.arange(q.shape[1])[:, None] + q_position_offset
    ki = np.arange(k.shape[1])[None, :]
    allowed = np.ones((q.shape[1], k.shape[1]), bool)
    if causal:
        allowed &= qi >= ki
    if window is not None:
        allowed &= (qi - ki < window) if causal else (np.abs(qi - ki) < window)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    s = jnp.where(allowed, s, -jnp.inf)
    lse = jax.nn.logsumexp(s, axis=-1)
    p = jnp.where(allowed, jnp.exp(s - jnp.where(jnp.isfinite(lse), lse, 0.0)[..., None]), 0.0)
    return jnp.einsum("bhqk,bkhd->bqhd", p, v), lse


# name -> ((B, Sq, Sk, Hq, Hkv, D), keyword arguments, segments)
CASES = {
    "window_unaligned": ((1, 200, 200, 2, 2, 64), dict(window=64), False),
    "gqa_causal": ((1, 128, 128, 8, 2, 64), dict(causal=True), False),
    "gqa": ((1, 128, 128, 8, 2, 64), {}, False),
    "window_causal_offset_ragged": ((1, 128, 200, 4, 2, 64),
                                    dict(causal=True, window=50, q_position_offset=72), False),
    "gqa_segments_pads": ((1, 256, 256, 4, 2, 64), dict(causal=True), True),
    "window_rows_without_keys": ((1, 256, 64, 2, 2, 64), dict(window=50), False),
    # tile edges of the CUDA backward (128-row dq tiles, 64-key stages; 128-
    # key dk/dv tiles over 64-row q steps): ragged Sq < Sk with a query
    # offset, groups of 8 and 4, band edges inside a tile, causal and not
    "ragged_short_q_offset": ((1, 70, 150, 4, 2, 64), dict(causal=True, q_position_offset=80),
                              False),
    "group8_window_mid_tile": ((1, 150, 150, 8, 1, 32), dict(causal=True, window=40), False),
    "group4_window_dense_offset": ((1, 130, 190, 4, 1, 32),
                                   dict(window=70, q_position_offset=30), False),
}


def _jax_grads(q, k, v, w, c, kw, seg, with_lse):
    segs = {} if seg is None else dict(q_segment_ids=seg, kv_segment_ids=seg)

    def loss(q, k, v):
        if not with_lse:
            out = jax_flash(q, k, v, interpret=True, block_q=128, block_k=128, **segs, **kw)
            return jnp.sum(out * w)
        if "window" in kw:
            out, lse = _masked_ref(q, k, v, **kw)
        else:
            out, lse = jax_flash_lse(q, k, v, interpret=True, block_q=128, block_k=128,
                                     **segs, **kw)
        return jnp.sum(out * w) + jnp.sum(jnp.where(jnp.isfinite(lse), lse, 0.0) * c)

    return [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)]


def _port_grads(q, k, v, w, c, kw, seg, with_lse):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    segs = {} if seg is None else dict(q_segment_ids=torch.from_numpy(seg),
                                       kv_segment_ids=torch.from_numpy(seg))
    out, lse = fa.flash_attention_with_lse(tq, tk, tv, **segs, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    loss = (out * torch.from_numpy(w)).sum()
    if with_lse:
        loss = loss + (torch.where(torch.isfinite(lse), lse, 0.0) * torch.from_numpy(c)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, (tq, tk, tv))]


@pytest.mark.parametrize("with_lse", [False, True], ids=["out", "out_and_lse"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_jax(name, with_lse):
    (b, sq, sk, h, hkv, d), kw, segmented = CASES[name]
    q, k, v, w, c = _inputs(b, sq, sk, h, d, hkv, seed=len(name))
    seg = _segments(b, sq) if segmented else None
    want = _jax_grads(q, k, v, w, c, kw, seg, with_lse)
    got = _port_grads(q, k, v, w, c, kw, seg, with_lse)
    for g, ref, what in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == ref.shape, what
        np.testing.assert_allclose(g, ref, atol=5e-4, rtol=5e-4, err_msg=f"{name} {what}")


def test_rows_without_keys_get_zero_dq():
    """test_window_fully_masked_rows_zero's rows qi >= 113 see no key of 64
    within a window of 50: their LSE is -inf, their dq exactly 0, and keys
    they would have seen get nothing from them."""
    q, k, v, w, _ = _inputs(1, 256, 64, 2, 64, 2, seed=11)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = fa.flash_attention_with_lse(tq, tk, tv, window=50)
    assert torch.isinf(lse[:, :, 113:]).all()
    dq, dk, dv = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    assert (dq[:, 113:] == 0).all() and dq[:, :113].abs().sum() > 0
    # cotangents on the dead rows change nothing
    w2 = w.copy()
    w2[:, 113:] = 100.0
    out, _ = fa.flash_attention_with_lse(tq, tk, tv, window=50)
    grads2 = torch.autograd.grad((out * torch.from_numpy(w2)).sum(), (tq, tk, tv))
    for a, b in zip((dq, dk, dv), grads2):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_group_sums_over_q_heads():
    """dk / dv of a K/V head equal the sum, over its group's q heads, of the
    gradients the same call gives with K/V repeated per q head."""
    q, k, v, w, _ = _inputs(1, 96, 96, 4, 32, 2, seed=5)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    kr, vr = (x.detach().repeat_interleave(2, dim=2).requires_grad_() for x in (tk, tv))
    tw = torch.from_numpy(w)
    kw = dict(causal=True, window=24)
    g_gqa = torch.autograd.grad((fa.flash_attention(tq, tk, tv, **kw) * tw).sum(), (tq, tk, tv))
    g_rep = torch.autograd.grad((fa.flash_attention(tq, kr, vr, **kw) * tw).sum(), (tq, kr, vr))
    torch.testing.assert_close(g_gqa[0], g_rep[0], atol=1e-6, rtol=1e-6)
    for a, b in zip(g_gqa[1:], g_rep[1:]):
        torch.testing.assert_close(a, b.unflatten(2, (2, 2)).sum(3), atol=1e-5, rtol=1e-5)
