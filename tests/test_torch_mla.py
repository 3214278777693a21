"""Causal / narrow-v flash attention (K5's plain route) and MLA of the
PyTorch port vs the JAX package.

On the CPU the port's causal flash attention runs its plain version; it is
held against the JAX Pallas kernel in interpret mode, as
tests/test_flash_attention.py runs it (:26, :152, :569), at that file's
2e-5. `MLAttention` (forward, both prefill chunks, dense decode, paged
decode on both routes) is held against the JAX module on the same params
(models/convert.py:params_from_jax) at 2e-5. The CUDA kernel K5 is held
against the plain version on the card by
test_torch_causal_flash_kernel_cuda.py and chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from internvideo_tpu.nn.mla import MLAConfig as JMLAConfig
from internvideo_tpu.nn.mla import MLAttention as JMLAttention
from internvideo_tpu.nn.rope import rope_cos_sin as j_rope_cos_sin
from internvideo_tpu.ops.flash_attention import flash_attention as jax_flash
from internvideo_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash_lse
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.nn.mla import MLAConfig, MLAttention
from internvideo_tpu_torch.ops import attention, flash_attention as fa

MLA_TINY = dict(hidden_size=64, num_heads=4, kv_lora_rank=32, qk_rope_head_dim=16,
                qk_nope_head_dim=16, v_head_dim=16)


def _rand(*shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# (name, B, Sq, Sk, H, d_qk, d_v, causal, q_position_offset)
CASES = [
    ("causal", 2, 256, 256, 2, 64, 64, True, 0),               # :26
    ("causal_ragged", 1, 200, 200, 2, 64, 64, True, 0),        # S not a tile multiple
    ("offset", 1, 72, 200, 2, 64, 64, True, 128),              # :152
    ("cross_length", 1, 100, 200, 2, 64, 64, True, 0),         # :162
    ("narrow_v_causal", 2, 200, 200, 4, 64, 32, True, 0),      # :569 without GQA
    ("narrow_v", 2, 200, 200, 4, 64, 32, False, 0),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_causal_plain_matches_jax_kernel(case):
    _, b, sq, sk, h, d, dv, causal, off = case
    q, k, v = _rand(b, sq, h, d, seed=1), _rand(b, sk, h, d, seed=2), _rand(b, sk, h, dv, seed=3)
    kw = dict(causal=causal, q_position_offset=off)
    ref = jax_flash(q, k, v, interpret=True, block_q=128, block_k=128, **kw)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, **kw)
    assert out.shape == (b, sq, h, dv)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    ref_out, ref_lse = jax_flash_lse(q, k, v, interpret=True, block_q=128, block_k=128, **kw)
    out2, lse = fa.flash_attention_with_lse(tq, tk, tv, **kw)
    np.testing.assert_allclose(out2.numpy(), np.asarray(ref_out), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=2e-5, rtol=2e-5)
    # the kernel-native layout is a permuted view: same numbers
    out3 = fa.flash_attention(*(x.transpose(1, 2) for x in (tq, tk, tv)), layout="bhsd", **kw)
    np.testing.assert_allclose(out3.transpose(1, 2).numpy(), out.numpy(), atol=0, rtol=0)


def test_row_that_sees_no_key_gets_zero_and_minus_inf():
    q, k, v = (torch.from_numpy(_rand(1, 6, 2, 64, seed=s)) for s in (4, 5, 6))
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=True, q_position_offset=-2)
    assert torch.isinf(lse[:, :, :2]).all() and (lse[:, :, :2] < 0).all()
    assert (out[:, :2] == 0).all() and torch.isfinite(lse[:, :, 2:]).all()


def test_cuda_only_refusals_raise():
    """The kernel route's backward on the CPU: the causal / narrow-v
    backward (K5, the SFT slice) and, since RL, the windowed and GQA
    backward, which raised before, run through their plain versions and
    match autograd through the plain attention; an unknown layout name is
    refused."""
    q, k, v = (torch.from_numpy(_rand(1, 16, 2, 64, seed=s)).requires_grad_() for s in (7, 8, 9))
    kg, vg = (torch.from_numpy(_rand(1, 16, 1, 64, seed=s)).requires_grad_() for s in (10, 11))
    for kk, vv, kw in ((k, v, dict(causal=True)), (k, v[..., :32], {}),
                       (k, v, dict(causal=True, window=8)), (kg, vg, dict(causal=True))):
        leaves = (q, kk, vv if vv.is_leaf else v)
        got = torch.autograd.grad(fa.flash_attention(q, kk, vv, **kw).square().sum(), leaves)
        want = torch.autograd.grad(attention.attention_xla(q, kk, vv, **kw).square().sum(),
                                   leaves)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=5e-4, rtol=5e-4)
    assert attention.native_attention_layout() == "bshd"
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention.native_attention_layout("triton")


def _mla_pair(seed=0, **over):
    jcfg = JMLAConfig(**{**MLA_TINY, **over})
    tcfg = MLAConfig(**{**MLA_TINY, **over})
    b, s = 2, 12
    x = _rand(b, s, 64, seed=seed + 100)
    cos, sin = j_rope_cos_sin(jnp.arange(s)[None], 16)
    cos, sin = (jnp.broadcast_to(t, (b, s, 16)) for t in (cos, sin))
    jm = JMLAttention(jcfg, attn_impl="xla")
    params = fnn.unbox(jm.init(jax.random.key(seed), jnp.asarray(x), cos, sin))
    tm = MLAttention(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
    tcos, tsin = torch.from_numpy(np.array(cos)), torch.from_numpy(np.array(sin))
    return jm, params, tm, x, (cos, sin), (tcos, tsin)


@pytest.mark.parametrize("variant", [{}, {"q_lora_rank": 24}, {"kv_norm": True},
                                     {"q_bias": False, "o_bias": True}],
                         ids=["full_q", "q_lora", "kv_norm", "biases"])
def test_mla_forward_matches_jax(variant):
    jm, params, tm, x, (cos, sin), (tcos, tsin) = _mla_pair(**variant)
    ref = jm.apply(params, jnp.asarray(x), cos, sin)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), tcos, tsin)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_mla_prefill_both_chunks_and_decode_match_jax():
    jm, params, tm, x, (cos, sin), (tcos, tsin) = _mla_pair(seed=1)
    b, split, c_dim = 2, 5, JMLAConfig(**MLA_TINY).cache_dim
    jcache = jnp.zeros((b, 16, c_dim), jnp.float32)
    tcache = torch.zeros(b, 16, c_dim)
    tx = torch.from_numpy(x)
    with torch.no_grad():
        for lo, hi in ((0, split), (split, 11)):
            jout, jcache = jm.apply(params, jnp.asarray(x[:, lo:hi]), cos[:, lo:hi],
                                    sin[:, lo:hi], jcache, lo, method="prefill")
            tout, tcache = tm.prefill(tx[:, lo:hi], tcos[:, lo:hi], tsin[:, lo:hi], tcache, lo)
            np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5, rtol=2e-5)
            np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache), atol=2e-5, rtol=2e-5)
        # absorbed decode of token 11 over the dense cache
        jout, jcache = jm.apply(params, jnp.asarray(x[:, 11:12]), cos[:, 11:12], sin[:, 11:12],
                                jcache, jnp.int32(11), method="decode")
        tout, tcache = tm.decode(tx[:, 11:12], tcos[:, 11:12], tsin[:, 11:12], tcache, 11)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache), atol=2e-5, rtol=2e-5)


def test_mla_decode_paged_matches_jax_on_both_routes():
    """Ragged lengths over shuffled pages, unused table columns on a page
    of garbage: the port's kernel route (K6's plain version on the CPU) and
    plain route vs the JAX XLA branch and the Pallas kernel (interpret)."""
    jm, params, tm, x, (cos, sin), (tcos, tsin) = _mla_pair(seed=2)
    b, page, max_pages = 2, 4, 4
    c_dim = JMLAConfig(**MLA_TINY).cache_dim
    rng = np.random.default_rng(3)
    pages = rng.standard_normal((2 * max_pages + 1, page, c_dim)).astype(np.float32)
    tables = np.full((b, max_pages), 2 * max_pages, np.int32)  # the garbage page
    seq_lens = np.array([7, 13], np.int32)
    for s in range(b):
        n = -(-int(seq_lens[s]) // page)
        tables[s, :n] = s * max_pages + rng.permutation(max_pages)[:n]
    xt = x[:, 3:4]
    args = (cos[:, 3:4], sin[:, 3:4], jnp.asarray(pages), jnp.asarray(tables),
            jnp.asarray(seq_lens))
    ref = jm.apply(params, jnp.asarray(xt), *args, method="decode_paged", impl="xla")
    ref_kernel = jm.apply(params, jnp.asarray(xt), *args, method="decode_paged",
                          impl="pallas", interpret=True)
    np.testing.assert_allclose(np.asarray(ref_kernel), np.asarray(ref), atol=2e-5, rtol=2e-5)
    targs = (tcos[:, 3:4], tsin[:, 3:4], torch.from_numpy(pages), torch.from_numpy(tables),
             torch.from_numpy(seq_lens))
    with torch.no_grad():
        for impl in ("kernel", "plain", "pallas", "xla"):
            out = tm.decode_paged(torch.from_numpy(xt), *targs, impl=impl)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
        # compute_cache_entry: the latent + rotated rope key
        entry = tm.compute_cache_entry(torch.from_numpy(xt), tcos[:, 3:4], tsin[:, 3:4])
    jentry = jm.apply(params, jnp.asarray(xt), cos[:, 3:4], sin[:, 3:4],
                      method="compute_cache_entry")
    np.testing.assert_allclose(entry.numpy(), np.asarray(jentry), atol=2e-5, rtol=2e-5)


def test_mla_quant_raises():
    """int8_wo / int8_mix are ported: q, kv_a and o become Int8WoDense
    (int8_mix with INT8_MIX_DYN_M as its threshold) and kv_b stays a raw
    parameter, as in JAX; an unknown quant mode raises."""
    from internvideo_tpu_torch.ops.quant import INT8_MIX_DYN_M, Int8WoDense

    cfg = MLAConfig(**MLA_TINY)
    for quant, thr in (("int8_wo", None), ("int8_mix", INT8_MIX_DYN_M)):
        attn = MLAttention(cfg, quant=quant, device="cpu")
        for name in ("q_proj", "kv_a_proj_with_mqa", "o_proj"):
            layer = getattr(attn, name)
            assert isinstance(layer, Int8WoDense) and layer.dyn_m_threshold == thr, name
            assert layer.weight_q.dtype == torch.int8 and layer.scale.dtype == torch.float32
        assert attn.kv_b_proj_kernel.dtype == torch.float32
    with pytest.raises(ValueError, match="quant"):
        MLAttention(cfg, quant="int4", device="cpu")
