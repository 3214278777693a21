"""Rotary embeddings of the PyTorch port vs the JAX package (nn/rope.py):
1D RoPE at the 8B preset's theta and positions, YaRN, mRoPE, apply_rope.

fp32. Inverse frequencies agree to 1e-6 relative; cos/sin to 2e-6: one of
the 64 inverse frequencies of the 8B preset differs by one fp32 ulp between
torch's pow and XLA's, which at position 2111 moves the angle by 2e-6 rad
(each side's cos is within 1.6e-6 of the float64 value of its own angle).
The rotated values agree to 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internvideo_tpu.nn import rope as jrope
from internvideo_tpu_torch.nn import rope


@pytest.mark.parametrize("dim,theta,yarn", [
    (128, 5_000_000.0, False),   # qwen3_8b_mla
    (64, 5_000_000.0, False),    # qwen3_2b_mla
    (16, 10_000.0, False),
    (64, 10_000.0, True),        # YaRN (DeepSeek-V3 recipe)
])
def test_rope_cos_sin_matches_jax(dim, theta, yarn):
    pos = np.array([[0, 1, 7, 511, 2047, 2100], [3, 64, 1000, 2111, 5, 9]], np.int32)
    jy = jrope.YarnConfig() if yarn else None
    ty = rope.YarnConfig() if yarn else None
    np.testing.assert_allclose(rope.rope_freqs(dim, theta, ty).numpy(),
                               np.asarray(jrope.rope_freqs(dim, theta, jy)), rtol=1e-6)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), dim, theta, jy)
    tc, ts = rope.rope_cos_sin(torch.from_numpy(pos), dim, theta, ty)
    assert tc.shape == (2, 6, dim) and tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6, rtol=0)


@pytest.mark.parametrize("sections", [(24, 20, 20), (3, 3, 2)])
def test_mrope_matches_jax(sections):
    dim = 2 * sum(sections)
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 300, size=(3, 2, 7)).astype(np.int32)
    jc, js = jrope.mrope_cos_sin(jnp.asarray(pos), dim, sections, 5_000_000.0)
    tc, ts = rope.mrope_cos_sin(torch.from_numpy(pos), dim, sections, 5_000_000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    # equal streams reduce to 1D rope
    same = np.broadcast_to(pos[:1], pos.shape).copy()
    c3, _ = rope.mrope_cos_sin(torch.from_numpy(same), dim, sections, 5_000_000.0)
    c1, _ = rope.rope_cos_sin(torch.from_numpy(pos[0]), dim, 5_000_000.0)
    np.testing.assert_allclose(c3.numpy(), c1.numpy(), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="sum"):
        rope.mrope_cos_sin(torch.from_numpy(pos), dim + 2, sections)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(10).reshape(2, 5).astype(np.int32)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 16)
    tc, ts = rope.rope_cos_sin(torch.from_numpy(pos), 16)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = np.asarray(jrope.apply_rope(jx, jc, js), np.float32)
    out = rope.apply_rope(tx, tc, ts)
    assert out.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(out.float().numpy(), ref, atol=tol, rtol=tol)
    # (S, D) tables broadcast over the batch
    ref2 = np.asarray(jrope.apply_rope(jx, jc[0], js[0]), np.float32)
    np.testing.assert_allclose(rope.apply_rope(tx, tc[0], ts[0]).float().numpy(), ref2,
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(rope.rotate_half(torch.from_numpy(x)).numpy(),
                               np.asarray(jrope.rotate_half(jnp.asarray(x))))
