"""Masking of the PyTorch port vs the JAX package.

The deterministic part of each generator (noise -> sorted keep indices) is
fed the same numpy noise as the JAX function (whose jax.random draw is
replaced by that noise) and must give equal indices. The port's own draws
come from a torch.Generator and are checked for what every draw must hold:
counts, sortedness, range, uniqueness, the tube's shared spatial pattern and
attention-guided masking's bias (tests/test_pretrain.py:48).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import internvideo_tpu.data.masking as jmask
from internvideo_tpu_torch.data import masking


def _with_noise(monkeypatch, name, noise):
    """Replace jax.random.<name> by a function returning `noise`."""
    monkeypatch.setattr(jax.random, name, lambda rng, shape, *a, **k: jnp.asarray(noise))


@pytest.mark.parametrize("batch, n, ratio", [(4, 100, 0.75), (3, 832, 0.8), (2, 16, 0.5)])
def test_random_keep_equals_jax_on_the_same_noise(monkeypatch, batch, n, ratio):
    noise = np.random.default_rng(n).random((batch, n)).astype(np.float32)
    _with_noise(monkeypatch, "uniform", noise)
    ref = np.asarray(jmask.random_keep_indices(jax.random.key(0), batch, n, ratio))
    got = masking.random_keep_from_noise(torch.from_numpy(noise), ratio)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("t, spatial, ratio", [(4, 16, 0.75), (16, 256, 0.8)])
def test_tube_keep_equals_jax_on_the_same_noise(monkeypatch, t, spatial, ratio):
    noise = np.random.default_rng(t).random((2, spatial)).astype(np.float32)
    _with_noise(monkeypatch, "uniform", noise)
    ref = np.asarray(jmask.tube_keep_indices(jax.random.key(0), 2, t, spatial, ratio))
    got = masking.tube_keep_from_noise(torch.from_numpy(noise), t, ratio)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("rows, batch, n, ratio", [
    (6, 2, 16, 0.5),      # per-frame attention folded into token space
    (32, 2, 256, 0.8),    # the 1B recipe's fold, 16 frames of 256 at B = 2
    (64, None, 16, 0.5),  # one row per sample
])
def test_attention_guided_keep_equals_jax_on_the_same_noise(monkeypatch, rows, batch, n, ratio):
    rng = np.random.default_rng(rows + n)
    attn = rng.random((rows, n)).astype(np.float32)
    attn /= attn.sum(-1, keepdims=True)
    gumbel = rng.gumbel(size=(rows, n)).astype(np.float32)
    _with_noise(monkeypatch, "gumbel", gumbel)
    ref = np.asarray(jmask.attention_guided_keep_indices(
        jax.random.key(0), jnp.asarray(attn), ratio, batch=batch))
    got = masking.attention_guided_keep_from_noise(
        torch.from_numpy(attn), torch.from_numpy(gumbel), ratio, batch=batch)
    np.testing.assert_array_equal(got.numpy(), ref)
    if batch:
        assert got.shape == (batch, rows // batch * masking.num_visible(n, ratio))


def test_num_visible_matches_jax():
    for n, r in [(256, 0.8), (4096, 0.8), (100, 0.75), (16, 0.5), (833, 0.9)]:
        assert masking.num_visible(n, r) == jmask.num_visible(n, r)
    assert masking.num_visible(256, 0.8) == 52  # 16 * 52 + 1 = 833 student tokens


def _sorted_unique_in_range(keep, n):
    k = keep.numpy()
    assert np.all(np.diff(k, axis=1) > 0), "sorted without duplicates"
    assert k.min() >= 0 and k.max() < n


def test_draws_hold_counts_order_range_and_uniqueness():
    g = torch.Generator().manual_seed(0)
    keep = masking.random_keep_indices(g, 4, 100, 0.75)
    assert keep.shape == (4, 25) and keep.dtype == torch.int64
    _sorted_unique_in_range(keep, 100)

    keep = masking.tube_keep_indices(g, 2, 4, 16, 0.75)
    assert keep.shape == (2, 16)
    _sorted_unique_in_range(keep, 64)
    k = keep.numpy().reshape(2, 4, 4)
    np.testing.assert_array_equal(k[:, 0] % 16, k[:, -1] % 16)

    attn = torch.rand((6, 16), generator=g)
    keep = masking.attention_guided_keep_indices(g, attn, 0.5, batch=2)
    assert keep.shape == (2, 24)
    _sorted_unique_in_range(keep, 48)
    mask = masking.indices_to_mask(keep, 48)
    assert mask.shape == (2, 48) and int(mask.sum()) == 48
    np.testing.assert_array_equal(
        np.asarray(jmask.indices_to_mask(jnp.asarray(keep.numpy()), 48)), mask.numpy())

    a, b = (masking.random_keep_indices(torch.Generator().manual_seed(s), 2, 50, 0.5)
            for s in (1, 1))
    assert torch.equal(a, b), "a seeded generator repeats its draw"


def test_attention_guided_bias():
    """High-attention tokens are kept far more often (tests/test_pretrain.py:48)."""
    attn = torch.ones((64, 16))
    attn[:, 0] = 100.0
    keep = masking.attention_guided_keep_indices(torch.Generator().manual_seed(1), attn, 0.5)
    assert (keep == 0).any(dim=1).float().mean().item() > 0.95
