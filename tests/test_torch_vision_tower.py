"""The InternVideo3 vision tower of the PyTorch port vs the JAX package.

Same params (JAX `init` -> models/convert.py `params_from_jax`, loaded with
strict=True), same clips (numpy from a seed), fp32 at hidden 144 with 2
heads of 72 (the tower's head dim, so the port's attention runs the small-S
plain version at 72 on the CPU): the tokens, every deepstack tap and each
patch merger, against JAX on its XLA attention route; the position table
resample and the 2D rope tables on their own, exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from internvideo_tpu.models import vision_tower as jvt
from internvideo_tpu_torch.models import vision_tower as tvt
from internvideo_tpu_torch.models.convert import params_from_jax

KW = dict(hidden_size=144, num_layers=3, num_heads=2, intermediate_size=96, patch_size=8,
          temporal_patch_size=2, spatial_merge_size=2, pos_embed_grid=6,
          deepstack_indexes=(0, 2), text_hidden_size=48)


def _pair(**over):
    jcfg = jvt.VisionTowerConfig(**{**KW, **over}, attn_impl="xla")
    tcfg = tvt.VisionTowerConfig(**{**KW, **over}, attn_impl="kernel")
    return jcfg, tcfg


def _load(module, jparams, cfg=None):
    module.load_state_dict(params_from_jax(jax.device_get(jparams), cfg), strict=True)
    return module


def test_tables_match_jax():
    for gh, gw in ((4, 4), (14, 14), (6, 10)):
        jc, js = jvt._vision_rope_tables(2, gh, gw, 72)
        tc, ts = tvt._vision_rope_tables(2, gh, gw, 72)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        table = np.random.default_rng(gh).standard_normal((48 * 48, 16)).astype(np.float32)
        want = jvt._interpolate_pos_embed(jnp.asarray(table), 48, gh, gw)
        got = tvt._interpolate_pos_embed(torch.from_numpy(table), 48, gh, gw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("frames", [2, 4])
def test_tower_and_mergers_match_jax(frames):
    jcfg, tcfg = _pair()
    video = np.random.default_rng(frames).standard_normal(
        (2, frames, 32, 48, 3)).astype(np.float32)
    jtower = jvt.VisionTower(jcfg)
    jparams = fnn.unbox(jtower.init(jax.random.key(0), video))["params"]
    jtokens, jtaps = jtower.apply({"params": jparams}, video)
    tower = _load(tvt.VisionTower(tcfg, device="cpu"), jparams, tcfg)
    tokens, taps = tower(torch.from_numpy(video))
    gt, gh, gw = frames // 2, 4, 6
    assert tokens.shape == (2, gt * gh * gw, 144) and len(taps) == 2
    np.testing.assert_allclose(tokens.detach().numpy(), np.asarray(jtokens), atol=2e-4,
                               rtol=2e-4)
    for a, b in zip(taps, jtaps):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=2e-4, rtol=2e-4)

    x = np.array(jtokens)
    for post in (False, True):
        jm = jvt.PatchMerger(jcfg, use_postshuffle_norm=post)
        mp = fnn.unbox(jm.init(jax.random.key(1), x))["params"]
        want = jm.apply({"params": mp}, x)
        merger = _load(tvt.PatchMerger(tcfg, use_postshuffle_norm=post, device="cpu"), mp)
        got = merger(torch.from_numpy(x))
        assert got.shape == (2, gt * gh * gw // 4, 48)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5,
                                   rtol=2e-5)


def test_tower_gradients_flow_and_unported_options_raise():
    _, tcfg = _pair()
    tower = tvt.VisionTower(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tokens, taps = tower(torch.randn(1, 2, 16, 16, 3))
    (tokens.square().sum() + sum(t.sum() for t in taps)).backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in tower.parameters())
    # quant="int8" is ported (parity: test_torch_int8_serving.py): the block
    # projections hold int8 weights, the patch embed stays dense
    qtower = tvt.VisionTower(dataclasses.replace(tcfg, quant="int8"), device="cpu")
    blk = qtower.blocks[0]
    assert blk.qkv.weight_q.shape == (3 * 144, 144) and blk.fc2.weight_q.shape == (144, 96)
    assert blk.fc1.scale.dtype == torch.float32 and qtower.patch_embed.weight.dtype == torch.float32
    with pytest.raises(ValueError, match="quant"):
        tvt.VisionTower(dataclasses.replace(tcfg, quant="int4"), device="cpu")
