"""InternVideo2 encoder: PyTorch port vs the JAX package, same params and inputs.

The JAX params come from `model.init`, with every LayerScale gamma raised
from its 1e-5 init to 0.1 so that the attention and MLP branches move the
residual stream visibly, and the head kernel scaled from its 2e-5 init to
std 0.02 so that the logits are not all below the tolerance. They go to the
port through `params_from_jax` and a strict `load_state_dict`. The config is
cut to 2 blocks, 2 heads of head dim 88, and S = 4*4*4 + 1 = 65 tokens:
ragged by one, like the 1B's 4097.
"""

import flax.linen as flax_nn
import jax
import numpy as np
import pytest
import torch

from internvideo_tpu.models import internvideo2 as jax_iv2
from internvideo_tpu.nn import embeds as jax_embeds
from internvideo_tpu.nn import transformer as jax_tf
from internvideo_tpu_torch.models import internvideo2 as iv2
from internvideo_tpu_torch.models.convert import _to_tensor, params_from_jax
from internvideo_tpu_torch.nn import embeds, transformer

SMALL = dict(embed_dim=176, num_heads=2, depth=2, num_frames=4, img_size=56,
             num_classes=10, attn_pool_num_heads=2, clip_embed_dim=32)
# JAX attn_impl -> the port's route that runs the same function on the CPU
ROUTES = {"xla": "plain", "pallas_interpret": "kernel"}


def _np_tree(tree):
    return jax.tree.map(np.asarray, flax_nn.unbox(tree))


def _raise_gammas(tree, value=0.1):
    if isinstance(tree, dict):
        return {k: (np.full_like(v, value) if k == "gamma" else _raise_gammas(v, value))
                for k, v in tree.items()}
    return tree


def _visible(params):
    params = _raise_gammas(params)
    head = params["params"]["head"]
    head["kernel"] = (head["kernel"].astype(np.float32) * 1000).astype(head["kernel"].dtype)
    return params


def _video(cfg, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (batch, cfg.num_frames, cfg.img_size, cfg.img_size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_params():
    """JAX params per (dtype, mlp_act): init is independent of attn_impl."""
    cache = {}

    def get(dtype, mlp_act):
        if (dtype, mlp_act) not in cache:
            cfg = jax_iv2.make_config("1B", **SMALL, dtype=dtype, param_dtype=dtype,
                                      mlp_act=mlp_act)
            video = _video(cfg)
            params = jax.jit(jax_iv2.InternVideo2(cfg).init)(jax.random.key(0), video[:1])
            cache[dtype, mlp_act] = _visible(_np_tree(params))
        return cache[dtype, mlp_act]

    return get


def _torch_model(dtype, mlp_act, attn_impl, params):
    cfg = iv2.make_config("1B", **SMALL, dtype=dtype, param_dtype=dtype,
                          mlp_act=mlp_act, attn_impl=ROUTES[attn_impl])
    model = iv2.InternVideo2(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0)).eval()
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return model


def _run_both(dtype, mlp_act, attn_impl, params):
    jcfg = jax_iv2.make_config("1B", **SMALL, dtype=dtype, param_dtype=dtype,
                               mlp_act=mlp_act, attn_impl=attn_impl)
    video = _video(jcfg)
    jout = jax.jit(lambda p, v: jax_iv2.InternVideo2(jcfg).apply(
        p, v, return_hidden_states=True))(params, video)
    model = _torch_model(dtype, mlp_act, attn_impl, params)
    with torch.inference_mode():
        tout = model(torch.from_numpy(video), return_hidden_states=True)
    pairs = {
        "tokens": (tout.tokens, jout.tokens),
        "pooled": (tout.pooled, jout.pooled),
        "logits": (tout.logits, jout.logits),
    }
    for i, (t, j) in enumerate(zip(tout.hidden_states, jout.hidden_states)):
        pairs[f"hidden_states[{i}]"] = (t, j)
    return model, {k: (t.float().numpy(), np.asarray(j, np.float32))
                   for k, (t, j) in pairs.items()}


@pytest.mark.parametrize("attn_impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("mlp_act", ["gelu", "gelu_tanh"])
def test_encoder_fp32_matches_jax(jax_params, mlp_act, attn_impl):
    # atol/rtol 1e-4: two frameworks' fp32 summation orders over two blocks
    _, pairs = _run_both("float32", mlp_act, attn_impl, jax_params("float32", mlp_act))
    for name, (t, j) in pairs.items():
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t, j, atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("attn_impl", ["xla", "pallas_interpret"])
def test_encoder_bf16_matches_jax(jax_params, attn_impl):
    model, pairs = _run_both("bfloat16", "gelu_tanh", attn_impl,
                             jax_params("bfloat16", "gelu_tanh"))
    for name, (t, j) in pairs.items():
        assert np.isfinite(t).all(), name
        rel = np.linalg.norm(t - j) / np.linalg.norm(j)
        assert rel <= 1e-2, (name, rel)  # BASELINE's bf16 bar
    # norm weights and LayerScale gammas stay fp32 under bf16 params
    for name, p in model.state_dict().items():
        *owners, leaf = name.split(".")
        fp32 = leaf == "gamma" or any("norm" in o for o in owners)
        assert p.dtype == (torch.float32 if fp32 else torch.bfloat16), name


def test_sincos_tables_equal_jax():
    np.testing.assert_array_equal(
        embeds.get_1d_sincos_pos_embed(64, 7, cls_token=True),
        jax_embeds.get_1d_sincos_pos_embed(64, 7, cls_token=True))
    np.testing.assert_array_equal(
        embeds.get_2d_sincos_pos_embed(64, 5), jax_embeds.get_2d_sincos_pos_embed(64, 5))
    np.testing.assert_array_equal(
        embeds.get_3d_sincos_pos_embed(1408, 16, 16, cls_token=True),
        jax_embeds.get_3d_sincos_pos_embed(1408, 16, 16, cls_token=True))


def test_patch_embed_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 28, 28, 3)).astype(np.float32)
    jmod = jax_embeds.PatchEmbed3D(embed_dim=48, patch_size=14, tubelet_size=2)
    params = _np_tree(jmod.init(jax.random.key(0), x))
    mod = embeds.PatchEmbed3D(48, patch_size=14, tubelet_size=2)
    mod.load_state_dict({
        "proj.weight": _to_tensor(params["params"]["proj"]["kernel"].T),
        "proj.bias": _to_tensor(params["params"]["proj"]["bias"]),
    })
    out = mod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(jmod.apply(params, x)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "quick_gelu"])
def test_mlp_matches_jax(act):
    # tighter than the slice test: the gelu variants differ by ~1e-4 only
    rng = np.random.default_rng(3)
    x = (2 * rng.standard_normal((2, 9, 48))).astype(np.float32)
    jmod = jax_tf.Mlp(hidden_dim=96, act=act)
    params = _np_tree(jmod.init(jax.random.key(0), x))["params"]
    mod = transformer.Mlp(48, 96, act=act)
    mod.load_state_dict({f"{fc}.{n}": _to_tensor(params[fc]["kernel"].T if n == "weight"
                                                 else params[fc]["bias"])
                         for fc in ("fc1", "fc2") for n in ("weight", "bias")}, strict=True)
    out = mod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(jmod.apply({"params": params}, x)),
                               atol=1e-6, rtol=1e-5)


def test_attention_pooling_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 65, 176)).astype(np.float32)
    jmod = jax_tf.AttentionPoolingBlock(num_heads=2, out_dim=32, attn_impl="xla")
    params = _np_tree(jmod.init(jax.random.key(0), x))
    mod = transformer.AttentionPoolingBlock(176, 2, 32)
    sd = {}
    for norm in ("norm1_q", "norm1_k", "norm1_v"):
        sd[f"{norm}.weight"] = _to_tensor(params["params"][norm]["scale"])
        sd[f"{norm}.bias"] = _to_tensor(params["params"][norm]["bias"])
    for lin in ("q", "k", "v", "proj"):
        p = params["params"]["cross_attn"][lin]
        sd[f"cross_attn.{lin}.weight"] = _to_tensor(p["kernel"].T)
        sd[f"cross_attn.{lin}.bias"] = _to_tensor(p["bias"])
    mod.load_state_dict(sd, strict=True)
    out = mod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(jmod.apply(params, x)), atol=1e-5, rtol=1e-5)


def test_params_from_jax_roundtrip_names(jax_params):
    params = jax_params("float32", "gelu")
    cfg = iv2.make_config("1B", **SMALL)
    sd = params_from_jax(params, cfg)
    assert sd["blocks.1.attn.qkv.weight"].shape == (3 * 176, 176)
    np.testing.assert_array_equal(
        sd["blocks.0.mlp.fc1.weight"].numpy(),
        params["params"]["blocks_0"]["mlp"]["fc1"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["clip_projector.norm1_q.weight"].numpy(),
        params["params"]["clip_projector"]["norm1_q"]["scale"])
    with pytest.raises(ValueError, match="depth"):
        params_from_jax(params, iv2.make_config("1B", **{**SMALL, "depth": 3}))


@pytest.mark.parametrize("override", [
    dict(remat=True, remat_policy="save_attn"), dict(quant="int8"), dict(pool_type="cls_proj"),
    dict(ln_pre=True), dict(remat_policy="offload_mlp"),
])
def test_unported_config_raises(override):
    """Each unported option raises naming its ROADMAP item; quant="int8"
    is ported: every block projection is an int8 Int8Dense (its parity
    with JAX is in test_torch_int8_serving.py), the pooling head stays
    dense."""
    cfg = iv2.make_config("1B", **{**SMALL, **override})
    if override == dict(quant="int8"):
        from internvideo_tpu_torch.ops.quant import Int8Dense

        model = iv2.InternVideo2(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        for blk in model.blocks:
            for name, (n, k) in (("attn.qkv", (3 * 176, 176)), ("attn.proj", (176, 176)),
                                 ("mlp.fc1", (768, 176)), ("mlp.fc2", (176, 768))):
                layer = blk.get_submodule(name)
                assert isinstance(layer, Int8Dense), name
                assert layer.weight_q.dtype == torch.int8 and layer.weight_q.shape == (n, k)
                assert layer.scale.dtype == torch.float32 and layer.scale.shape == (n,)
        assert model.clip_projector.cross_attn.q.weight.dtype == torch.float32
        with torch.no_grad():
            out = model(torch.from_numpy(_video(cfg, batch=1)))
        assert torch.isfinite(out.logits).all()
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        iv2.InternVideo2(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def test_unported_forward_options_raise():
    """The forward options the masked pretrain brought in (keep_indices,
    return_pool_attn) no longer raise: they gather the visible tokens and
    return the pooling attention over all tokens."""
    cfg = iv2.make_config("1B", **{**SMALL, "depth": 1})
    model = iv2.InternVideo2(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    video = torch.from_numpy(_video(cfg, batch=1))
    with torch.no_grad():
        out = model(video, keep_indices=torch.tensor([[0, 3, 5, 9]]))
        assert out.tokens.shape == (1, 5, cfg.embed_dim)
        out = model(video, return_pool_attn=True)
    assert out.pool_attn.shape == (1, 1 + cfg.num_patches)
    torch.testing.assert_close(out.pool_attn.sum(-1), torch.ones(1))


def test_seeded_init_is_reproducible_and_bf16_keeps_fp32_norms():
    cfg = iv2.make_config("1B", **{**SMALL, "depth": 1},
                          dtype="bfloat16", param_dtype="bfloat16")

    def build(seed):
        return iv2.InternVideo2(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(seed))

    a, b, c = build(0).state_dict(), build(0).state_dict(), build(1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.attn.qkv.weight"], c["blocks.0.attn.qkv.weight"])
    assert a["blocks.0.norm1.weight"].dtype == torch.float32
    assert a["blocks.0.ls1.gamma"].dtype == torch.float32
    assert a["fc_norm.weight"].dtype == torch.float32
    assert a["head.weight"].dtype == torch.bfloat16
    assert a["blocks.0.mlp.fc1.weight"].shape == (int(176 * 48 / 11), 176)
