"""The MoE M2LA LLM of the PyTorch port vs the JAX package: MLATransformer
with MoE layers (logits, the summed aux loss, prefill + decode on the dense
and paged caches), greedy generate (dense and paged), the ServingEngine,
the HF checkpoint path (`cli.generate --checkpoint`, the convert CLI) and
the MoE presets.

Three tiny configs: `qwen3_moe_tiny` (the JAX MoE LLM test's model,
tests/test_mla_llm.py:169-199: dropless softmax router); one with a dense
first layer (`moe_first_k_dense=1`), q_lora and the DeepSeek-V3 router
(sigmoid, node-limited groups, scaling, a shared expert); and one with no
nope part and q / kv biases (GPT-OSS's attention) with expert biases and
the clipped SwiGLU. Weights are the port's seeded init as a JAX tree
(`params_to_jax`, shaped as JAX's init), loaded back through
models/convert.py:params_from_jax with strict=True; fp32; logits within
2e-5, greedy tokens equal. The aux sum is held against JAX's
`moe_aux_losses` over `mutable=["intermediates"]` alone: with
`capture_intermediates=True` (as JAX's own test passes) that collection
also holds every submodule's output, and the sum is not the aux loss.
"""

import contextlib
import dataclasses
import functools
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import internvideo_tpu.models.presets as jpresets
from internvideo_tpu.models import convert as jconv
from internvideo_tpu.models.generation import generate as jax_generate
from internvideo_tpu.models.llm import LLMConfig as JLLMConfig
from internvideo_tpu.models.llm import MLATransformer as JMLATransformer
from internvideo_tpu.models.llm import moe_aux_losses as j_moe_aux_losses
from internvideo_tpu.nn.mla import MLAConfig as JMLAConfig
from internvideo_tpu.nn.moe import MoEConfig as JMoEConfig
from internvideo_tpu_torch.cli import generate as gen_cli
from internvideo_tpu_torch.core import checkpoint as ck
from internvideo_tpu_torch.models import presets
from internvideo_tpu_torch.models.convert import (
    convert_hf_mla_llm,
    export_mla_llm_hf,
    params_from_jax,
    params_to_jax,
)
from internvideo_tpu_torch.models.generation import generate
from internvideo_tpu_torch.models.llm import (
    LLMConfig,
    MLATransformer,
    SwiGLU,
    init_paged_cache,
    moe_aux_losses,
)
from internvideo_tpu_torch.nn.moe import MoEMlp
from internvideo_tpu_torch.serve import ServingEngine
from internvideo_tpu_torch.tools import convert_cli as tcli

_TINY = presets.qwen3_moe_tiny()
CONFIGS = {
    "qwen3_moe_tiny": _TINY,
    "first_dense_sigmoid": dataclasses.replace(
        _TINY, moe_first_k_dense=1,
        mla=dataclasses.replace(_TINY.mla, q_lora_rank=16, qkv_bias=False),
        moe=dataclasses.replace(_TINY.moe, num_experts=8, scoring_func="sigmoid", n_group=4,
                                topk_group=2, router_scaling_factor=2.5,
                                num_shared_experts=1)),
    "nope0_biases": dataclasses.replace(
        _TINY, mla=dataclasses.replace(_TINY.mla, qk_nope_head_dim=0, v_head_dim=8,
                                       qkv_bias=True),
        moe=dataclasses.replace(_TINY.moe, expert_bias=True, act_fn="clipped_swiglu")),
}
_CACHE = {}


def _jax_cfg(cfg: LLMConfig):
    """The JAX LLMConfig of a port one (the same fields), on JAX's XLA route."""
    d = dataclasses.asdict(cfg)
    d["mla"], d["moe"] = JMLAConfig(**d["mla"]), JMoEConfig(**d["moe"])
    return JLLMConfig(**{**d, "attn_impl": "xla"})


def _pair(name):
    """(JAX model, JAX params, port model) on the same weights: the port's
    seeded init as a JAX tree (`params_to_jax`, checked against the shapes
    of JAX's own init), carried back by `params_from_jax` with strict=True."""
    if name not in _CACHE:
        cfg = dataclasses.replace(CONFIGS[name], attn_impl="kernel")
        jm = JMLATransformer(_jax_cfg(cfg))
        tm = MLATransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                              params_to_jax(tm.state_dict(), tm))
        shapes = fnn.unbox(jax.eval_shape(jm.init, jax.random.key(0),
                                          jnp.zeros((1, 8), jnp.int32)))
        assert jax.tree.map(lambda a: a.shape, params) == jax.tree.map(lambda a: a.shape, shapes)
        tm.load_state_dict(params_from_jax(jax.device_get(params), cfg), strict=True)
        _CACHE[name] = (jm, params, tm.eval())
    return _CACHE[name]


def _jax_tokens(name):
    """JAX's greedy generate of 6 tokens for the seeded (2, 5) prompts, run
    under one jit (the same tokens as its eager run, in a quarter of the
    time: one compile of the prefill and the scanned decode)."""
    key = ("tokens", name)
    if key not in _CACHE:
        jm, params, _ = _pair(name)
        ids = np.random.default_rng(3).integers(1, 60, size=(2, 5)).astype(np.int32)
        gen = jax.jit(functools.partial(jax_generate, jm, max_new_tokens=6))
        _CACHE[key] = ids, np.asarray(gen(params, jnp.asarray(ids)))
    return _CACHE[key]


def _close(a, b, tol=2e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=tol)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_aux_and_cached_decode_match(name):
    jm, params, tm = _pair(name)
    ids = np.random.default_rng(0).integers(1, 60, size=(2, 6)).astype(np.int32)
    tids = torch.from_numpy(ids).long()
    jout, state = jax.jit(lambda p, i: jm.apply(p, i, mutable=["intermediates"]))(
        params, jnp.asarray(ids))
    with torch.no_grad():
        full = tm(tids)
    _close(full.logits, jout.logits)
    _close(full.moe_aux_loss, j_moe_aux_losses(state["intermediates"]), 1e-6)
    if not tm.cfg.moe.router_bias_balancing:
        assert float(full.moe_aux_loss) > 0
    _close(moe_aux_losses(tm), full.moe_aux_loss, 0)
    # the layer kinds: dense SwiGLU in the first moe_first_k_dense layers
    kinds = [type(layer.mlp) for layer in tm.layers]
    k = tm.cfg.moe_first_k_dense
    assert kinds == [SwiGLU] * k + [MoEMlp] * (tm.cfg.num_layers - k)
    with torch.no_grad():
        # dense cache: prefill 4 tokens, decode tokens 4 and 5
        caches = tm.init_cache(2, 8, torch.float32)
        out = tm.prefill(tm.embed_tokens(tids[:, :4]), caches)
        _close(out.logits[:, -1], full.logits[:, 3])
        for t in (4, 5):
            out = tm.decode_step(tids[:, t:t + 1], caches, t)
            _close(out.logits[:, -1], full.logits[:, t])
        # paged pools, page size 4
        pages, tables = init_paged_cache(tm.cfg, 2, 8, 4, torch.float32)
        out = tm.prefill_paged(tids[:, :4], pages, tables, 4)
        _close(out.logits[:, -1], full.logits[:, 3])
        for t in (4, 5):
            out = tm.decode_step_paged(tids[:, t:t + 1], pages, tables,
                                       torch.full((2,), t, dtype=torch.int32), 4)
            _close(out.logits[:, -1], full.logits[:, t])
        assert out.moe_aux_loss is not None


def test_greedy_generate_and_engine_match_jax():
    tm = _pair("qwen3_moe_tiny")[2]
    ids, want = _jax_tokens("qwen3_moe_tiny")
    for kw in ({}, {"paged": True, "page_size": 4}):
        got = generate(tm, torch.from_numpy(ids).long(), max_new_tokens=6, **kw)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(kw))
    # the engine: one request a slot, tokens equal generate's
    eng = ServingEngine(tm, max_batch=2, page_size=4, num_pages=16, max_len=16,
                        prompt_buckets=(8,), decode_horizon=2)
    rids = [eng.submit(p, 6) for p in ids]
    outs = eng.run()
    np.testing.assert_array_equal(np.stack([outs[r] for r in rids]), want)


def test_hf_checkpoint_through_generate_and_convert_clis(tmp_path):
    """A synthetic Qwen3-MoE HF checkpoint (fp32 shards of the model above,
    written by the port's exporter) -> the port's and JAX's converters give
    the same tree; `cli.generate --checkpoint` gives JAX's greedy tokens on
    it; the convert CLI's npz holds JAX's converter's tree."""
    jm, params, tm = _pair("qwen3_moe_tiny")
    cfg = presets.qwen3_moe_tiny()
    hf = export_mla_llm_hf(params_to_jax(tm.state_dict(), tm), cfg)
    assert "model.layers.1.mlp.experts.3.down_proj.weight" in hf
    ck.save_hf_checkpoint(str(tmp_path / "hf"), hf, shard_size_bytes=20_000)
    sd = ck.load_hf_checkpoint(str(tmp_path / "hf"))
    got = params_from_jax(convert_hf_mla_llm(sd, cfg), cfg)
    want = jconv.convert_hf_mla_llm({k: v.numpy() for k, v in sd.items()}, jm.cfg)
    for key, t in params_from_jax(want, cfg).items():
        assert torch.equal(got[key], t), key
    for key, t in params_from_jax(params, cfg).items():  # the model that wrote it
        assert torch.equal(got[key], t), key
    prompts, jtok = _jax_tokens("qwen3_moe_tiny")
    ids = prompts[0].tolist()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = gen_cli.main(["--preset", "qwen3_moe_tiny", "--checkpoint", str(tmp_path / "hf"),
                           "--ids", ",".join(map(str, ids)), "--max-new-tokens", "6",
                           "--paged", "--page-size", "4", "--device", "cpu"])
    assert rc == 0
    assert json.loads(buf.getvalue().strip().splitlines()[-1])["tokens"] == jtok[0].tolist()
    # the convert CLI's npz holds JAX's converter's tree, leaf for leaf
    dst = str(tmp_path / "llm.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli.main(["--kind", "hf_mla_llm", "--preset", "qwen3_moe_tiny",
                          "--src", str(tmp_path / "hf"), "--dst", dst]) == 0
    flat = tcli.flatten_params(want["params"])
    with np.load(dst) as z:
        assert sorted(z.files) == sorted(flat)
        for k, v in flat.items():
            assert z[k].dtype == v.dtype and z[k].tobytes() == np.ascontiguousarray(v).tobytes(), k
    # no HF names are known for expert biases or shared experts: refused
    for name in ("nope0_biases", "first_dense_sigmoid"):
        with pytest.raises(NotImplementedError, match="expert"):
            convert_hf_mla_llm(sd, CONFIGS[name])


def test_moe_presets_match_jax():
    for name in ("qwen3_moe_text", "gpt_oss_moe_text", "deepseek_v3"):
        assert dataclasses.asdict(getattr(jpresets, name)()) == \
            dataclasses.asdict(getattr(presets, name)()), name
    # qwen3_moe_tiny is the JAX MoE LLM test's config
    jtiny = _jax_cfg(presets.qwen3_moe_tiny())
    assert dataclasses.replace(jtiny, attn_impl="auto") == JLLMConfig(
        vocab_size=64, hidden_size=32, num_layers=2, intermediate_size=48, mrope_section=None,
        mla=JMLAConfig(hidden_size=32, num_heads=2, kv_lora_rank=16, qk_rope_head_dim=8,
                       qk_nope_head_dim=8, v_head_dim=8),
        moe=JMoEConfig(num_experts=4, top_k=2, intermediate_size=24, dispatch="dropless"))


def test_moe_presets_take_instantiated_kernel_shapes():
    """Each MoE preset's prefill takes an instantiated K5 (d_qk, d_v) and its
    paged decode an instantiated bf16 K6 (R, P); at B 8 over the serving
    lengths the bf16 K6 grid (splits x head groups x B) stays one wave."""
    from internvideo_tpu_torch.ops import flash_attention as fa
    from internvideo_tpu_torch.ops import paged_decode as pd

    for name, heads, dims in (("qwen3_moe_text", 32, (128, 64)),
                              ("gpt_oss_moe_text", 64, (64, 64)),
                              ("deepseek_v3", 128, (192, 128))):
        mla = getattr(presets, name)().mla
        assert (mla.num_heads, (mla.q_head_dim, mla.v_head_dim)) == (heads, dims), name
        assert dims in fa.CAUSAL_HEAD_DIMS, name
        assert (mla.kv_lora_rank, mla.qk_rope_head_dim) in pd.BF16_LATENT_ROPE, name
        groups = -(-heads // pd.BF16_HEADS_PER_CTA)
        split = pd.split_len_bf16(8, 33 * 64, 132, groups)
        assert split % 16 == 0 and 8 * groups * -(-33 * 64 // split) <= 132, name
