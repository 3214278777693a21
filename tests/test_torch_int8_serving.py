"""Int8 serving in the PyTorch port vs the JAX package, on the CPU: the
1B-family encoder with quant="int8", qwen3-MLA in int8_wo / int8_mix
(paged decode, prefill at M = INT8_MIX_DYN_M, generate, ServingEngine) and
the InternVideo3 vision tower with quant="int8", at the configs of
tests/test_quant_rl_paged.py:203-240, 296-358, 361-420, 423-456.

Each test feeds JAX's own quantized tree (`quantize_params_like`) to the
port through models/convert.py:params_from_jax; the port's
`quantize_params_like` on the same dense weights must give that tree
exactly (JAX's tree made eagerly: under jit XLA forms amax / 127 as
amax * (1 / 127), one ulp off on some rows).

A 1e-7 difference upstream of a projection can flip an activation code by
one step, and an int8 model carries that step on (the free-running outputs
sit 1e-7 to 3e-4 apart; the JAX tests' own int8 bars are 5e-3 and up). So
each model runs twice: free, where the outputs must agree at 5e-3 and the
flipped codes are printed, and with every int8 projection fed the input
JAX's projection got (recorded by a flax method interceptor), where the
outputs must agree at a relative L2 of 1e-4 in fp32: every other op of the
port still runs on its own values. Each JAX reference is built once per
module, under jit.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from internvideo_tpu.models import internvideo2 as jiv2
from internvideo_tpu.models import vision_tower as jvt
from internvideo_tpu.models.generation import generate as jgenerate
from internvideo_tpu.models.llm import LLMConfig as JLLMConfig
from internvideo_tpu.models.llm import MLATransformer as JMLATransformer
from internvideo_tpu.models.llm import init_paged_cache as j_init_paged_cache
from internvideo_tpu.nn.mla import MLAConfig as JMLAConfig
from internvideo_tpu.ops import quant as jquant
from internvideo_tpu.ops.quant import quantize_params_like as jquantize_params_like
from internvideo_tpu_torch.models import internvideo2 as iv2
from internvideo_tpu_torch.models import vision_tower as tvt
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.models.generation import generate
from internvideo_tpu_torch.models.llm import LLMConfig, MLATransformer, init_paged_cache
from internvideo_tpu_torch.nn.mla import MLAConfig
from internvideo_tpu_torch.ops import int8_gemm
from internvideo_tpu_torch.ops.quant import INT8_MIX_DYN_M, quantize_int8, quantize_params_like
from internvideo_tpu_torch.serve import ServingEngine

ENC = dict(embed_dim=128, depth=2, num_heads=4, mlp_ratio=4.0, patch_size=14, img_size=56,
           num_frames=4, tubelet_size=1, clip_embed_dim=64, num_classes=0)
LLM = dict(vocab_size=64, hidden_size=32, num_layers=2, intermediate_size=48,
           mrope_section=None)
MLA = dict(hidden_size=32, num_heads=2, kv_lora_rank=16, qk_rope_head_dim=8,
           qk_nope_head_dim=8, v_head_dim=8)
TOWER = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, patch_size=8,
             pos_embed_grid=8, deepstack_indexes=(0,), text_hidden_size=48)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(t):
    return t.detach().float().numpy()


def _load(model, jparams, cfg=None):
    model.load_state_dict(params_from_jax(jax.device_get(jparams), cfg), strict=True)
    return model.eval()


def _jax_run(run, *args):
    """jit-compile and run `run(*args)` (a JAX apply), returning its output and
    the input of each int8 projection under the port's module name."""

    def traced(*a):
        inputs = {}

        def record(next_fun, f_args, f_kwargs, context):
            if (isinstance(context.module, (jquant.Int8Dense, jquant.Int8WoDense))
                    and context.method_name == "__call__"):
                name = re.sub(r"_(\d+)(?=\.|$)", r".\1", ".".join(context.module.path))
                inputs.setdefault(name, f_args[0])
            return next_fun(*f_args, **f_kwargs)

        with fnn.intercept_methods(record):
            return run(*a), inputs

    out, inputs = jax.jit(traced)(*args)
    return out, {k: np.array(v) for k, v in inputs.items()}


def _port_runs(model, jax_inputs, run):
    """`run()` twice under no_grad: free, recording each int8 projection's
    input, and forced, each int8 projection fed JAX's recorded input in place
    of its own (so both packages quantize the same activations). Returns
    (free, forced, the activation codes that differ in the free run)."""
    seen = {}

    def record(name):
        def hook(module, args):
            seen.setdefault(name, args[0].detach())
        return hook

    hooks = [model.get_submodule(n).register_forward_pre_hook(record(n)) for n in jax_inputs]
    with torch.no_grad():
        free = run()
    for h in hooks:
        h.remove()
    flips = sum(int((quantize_int8(seen[n], -1)[0]
                     != quantize_int8(torch.from_numpy(x), -1)[0]).sum())
                for n, x in jax_inputs.items())
    hooks = [model.get_submodule(n).register_forward_pre_hook(
        lambda m, a, _x=torch.from_numpy(x): (_x,)) for n, x in jax_inputs.items()]
    with torch.no_grad():
        forced = run()
    for h in hooks:
        h.remove()
    return free, forced, flips


def _same_sd(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], atol=0, rtol=0, msg=key)


# -- the encoder ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def encoder_ref():
    """JAX dense and int8 encoders (LayerScale gammas at 0.5, as the JAX
    test), on one seeded clip."""
    jcfg = jiv2.InternVideo2Config(**ENC, attn_impl="xla")
    video = np.random.default_rng(0).standard_normal((2, 4, 56, 56, 3)).astype(np.float32)
    jm = jiv2.InternVideo2(jcfg)
    params = fnn.unbox(jax.jit(jm.init)(jax.random.key(1), video))["params"]
    for i in range(jcfg.depth):
        for ls in ("ls1", "ls2"):
            params[f"blocks_{i}"][ls]["gamma"] = jnp.full_like(
                params[f"blocks_{i}"][ls]["gamma"], 0.5)
    qm = jiv2.InternVideo2(dataclasses.replace(jcfg, quant="int8"))
    abstract = fnn.unbox(jax.eval_shape(qm.init, jax.random.key(1), video))["params"]
    qparams = jquantize_params_like(abstract, params)
    out, inputs = _jax_run(lambda p, v: qm.apply({"params": p}, v), qparams, video)
    return params, qparams, video, out, inputs


def test_int8_encoder_matches_jax(encoder_ref):
    params, qparams, video, jout, inputs = encoder_ref
    tcfg = iv2.InternVideo2Config(**ENC, attn_impl="plain", quant="int8")
    model = iv2.InternVideo2(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    qkv = model.blocks[0].attn.qkv
    assert qkv.weight_q.dtype == torch.int8 and qkv.weight_q.shape == (3 * 128, 128)
    assert qkv.scale.dtype == torch.float32 and qkv.scale.shape == (3 * 128,)
    _load(model, qparams, tcfg)
    # the port's quantize_params_like on the dense weights gives JAX's tree
    dense = iv2.InternVideo2(dataclasses.replace(tcfg, quant=None), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    _load(dense, params, tcfg)
    _same_sd(quantize_params_like(model, dense.state_dict()), model.state_dict())
    assert len(inputs) == 8  # qkv, proj, fc1, fc2 of both blocks
    out, forced, flips = _port_runs(model, inputs, lambda: model(torch.from_numpy(video)))
    free = {k: _rel(_np(getattr(out, k)), getattr(jout, k)) for k in ("pooled", "tokens")}
    same = {k: _rel(_np(getattr(forced, k)), getattr(jout, k)) for k in ("pooled", "tokens")}
    print(f"int8 encoder vs JAX: rel-L2 {same} on JAX's int8 inputs; free run {free}, "
          f"{flips} activation codes flipped")
    assert max(same.values()) <= 1e-4, same
    assert max(free.values()) <= 5e-3, free
    # the int8 model stays near the dense one (the JAX test's 5e-3 bar)
    with torch.no_grad():
        ref = dense(torch.from_numpy(video))
    assert _rel(_np(out.pooled), _np(ref.pooled)) < 5e-3


# -- qwen3-MLA: int8_wo / int8_mix --------------------------------------------------------


def _llm_cfgs(quant):
    jcfg = JLLMConfig(**LLM, mla=JMLAConfig(**MLA), attn_impl="xla", quant=quant)
    tcfg = LLMConfig(**LLM, mla=MLAConfig(**MLA), attn_impl="kernel", quant=quant)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def llm_ref():
    """JAX params, the int8 tree, int8_mix logits at b = 2, s = 512
    (M = INT8_MIX_DYN_M) and an int8_wo paged prefill + 2 decode steps."""
    jcfg, _ = _llm_cfgs(None)
    b, s = 2, INT8_MIX_DYN_M // 2
    ids = np.random.default_rng(1).integers(0, 64, (b, s)).astype(np.int32)
    params = fnn.unbox(jax.jit(JMLATransformer(jcfg).init)(jax.random.key(0), jnp.asarray(ids)))
    wo, mix = (JMLATransformer(_llm_cfgs(q)[0]) for q in ("int8_wo", "int8_mix"))
    qabstract = fnn.unbox(jax.eval_shape(wo.init, jax.random.key(0), jnp.asarray(ids)))
    qparams = jquantize_params_like(qabstract, params)
    mix_out, inputs = _jax_run(mix.apply, qparams, jnp.asarray(ids))
    pages, tables = j_init_paged_cache(jcfg, b, 16, 4, jnp.float32)
    prefill = jax.jit(lambda p, i, c, t: wo.apply(p, i, c, t, 4, method="prefill_paged"))
    decode = jax.jit(lambda p, i, c, t, n: wo.apply(p, i, c, t, n, 4, impl="xla",
                                                    method="decode_step_paged"))
    steps = [prefill(qparams, jnp.asarray(ids[:, :6]), pages, tables)]
    for t in (6, 7):
        lens = jnp.full((b,), t, jnp.int32)
        steps.append(decode(qparams, jnp.asarray(ids[:, t:t + 1]), steps[-1].caches, tables,
                            lens))
    return (params, qparams, ids, np.asarray(mix_out.logits), inputs,
            [np.asarray(o.logits) for o in steps])


def _port_llm(quant, qparams):
    _, tcfg = _llm_cfgs(quant)
    return _load(MLATransformer(tcfg, device="cpu", generator=torch.Generator().manual_seed(0)),
                 qparams, tcfg)


def test_int8_mix_prefill_matches_jax(llm_ref):
    params, qparams, ids, jlogits, inputs, _ = llm_ref
    mix = _port_llm("int8_mix", qparams)
    down = mix.layers[0].mlp.down_proj
    assert down.weight_q.shape == (32, 48) and down.dyn_m_threshold == INT8_MIX_DYN_M
    assert mix.lm_head.dyn_m_threshold is None  # weight-only under int8_mix too
    dense = _load(MLATransformer(_llm_cfgs(None)[1], device="cpu",
                                 generator=torch.Generator().manual_seed(0)), params)
    _same_sd(quantize_params_like(mix, dense.state_dict()), mix.state_dict())
    assert len(inputs) == 2 * 6 + 1  # q, kv_a, o, gate, up, down a layer; lm_head
    del inputs["lm_head"]  # weight-only: it quantizes no activations
    out, forced, flips = _port_runs(mix, inputs, lambda: mix(torch.from_numpy(ids).long()))
    same, free = _rel(_np(forced.logits), jlogits), _rel(_np(out.logits), jlogits)
    print(f"int8_mix prefill (M = {ids.size}) vs JAX: rel-L2 {same:.3e} on JAX's int8 inputs; "
          f"free run {free:.3e}, {flips} activation codes flipped")
    assert same <= 1e-4 and free <= 5e-3, (same, free)


def test_int8_wo_paged_decode_matches_jax_and_mix_decode_is_wo(llm_ref):
    _, qparams, ids, _, _, jsteps = llm_ref
    wo, mix = _port_llm("int8_wo", qparams), _port_llm("int8_mix", qparams)
    b = ids.shape[0]
    outs = {}
    for name, model in (("wo", wo), ("mix", mix)):
        pages, tables = init_paged_cache(model.cfg, b, 16, 4, torch.float32)
        with torch.no_grad():
            steps = [model.prefill_paged(torch.from_numpy(ids[:, :6]).long(), pages, tables, 4)]
            for t in (6, 7):
                lens = torch.full((b,), t, dtype=torch.int32)
                steps.append(model.decode_step_paged(torch.from_numpy(ids[:, t:t + 1]).long(),
                                                     pages, tables, lens, 4))
        outs[name] = [o.logits for o in steps]
    for got, want in zip(outs["wo"], jsteps):
        assert _rel(_np(got), want) <= 1e-4
    # below INT8_MIX_DYN_M rows int8_mix runs int8_wo's code: bit for bit
    for a, b_ in zip(outs["mix"], outs["wo"]):
        torch.testing.assert_close(a, b_, atol=0, rtol=0)


def test_int8_mix_generate_and_engine_match_jax(llm_ref):
    """A paged generate whose prefill takes the dynamic path (a prompt of
    INT8_MIX_DYN_M tokens) gives JAX's greedy tokens; a ServingEngine on the
    int8_mix model gives the same tokens per request as generate."""
    _, qparams, ids, _, _, _ = llm_ref
    mix = _port_llm("int8_mix", qparams)
    prompt = np.concatenate([ids[0], ids[1]])[None, :INT8_MIX_DYN_M]
    jmix = JMLATransformer(_llm_cfgs("int8_mix")[0])
    want = np.asarray(jgenerate(jmix, qparams, jnp.asarray(prompt), max_new_tokens=3,
                                paged=True, page_size=64, decode_impl="xla"))
    with torch.no_grad():
        got = generate(mix, torch.from_numpy(prompt).long(), max_new_tokens=3, paged=True,
                       page_size=64)
    np.testing.assert_array_equal(got.numpy(), want)
    reqs = [(prompt[0], 3), (ids[0, :40], 4), (ids[1, :100], 2)]
    eng = ServingEngine(mix, max_batch=2, page_size=16, num_pages=160, max_len=1040,
                        prompt_buckets=(128, INT8_MIX_DYN_M))
    with torch.no_grad():
        rids = [eng.submit(p, n) for p, n in reqs]
        served = eng.run()
        for rid, (p, n) in zip(rids, reqs):
            ref = generate(mix, torch.from_numpy(np.asarray(p))[None].long(), max_new_tokens=n,
                           paged=True, page_size=16)[0]
            np.testing.assert_array_equal(np.asarray(served[rid]), ref.numpy())
    assert int8_gemm.launch_count() == 0  # the CPU route launches nothing


def test_int8_llm_builds_int8_params_and_rejects_unknown_quant():
    for quant in ("int8_wo", "int8_mix"):
        model = MLATransformer(_llm_cfgs(quant)[1], device="cpu",
                               generator=torch.Generator().manual_seed(0))
        attn = model.layers[1].self_attn
        assert attn.q_proj.weight_q.dtype == torch.int8
        assert attn.q_proj.weight_q.shape == (2 * 16, 32)
        assert attn.kv_a_proj_with_mqa.scale.shape == (16 + 8,)
        assert attn.kv_b_proj_kernel.dtype == torch.float32  # kv_b stays a raw parameter
        assert model.lm_head.weight_q.shape == (64, 32)
    with pytest.raises(ValueError, match="quant"):
        MLATransformer(_llm_cfgs("int4")[1], device="cpu",
                       generator=torch.Generator().manual_seed(0))


# -- the vision tower ---------------------------------------------------------------------


def test_int8_vision_tower_matches_jax():
    jcfg = jvt.VisionTowerConfig(**TOWER, attn_impl="xla")
    tcfg = tvt.VisionTowerConfig(**TOWER, attn_impl="kernel", quant="int8")
    video = np.random.default_rng(2).standard_normal((1, 4, 16, 16, 3)).astype(np.float32)
    params = fnn.unbox(jax.jit(jvt.VisionTower(jcfg).init)(jax.random.key(1), video))
    qm = jvt.VisionTower(dataclasses.replace(jcfg, quant="int8"))
    qparams = jquantize_params_like(
        fnn.unbox(jax.eval_shape(qm.init, jax.random.key(1), video)), params)
    (jtoks, jtaps), inputs = _jax_run(qm.apply, qparams, video)
    tower = tvt.VisionTower(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert tower.blocks[0].fc2.weight_q.shape == (32, 64)
    _load(tower, qparams, tcfg)
    dense = _load(tvt.VisionTower(dataclasses.replace(tcfg, quant=None), device="cpu"), params)
    _same_sd(quantize_params_like(tower, dense.state_dict()), tower.state_dict())
    (toks, taps), forced, flips = _port_runs(tower, inputs,
                                             lambda: tower(torch.from_numpy(video)))
    assert len(taps) == len(jtaps) == 1 and toks.shape == jtoks.shape
    same = [_rel(_np(forced[0]), jtoks), _rel(_np(forced[1][0]), jtaps[0])]
    free = [_rel(_np(toks), jtoks), _rel(_np(taps[0]), jtaps[0])]
    print(f"int8 tower vs JAX: tokens / tap rel-L2 {same} on JAX's int8 inputs; free run "
          f"{free}, {flips} activation codes flipped")
    assert max(same) <= 1e-4 and max(free) <= 5e-3, (same, free)
