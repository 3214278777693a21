"""The M2LA LLM serving slice of the PyTorch port vs the JAX package:
MLATransformer logits, greedy generate (dense and paged), sampling, the
presets and the weight bridge.

Weights are the JAX model's init, loaded through
models/convert.py:params_from_jax with strict=True (tests/torch_llm_pair.py).
The port's models use the kernel route, which on the CPU runs the kernels'
plain versions (K5's causal flash, K6's paged decode); JAX runs its XLA
route. Logits agree at 2e-5 in fp32; greedy tokens are identical. The
engine is held in test_torch_serving_engine.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from internvideo_tpu.models import presets as jpresets
from internvideo_tpu.models.generation import generate as jax_generate
from internvideo_tpu.models.llm import LLMConfig as JLLMConfig
from internvideo_tpu.models.llm import MLATransformer as JMLATransformer
from internvideo_tpu.models.llm import init_paged_cache as j_init_paged_cache
from internvideo_tpu.nn.mla import MLAConfig as JMLAConfig
from internvideo_tpu_torch.models import presets
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.models.generation import _sample, generate
from internvideo_tpu_torch.models.llm import LLMConfig, MLATransformer, init_paged_cache
from internvideo_tpu_torch.nn.mla import MLAConfig
from tests.torch_llm_pair import CONFIGS
from tests.torch_llm_pair import llm_pair as _pair


def _close(a, b, tol=2e-5):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=tol, rtol=tol)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_prefill_decode_logits_match_jax(name):
    jm, params, tm = _pair(name)
    ids = np.random.default_rng(0).integers(1, 90, size=(2, 6)).astype(np.int32)
    jids, tids = jnp.asarray(ids), torch.from_numpy(ids).long()
    with torch.no_grad():
        _close(tm(tids).logits, jm.apply(params, jids).logits)
        # dense cache: prefill 4 tokens, decode tokens 4 and 5
        jc = jm.apply(params, 2, 8, jnp.float32, method="init_cache")
        tc = tm.init_cache(2, 8, torch.float32)
        jout = jm.apply(params, jm.apply(params, method=lambda m: m.embed_tokens)(jids[:, :4]),
                        jc, method="prefill")
        tout = tm.prefill(tm.embed_tokens(tids[:, :4]), tc)
        _close(tout.logits, jout.logits)
        for t in (4, 5):
            jout = jm.apply(params, jids[:, t:t + 1], jout.caches, jnp.int32(t),
                            method="decode_step")
            tout = tm.decode_step(tids[:, t:t + 1], tout.caches, t)
            _close(tout.logits, jout.logits)
            for a, b in zip(tout.caches, jout.caches):
                _close(a, b)
        # paged pools: prefill 4 tokens, decode tokens 4 and 5 (ragged lengths)
        jp, jt = j_init_paged_cache(jm.cfg, 2, 8, 4, jnp.float32)
        tp, tt = init_paged_cache(tm.cfg, 2, 8, 4, torch.float32)
        jout = jm.apply(params, jids[:, :4], jp, jt, 4, method="prefill_paged")
        tout = tm.prefill_paged(tids[:, :4], tp, tt, 4)
        _close(tout.logits, jout.logits)
        jpages = jout.caches
        for t in (4, 5):
            lens = np.full((2,), t, np.int32)
            jout = jm.apply(params, jids[:, t:t + 1], jpages, jt, jnp.asarray(lens), 4,
                            impl="xla", method="decode_step_paged")
            jpages = jout.caches
            tout = tm.decode_step_paged(tids[:, t:t + 1], tp, tt, torch.from_numpy(lens), 4)
            _close(tout.logits, jout.logits)
        for a, b in zip(tp, jpages):
            _close(a, b)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_generate_matches_jax_dense_and_paged(name):
    jm, params, tm = _pair(name)
    ids = np.random.default_rng(3).integers(1, 90, size=(2, 5)).astype(np.int32)
    want = np.asarray(jax_generate(jm, params, jnp.asarray(ids), max_new_tokens=6))
    for kw in ({}, {"paged": True, "page_size": 4}):
        got = generate(tm, torch.from_numpy(ids).long(), max_new_tokens=6, **kw)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(kw))
    # eos: JAX's finished mask, eos-padded
    eos = int(want[0, 2])
    want = np.asarray(jax_generate(jm, params, jnp.asarray(ids), max_new_tokens=6,
                                   eos_token_id=eos))
    got = generate(tm, torch.from_numpy(ids).long(), max_new_tokens=6, eos_token_id=eos,
                   paged=True, page_size=4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_topk_topp_sampling():
    tm = _pair("llm_tiny_mrope")[2]
    ids = torch.from_numpy(np.random.default_rng(5).integers(1, 90, size=(2, 4))).long()
    greedy = generate(tm, ids, max_new_tokens=5)
    g = torch.Generator().manual_seed(7)
    # top_k=1 at any temperature == greedy; a tiny top_p keeps only the argmax
    torch.testing.assert_close(generate(tm, ids, max_new_tokens=5, temperature=1.0, top_k=1,
                                        generator=g), greedy)
    torch.testing.assert_close(generate(tm, ids, max_new_tokens=5, temperature=1.0,
                                        top_p=1e-6, generator=g), greedy)
    samp = generate(tm, ids, max_new_tokens=5, temperature=1.0, top_k=10, top_p=0.9,
                    generator=g)
    assert samp.shape == (2, 5) and ((samp >= 0) & (samp < 97)).all()
    with pytest.raises(ValueError, match="top_p"):
        generate(tm, ids, max_new_tokens=2, temperature=1.0, top_p=0.0)
    # support: every draw lies in the top-k set / the nucleus
    logits = torch.from_numpy(np.random.default_rng(8).standard_normal((4, 50))).float()
    top3 = logits.topk(3).indices
    for _ in range(20):
        tok = _sample(logits, temperature=0.7, top_k=3, top_p=None, generator=g)
        assert (tok[:, None] == top3).any(-1).all()
    probs = torch.softmax(logits, -1)
    order = probs.argsort(-1, descending=True)
    cum = probs.gather(-1, order).cumsum(-1)
    for _ in range(20):
        tok = _sample(logits, temperature=1.0, top_k=None, top_p=0.5, generator=g)
        rank = (order == tok[:, None]).float().argmax(-1)
        # kept: the smallest prefix whose mass reaches 0.5 (the first always)
        prev = torch.where(rank > 0, cum.gather(-1, (rank - 1).clamp(min=0)[:, None])[:, 0], 0.0)
        assert (prev < 0.5).all()
    # explicit positions: the default arange on the dense path gives the
    # default tokens; the paged path refuses them, as in JAX
    pos = torch.arange(ids.shape[1])[None].expand(ids.shape[0], -1)
    torch.testing.assert_close(generate(tm, ids, max_new_tokens=5, position_ids=pos), greedy)
    with pytest.raises(NotImplementedError, match="position_ids"):
        generate(tm, ids, max_new_tokens=2, position_ids=pos, paged=True)


def test_presets_match_jax_and_unported_options_raise():
    for name in ("qwen3_8b_mla", "qwen3_2b_mla"):
        j, t = getattr(jpresets, name)(), getattr(presets, name)()
        assert dataclasses.asdict(j) == dataclasses.asdict(t), name
        assert sum(t.mrope_section) == t.mla.qk_rope_head_dim // 2
    tiny = dict(CONFIGS["tiny_llm"])
    cfg = LLMConfig(**{**tiny, "mla": MLAConfig(**tiny["mla"])})
    assert presets.qwen3_mla_tiny() == cfg
    gen = torch.Generator().manual_seed(0)
    for over, item in ((dict(fp8="fwd"), "item 10"), (dict(moe=object()), "item 8")):
        with pytest.raises(NotImplementedError, match=item):
            MLATransformer(dataclasses.replace(cfg, **over), device="cpu", generator=gen)
    # int8_wo / int8_mix are ported (parity: test_torch_int8_serving.py): every
    # projection and the lm_head hold int8 weights with fp32 scales
    for quant in ("int8_wo", "int8_mix"):
        qm = MLATransformer(dataclasses.replace(cfg, quant=quant), device="cpu", generator=gen)
        mlp = qm.layers[0].mlp
        assert mlp.gate_proj.weight_q.shape == (cfg.intermediate_size, cfg.hidden_size)
        assert mlp.down_proj.weight_q.dtype == torch.int8
        assert qm.lm_head.scale.shape == (cfg.vocab_size,)
    # remat (the 8B preset's training setting) is ported: per-layer
    # checkpointing gives the plain forward's logits and gradients
    remat = MLATransformer(dataclasses.replace(cfg, remat=True), device="cpu",
                           generator=torch.Generator().manual_seed(1))
    plain = MLATransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    ids = torch.tensor([[1, 5, 9, 2, 7]])
    seg = torch.tensor([[0, 0, 0, 1, 1]])
    outs = [m(ids, segment_ids=seg).logits for m in (remat, plain)]
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    for m, out in zip((remat, plain), outs):
        out.square().sum().backward()
    for (name, a), b in zip(remat.named_parameters(), plain.parameters()):
        torch.testing.assert_close(a.grad, b.grad, atol=0, rtol=0, msg=name)
    with torch.no_grad():
        assert remat(ids).logits.shape == (1, 5, 97)
    # the weight bridge checks the depth
    jm, params, _ = _pair()
    with pytest.raises(ValueError, match="depth"):
        params_from_jax(jax.device_get(params), dataclasses.replace(cfg, num_layers=3))


def test_tied_embeddings_match_jax():
    spec = dict(CONFIGS["tiny_llm"])
    mla = spec.pop("mla")
    jcfg = JLLMConfig(**spec, mla=JMLAConfig(**mla), tie_word_embeddings=True, attn_impl="xla")
    tcfg = LLMConfig(**spec, mla=MLAConfig(**mla), tie_word_embeddings=True)
    jm = JMLATransformer(jcfg)
    ids = np.arange(1, 7, dtype=np.int32)[None]
    params = fnn.unbox(jm.init(jax.random.key(1), jnp.asarray(ids)))
    tm = MLATransformer(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(params_from_jax(jax.device_get(params), tcfg), strict=True)
    with torch.no_grad():
        _close(tm(torch.from_numpy(ids).long()).logits, jm.apply(params, jnp.asarray(ids)).logits)
