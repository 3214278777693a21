"""InternVideo2-Chat (ViT -> QFormer -> M2LA LLM) in the PyTorch port vs the
JAX package, on the CPU, at tests/test_chat_demo.py's CFG widths.

One JAX `VideoChat` is initialised on the XLA attention route; its params go
through `params_from_jax` into the port's `VideoChat`, which runs its kernel
route (on the CPU: the kernels' plain versions). The LM head is scaled by 25
in both, so that greedy argmaxes sit well clear of rounding. Held: the
QFormer alone (max-abs 2e-5), the forward's logits, prefill against the
forward's last position and one decode step at num_queries + L against
JAX's `decode_step` at the same cache_len (atol 2e-4 / rtol 1e-3, the bars
of tests/test_chat_demo.py), and the port's `generate` against JAX's
teacher-forced greedy loop over `VideoChat.__call__`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import unbox
from test_chat_demo import CFG as JCFG

from internvideo_tpu.models.chat import QFormer as JaxQFormer
from internvideo_tpu.models.chat import VideoChat as JaxVideoChat
from internvideo_tpu_torch.models.bert import BertConfig
from internvideo_tpu_torch.models.chat import QFormerConfig, VideoChat, VideoChatConfig
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.models.generation import generate
from internvideo_tpu_torch.models.internvideo2 import InternVideo2Config
from internvideo_tpu_torch.models.llm import LLMConfig
from internvideo_tpu_torch.nn.mla import MLAConfig

# test_chat_demo.CFG's widths, on the port's kernel route
CFG = VideoChatConfig(
    vision=InternVideo2Config(
        embed_dim=32, depth=1, num_heads=2, mlp_ratio=2.0, patch_size=14, img_size=28,
        num_frames=2, tubelet_size=1, clip_embed_dim=16, attn_impl="kernel"),
    qformer=QFormerConfig(
        num_queries=4,
        bert=BertConfig(vocab_size=16, hidden_size=32, num_layers=2, num_heads=2,
                        intermediate_size=64, fusion_layer=0, dropout=0.0,
                        attn_impl="kernel")),
    llm=LLMConfig(
        vocab_size=120, hidden_size=48, num_layers=2, intermediate_size=96, mrope_section=None,
        mla=MLAConfig(hidden_size=48, num_heads=2, kv_lora_rank=24, qk_rope_head_dim=8,
                      qk_nope_head_dim=8, v_head_dim=8),
        attn_impl="kernel"),
)
NQ = CFG.qformer.num_queries
IDS = np.array([[5, 9, 11], [3, 17, 80]], np.int32)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0)
    video = rng.standard_normal((2, 2, 28, 28, 3)).astype(np.float32)
    jmodel = JaxVideoChat(JCFG)
    # jitted: the same params bit for bit as the eager init, in a third of the time
    params = jax.jit(jmodel.init)(jax.random.key(1), jnp.asarray(IDS), jnp.asarray(video))
    params = jax.tree.map(np.asarray, jax.device_get(unbox(params)))
    lm = params["params"]["language_model"]
    lm["lm_head"]["kernel"] = lm["lm_head"]["kernel"] * 25
    model = VideoChat(CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(params, CFG), strict=True)
    return dict(jmodel=jmodel, params=params, model=model.eval(), video=video)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _jax_logits(pair, ids):
    return np.asarray(pair["jmodel"].apply(pair["params"], jnp.asarray(ids),
                                           jnp.asarray(pair["video"])).logits)


def test_params_from_jax_checks_depths(pair):
    import dataclasses

    deeper = dataclasses.replace(CFG, qformer=dataclasses.replace(
        CFG.qformer, bert=dataclasses.replace(CFG.qformer.bert, num_layers=3)))
    with pytest.raises(ValueError, match="blocks"):
        params_from_jax(pair["params"], deeper)


def test_qformer_matches_jax(pair):
    tokens = np.random.default_rng(1).standard_normal((2, 9, 32)).astype(np.float32)
    want = JaxQFormer(JCFG.qformer).apply({"params": pair["params"]["params"]["qformer"]},
                                          jnp.asarray(tokens))
    with torch.no_grad():
        got = pair["model"].qformer(_t(tokens))
    assert got.shape == (2, NQ, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_forward_prefill_decode_match_jax(pair):
    model, video = pair["model"], _t(pair["video"])
    l = IDS.shape[1]
    want = _jax_logits(pair, IDS)
    with torch.no_grad():
        out = model(_t(IDS).long(), video)
    assert out.logits.shape == (2, NQ + l, 120)
    np.testing.assert_allclose(out.logits.numpy(), want, atol=2e-4, rtol=1e-3)

    jm, params = pair["jmodel"], pair["params"]
    jcaches = jm.apply(params, 2, NQ + 8, jnp.float32, method="init_cache")
    jpre = jm.apply(params, jnp.asarray(IDS), jnp.asarray(pair["video"]), jcaches,
                    method="prefill")
    fed = np.array([[7], [101]], np.int32)
    jstep = jm.apply(params, jnp.asarray(fed), jpre.caches, jnp.int32(NQ + l),
                     method="decode_step")
    with torch.no_grad():
        caches = model.init_cache(2, NQ + 8, torch.float32)
        pre = model.prefill(_t(IDS).long(), video, caches)
        step = model.decode_step(_t(fed).long(), pre.caches, NQ + l)
    np.testing.assert_allclose(pre.logits[:, 0].numpy(), out.logits[:, -1].numpy(),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(pre.logits.numpy(), np.asarray(jpre.logits), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(step.logits.numpy(), np.asarray(jstep.logits),
                               atol=2e-4, rtol=1e-3)
    # the decode step equals the forward with one more token
    full = _jax_logits(pair, np.concatenate([IDS, fed], 1))
    np.testing.assert_allclose(step.logits[:, 0].numpy(), full[:, -1], atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("new_tokens", [6, NQ - 1])
def test_generate_matches_jax_teacher_forced_greedy(pair, new_tokens):
    ids = IDS
    for _ in range(new_tokens):
        nxt = _jax_logits(pair, ids)[:, -1].argmax(-1).astype(np.int32)
        ids = np.concatenate([ids, nxt[:, None]], 1)
    want = ids[:, IDS.shape[1]:]
    got = generate(pair["model"], _t(IDS).long(), video=_t(pair["video"]),
                   max_new_tokens=new_tokens, cache_dtype=torch.float32)
    assert got.shape == (2, new_tokens)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_offsets_decode_by_the_queries(pair):
    """The port's generate decodes at num_queries + prompt_len + step over a
    cache of num_queries + prompt_len + max_new_tokens entries. JAX's generate
    (internvideo_tpu/models/generation.py:47, 176) passes prompt_len + step,
    which on a VideoChat reads the wrong slots: its first decode step is off
    the teacher-forced forward, while at num_queries + prompt_len it is on.
    This is the one place the port departs from JAX on purpose."""
    model, l, n = pair["model"], IDS.shape[1], 4
    seen = []
    decode_step, init_cache = model.decode_step, model.init_cache

    def recording(token_ids, caches, cache_len, **kw):
        seen.append((cache_len, caches[0].shape[1]))
        return decode_step(token_ids, caches, cache_len, **kw)

    model.decode_step = recording
    try:
        generate(model, _t(IDS).long(), video=_t(pair["video"]), max_new_tokens=n)
    finally:
        del model.decode_step
    assert model.decode_step == decode_step and model.init_cache == init_cache
    assert seen == [(NQ + l + s, NQ + l + n) for s in range(n - 1)]

    jm, params = pair["jmodel"], pair["params"]
    fed = np.array([[7], [101]], np.int32)
    full = _jax_logits(pair, np.concatenate([IDS, fed], 1))[:, -1]
    jcaches = jm.apply(params, 2, NQ + l + n, jnp.float32, method="init_cache")
    jpre = jm.apply(params, jnp.asarray(IDS), jnp.asarray(pair["video"]), jcaches,
                    method="prefill")
    errs = {}
    for cache_len in (NQ + l, l):  # the port's, JAX generate's
        step = jm.apply(params, jnp.asarray(fed), jpre.caches, jnp.int32(cache_len),
                        method="decode_step")
        errs[cache_len] = np.abs(np.asarray(step.logits[:, 0]) - full).max()
    assert errs[NQ + l] <= 2e-4 and errs[l] > 1e-2, errs


def test_paged_generate_refuses_a_cache_prefix(pair):
    with pytest.raises(ValueError, match="ahead"):
        generate(pair["model"], _t(IDS).long(), video=_t(pair["video"]), max_new_tokens=2,
                 paged=True)
