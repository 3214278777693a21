"""The dense-GQA LLM of the PyTorch port (models/llm_gqa.py) vs the JAX
package: the ports of tests/test_gqa_llm.py except the HF round trip
(checkpoint I/O is not ported), each also held against JAX on the same
weights.

Weights are the JAX model's init, loaded through
models/convert.py:params_from_jax with strict=True; the lm_head is scaled
up (std ~0.5) so that greedy tokens are decided by clear margins. The port
runs its kernel route for the full forward and the prefill (on the CPU the
K5 family's plain version, with GQA and the window) and the plain route for
decode, as JAX does; JAX runs its XLA route (a window through the Pallas
interpreter). fp32: logits 2e-5 absolute / 1e-4 relative against JAX; the
JAX tests' own 2e-4 / 1e-3 for cache-vs-forward checks.
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
from internvideo_tpu.models.llm_gqa import GQAConfig as JGQAConfig
from internvideo_tpu.models.llm_gqa import GQATransformer as JGQATransformer
from internvideo_tpu.models.mllm import MLLMConfig as JMLLMConfig
from internvideo_tpu.models.mllm import VideoMLLM as JVideoMLLM
from internvideo_tpu.models.vision_tower import VisionTowerConfig as JVisionTowerConfig
from internvideo_tpu_torch.models import presets
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.models.generation import generate
from internvideo_tpu_torch.models.llm_gqa import GQAConfig, GQATransformer
from internvideo_tpu_torch.models.mllm import MLLMConfig, VideoMLLM
from internvideo_tpu_torch.models.vision_tower import VisionTowerConfig

# tests/test_gqa_llm.py:11-15
CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
           intermediate_size=128, qk_norm=True)


def _visible(params):
    params = jax.tree.map(np.asarray, fnn.unbox(params))["params"]
    lm = params.get("language_model", params)
    lm["lm_head"]["kernel"] = lm["lm_head"]["kernel"] * 25
    return params


def _pair(seed=0, **over):
    """(JAX model, its params as numpy, port model on them)."""
    jm = JGQATransformer(JGQAConfig(**{**CFG, **over}, attn_impl="xla"))
    params = _visible(jm.init(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32)))
    tcfg = GQAConfig(**{**CFG, **over}, attn_impl="kernel")
    tm = GQATransformer(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(params_from_jax(params, tcfg), strict=True)
    return jm, {"params": params}, tm.eval()


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(1, 90, shape).astype(np.int32)


def _close(a, b, atol=2e-5, rtol=1e-4):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=atol, rtol=rtol)


def test_forward_logits_match_jax(pair):
    jm, params, tm = pair
    ids = _ids(0, (2, 6))
    want = jm.apply(params, ids)
    got = tm(torch.from_numpy(ids).long())
    assert got.logits.shape == (2, 6, 97)
    _close(got.logits, want.logits)
    _close(got.hidden, want.hidden)


def test_cache_matches_full_forward(pair):
    """test_gqa_cache_matches_full_forward: prefill 4 tokens, decode 2, each
    against the full forward; and the decode logits against JAX's decode."""
    jm, params, tm = pair
    ids = _ids(1, (2, 6))
    tids = torch.from_numpy(ids).long()
    full = tm(tids).logits
    caches = tm.init_cache(2, 8, torch.float32)
    pre = tm.prefill(tm.embed_tokens(tids[:, :4]), caches)
    _close(pre.logits[:, 0], full[:, 3].detach().numpy(), atol=2e-4, rtol=1e-3)
    jc = jm.apply(params, 2, 8, jnp.float32, method="init_cache")
    jembeds = jm.apply(params, method=lambda m: m.embed_tokens)(ids[:, :4])
    jout = jm.apply(params, jembeds, jc, method="prefill")
    _close(pre.logits, jout.logits)
    jc = jout.caches
    for t in (4, 5):
        step = tm.decode_step(tids[:, t:t + 1], caches, t)
        _close(step.logits[:, 0], full[:, t].detach().numpy(), atol=2e-4, rtol=1e-3)
        jstep = jm.apply(params, ids[:, t:t + 1], jc, jnp.int32(t), method="decode_step")
        _close(step.logits, jstep.logits)
        jc = jstep.caches
    for (k, v), (jk, jv) in zip(caches, jc):
        _close(k, jk)
        _close(v, jv)


def test_packed_segments_independent(pair):
    jm, params, tm = pair
    ids = _ids(2, (1, 8))
    segs = np.asarray([[0, 0, 0, 0, 1, 1, 1, 1]], np.int32)
    packed = tm(torch.from_numpy(ids).long(), segment_ids=torch.from_numpy(segs))
    solo = tm(torch.from_numpy(ids[:, 4:]).long())
    _close(packed.logits[:, 4:], solo.logits.detach().numpy(), atol=2e-4, rtol=1e-3)
    _close(packed.logits, jm.apply(params, ids, segment_ids=segs).logits)


def test_gqa_sliding_window():
    """test_gqa_sliding_window, both parts, on the port, and the windowed
    forward and decode against JAX's."""
    jm1, params1, tm1 = _pair(seed=8, sliding_window=3, num_layers=1)
    ids = _ids(7, (1, 7))
    tids = torch.from_numpy(ids).long()
    out1 = tm1(tids)
    _close(out1.logits, jm1.apply(params1, ids).logits)
    ref1 = GQATransformer(GQAConfig(**{**CFG, "num_layers": 1}, attn_impl="kernel"),
                          device="cpu", generator=torch.Generator().manual_seed(0))
    ref1.load_state_dict(tm1.state_dict())
    for t in (4, 6):
        lo = max(0, t - 2)  # window 3: positions {t-2, t-1, t}
        sub = ref1(tids[:, lo:t + 1], position_ids=torch.arange(lo, t + 1)[None])
        _close(out1.logits[:, t], sub.logits[:, -1].detach().numpy(), atol=2e-4, rtol=1e-3)

    jm, params, tm = _pair(seed=8, sliding_window=3)
    out = tm(tids)
    caches = tm.init_cache(1, 8, torch.float32)
    tm.prefill(tm.embed_tokens(tids[:, :6]), caches)
    step = tm.decode_step(tids[:, 6:7], caches, 6)
    _close(step.logits[:, 0], out.logits[:, 6].detach().numpy(), atol=2e-4, rtol=1e-3)
    jc = jm.apply(params, 1, 8, jnp.float32, method="init_cache")
    jpre = jm.apply(params, jm.apply(params, method=lambda m: m.embed_tokens)(ids[:, :6]), jc,
                    method="prefill")
    jstep = jm.apply(params, ids[:, 6:7], jpre.caches, jnp.int32(6), method="decode_step")
    _close(step.logits, jstep.logits)


def test_greedy_generate_matches_jax(pair):
    jm, params, tm = pair
    ids = _ids(4, (2, 5))
    want = np.asarray(jax_generate(jm, params, jnp.asarray(ids), max_new_tokens=6))
    got = generate(tm, torch.from_numpy(ids).long(), max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_generate_rejected(pair):
    _, _, tm = pair
    with pytest.raises(ValueError, match="dense-GQA"):
        generate(tm, torch.ones((1, 3), dtype=torch.long), max_new_tokens=2, paged=True)


def test_mllm_with_gqa_text():
    """test_mllm_with_gqa_text (Qwen3-VL-dense compose: vision tower +
    dense-GQA text with mRoPE), held against JAX: logits with video, and
    greedy generate with video dense (1-D and 3-D positions)."""
    vis = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, patch_size=8,
               temporal_patch_size=2, spatial_merge_size=2, pos_embed_grid=6,
               deepstack_indexes=(0, 1), text_hidden_size=64)
    text = {**CFG, "mrope_section": (4, 2, 2), "head_dim": 16}
    jcfg = JMLLMConfig(vision=JVisionTowerConfig(**vis, attn_impl="xla"),
                       text=JGQAConfig(**text, attn_impl="xla"), image_token_id=94,
                       video_token_id=95)
    tcfg = MLLMConfig(vision=VisionTowerConfig(**vis, attn_impl="kernel"),
                      text=GQAConfig(**text, attn_impl="kernel"), image_token_id=94,
                      video_token_id=95)
    video = np.random.default_rng(5).standard_normal((2, 2, 16, 16, 3)).astype(np.float32)
    ids = np.full((2, 12), 7, np.int32)
    ids[:, 1:5] = 95
    ids[1, 6:] = [3, 9, 11, 2, 40, 8]
    jm = JVideoMLLM(jcfg)
    params = _visible(jm.init(jax.random.key(0), ids, video))
    tm = VideoMLLM(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(params_from_jax(params, tcfg), strict=True)
    tm.eval()
    params = {"params": params}
    tids, tvideo = torch.from_numpy(ids).long(), torch.from_numpy(video)
    out = tm(tids, tvideo)
    assert out.logits.shape == (2, 12, 97) and torch.isfinite(out.logits).all()
    _close(out.logits, jm.apply(params, ids, video).logits, atol=1e-4, rtol=1e-4)

    pos = np.broadcast_to(np.arange(12)[None, None], (3, 2, 12)).copy()
    pos[1:, :, 1:5] = [[0, 0, 1, 1], [0, 1, 0, 1]]  # a 2 x 2 grid at t = 1
    pos[:, :, 5:] -= 2
    for kw, tkw in (({}, {}), (dict(position_ids=pos), dict(position_ids=torch.from_numpy(pos)))):
        want = np.asarray(jax_generate(jm, params, ids, video=video, max_new_tokens=3, **kw))
        got = generate(tm, tids, video=tvideo, max_new_tokens=3, **tkw)
        np.testing.assert_array_equal(got.numpy(), want)


def test_preset_matches_jax():
    assert dataclasses.asdict(presets.qwen3_8b_dense()) == \
        dataclasses.asdict(jpresets.qwen3_8b_dense())
    assert presets.qwen3_8b_dense().hd == 128


def test_generate_cli_gqa_preset():
    """`cli.generate` on the dense-GQA architecture at tiny widths
    (`qwen3_dense_tiny`, qwen3_8b_dense at the JAX GQA tests' widths): the
    dense-cache tokens are the library's greedy tokens on the same seeded
    weights; `--paged` raises the dense-GQA ValueError."""
    import contextlib
    import io
    import json

    from internvideo_tpu_torch.cli.generate import main

    tiny = presets.qwen3_dense_tiny()
    jtiny = dataclasses.replace(jpresets.qwen3_8b_dense(), vocab_size=97, hidden_size=64,
                                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=None,
                                intermediate_size=128, dtype="float32",
                                param_dtype="float32", remat=False)
    assert dataclasses.asdict(tiny) == dataclasses.asdict(jtiny) and tiny.hd == 16
    argv = ["--preset", "qwen3_dense_tiny", "--ids", "1,2,3", "--max-new-tokens", "4",
            "--device", "cpu"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    tokens = json.loads(buf.getvalue().strip().splitlines()[-1])["tokens"]
    model = GQATransformer(tiny, device="cpu", generator=torch.Generator("cpu").manual_seed(0))
    want = generate(model, torch.tensor([[1, 2, 3]]), max_new_tokens=4)[0].tolist()
    assert tokens == want and all(0 <= t < 97 for t in tokens)
    with pytest.raises(ValueError, match="dense-GQA"):
        main(argv + ["--paged"])
