"""Multimodal serving of the PyTorch port vs the JAX package: HiCo
compression, the video prefill (dense and paged), decode with explicit
mRoPE positions, and the engine's `video=` (ports of tests/test_mllm.py's
serving tests).

The VideoMLLM pair is tests/torch_mllm_pair.py's (the sft_tiny widths, the
same JAX weights loaded with strict=True, the lm_head scaled up so greedy
tokens are decided by clear margins). The port runs its kernel route (on
the CPU the kernels' plain versions: K2 in the tower, K5 in the prefill, K6
in the paged decode), JAX its XLA route. HiCo is the JAX package's own
formulation, so JAX is its only reference: fp32, 1e-5. Logits 2e-4 (the
tower and the deepstack residuals add up rounding, as in
test_torch_mllm.py); greedy tokens identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internvideo_tpu.models.generation import generate as jax_generate
from internvideo_tpu.models.mllm import VideoMLLM as JVideoMLLM
from internvideo_tpu.models.mllm import hico_compress as jax_hico
from internvideo_tpu.serve.engine import ServingEngine as JServingEngine
from internvideo_tpu_torch.models import presets
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.models.generation import generate
from internvideo_tpu_torch.models.mllm import VideoMLLM, hico_compress
from internvideo_tpu_torch.serve import ServingEngine
from tests.torch_mllm_pair import mllm_pair

IDS = np.array([[5, 251, 251, 251, 251, 7, 9]])  # one 2 x 2 merged frame of 4 tokens


@pytest.fixture(scope="module")
def pair():
    return mllm_pair()


def _video(seed, shape=(1, 2, 32, 32, 3)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_hico_compress_matches_jax():
    toks = np.random.default_rng(0).standard_normal((2, 4, 64, 16)).astype(np.float32)
    got = hico_compress(torch.from_numpy(toks), 16)
    assert got.shape == (2, 4, 16, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_hico(jnp.asarray(toks), 16)),
                               atol=1e-5, rtol=1e-5)
    # identical tokens compress to (approximately) that token
    same = hico_compress(torch.ones(1, 1, 64, 16), 8)
    np.testing.assert_allclose(same.numpy(), 1.0, rtol=1e-4)
    np.testing.assert_allclose(same.numpy(), np.asarray(jax_hico(jnp.ones((1, 1, 64, 16)), 8)),
                               atol=1e-5, rtol=1e-5)


def test_hico_compress_quality():
    """tests/test_mllm.py::test_hico_compress_quality on the port: the
    compressed tokens cover every cluster, and they rank clip pairs like
    the full tokens do, better than random subsets."""
    rng = np.random.RandomState(0)
    d, n, k_true = 16, 64, 8
    centers = rng.randn(k_true, d) * 3

    def make_clip(jitter):
        return (centers[rng.randint(0, k_true, n)] + rng.randn(n, d) * jitter).astype(np.float32)

    def recon_err(budget):
        comp = hico_compress(torch.from_numpy(make_clip(0.1)[None, None]), budget)[0, 0].numpy()
        return float(np.linalg.norm(centers[:, None] - comp[None], axis=-1).min(axis=1).mean())

    e16, e4 = recon_err(16), recon_err(4)
    assert e16 < 1.5, e16
    assert e4 >= e16 * 0.8

    clips = [make_clip(0.2) for _ in range(8)]
    full = np.stack([c.mean(0) for c in clips])
    full /= np.linalg.norm(full, axis=-1, keepdims=True)
    comp_toks = hico_compress(torch.from_numpy(np.stack(clips)[:, None]), 8)[:, 0].numpy()
    comp = np.zeros((8, d))
    for ci, (toks, cc) in enumerate(zip(clips, comp_toks)):
        assign = np.argmin(np.linalg.norm(toks[:, None] - cc[None], axis=-1), axis=1)
        w = np.bincount(assign, minlength=cc.shape[0]).astype(np.float64)
        comp[ci] = (cc * w[:, None]).sum(0) / w.sum()
    comp /= np.linalg.norm(comp, axis=-1, keepdims=True)
    rnd = np.stack([c[rng.choice(n, 2, replace=False)].mean(0) for c in clips])
    rnd /= np.linalg.norm(rnd, axis=-1, keepdims=True)
    iu = np.triu_indices(8, 1)
    corr_comp = np.corrcoef((full @ full.T)[iu], (comp @ comp.T)[iu])[0, 1]
    corr_rnd = np.corrcoef((full @ full.T)[iu], (rnd @ rnd.T)[iu])[0, 1]
    assert corr_comp > 0.95, corr_comp
    assert corr_comp > corr_rnd, (corr_comp, corr_rnd)


def test_mllm_hico_video_path(pair):
    """test_mllm_hico_video_path: HiCo-R2 compresses the merged tokens of
    the one temporal frame to 2 placeholders, the deepstack taps are off;
    logits and greedy tokens against JAX on the same weights."""
    jcfg, _, params, tcfg, tm = pair
    jcfg, tcfg = (dataclasses.replace(c, hico_tokens_per_frame=2) for c in (jcfg, tcfg))
    jm = JVideoMLLM(jcfg)
    hm = VideoMLLM(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    hm.load_state_dict(tm.state_dict())
    ids, video = np.array([[5, 251, 251, 7, 9]]), _video(4)
    tids, tvideo = torch.from_numpy(ids), torch.from_numpy(video)
    visual, taps = hm.encode_video(tvideo)
    assert visual.shape == (1, 2, 48) and taps == []
    out = hm(tids, tvideo)
    assert out.logits.shape == (1, 5, 256) and torch.isfinite(out.logits).all()
    want = jm.apply({"params": params}, ids, video)
    np.testing.assert_allclose(out.logits.detach().numpy(), np.asarray(want.logits),
                               atol=2e-4, rtol=2e-4)
    assert (hm(tids, tvideo + 1.0).logits - out.logits).abs().max() > 1e-3
    gen = generate(hm, tids, video=tvideo, max_new_tokens=3)
    np.testing.assert_array_equal(
        gen.numpy(), np.asarray(jax_generate(jm, {"params": params}, ids, video=video,
                                             max_new_tokens=3)))


def test_mllm_paged_generate_matches_dense(pair):
    """Paged video generate (the pools, then plain or kernel-route paged
    decode) is token-identical to the dense-cache generate, deepstack
    residuals included; and both to JAX's dense generate."""
    _, jm, params, _, tm = pair
    video = _video(2)
    tids, tvideo = torch.from_numpy(IDS), torch.from_numpy(video)
    dense = generate(tm, tids, video=tvideo, max_new_tokens=5)
    for impl in ("xla", "kernel"):
        paged = generate(tm, tids, video=tvideo, max_new_tokens=5, paged=True, page_size=4,
                         decode_impl=impl)
        np.testing.assert_array_equal(dense.numpy(), paged.numpy())
    want = jax_generate(jm, {"params": params}, IDS, video=video, max_new_tokens=5)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(want))


def test_generate_with_mrope_positions_matches_full_forward(pair):
    """generate(position_ids=3-D grid) prefills and decodes with the grid
    (decode continues at max + 1), matching teacher-forced full forwards
    with the same positions, and JAX's generate."""
    _, jm, params, _, tm = pair
    video = _video(2)
    tvideo = torch.from_numpy(video)
    vis = np.array([[0, 0, 0, 0], [0, 0, 1, 1], [0, 1, 0, 1]])
    base = (vis + 1).max() + 1
    text = np.broadcast_to(base + np.arange(2), (3, 2))
    pos = np.concatenate([np.zeros((3, 1), np.int64), vis + 1, text], axis=1)[:, None]
    gen = generate(tm, torch.from_numpy(IDS), video=tvideo, position_ids=torch.from_numpy(pos),
                   max_new_tokens=3)
    cur, cur_pos, expected = torch.from_numpy(IDS), torch.from_numpy(pos), []
    with torch.no_grad():
        for _ in range(3):
            nxt = tm(cur, tvideo, position_ids=cur_pos).logits[:, -1].argmax(-1)
            expected.append(int(nxt[0]))
            cur = torch.cat([cur, nxt[:, None]], dim=1)
            cur_pos = torch.cat([cur_pos, torch.full((3, 1, 1), int(cur_pos.max()) + 1)], dim=2)
    assert gen[0].tolist() == expected
    want = jax_generate(jm, {"params": params}, IDS, video=video, position_ids=jnp.asarray(pos),
                        max_new_tokens=3)
    assert gen[0].tolist() == np.asarray(want)[0].tolist()
    with pytest.raises(NotImplementedError, match="position_ids"):
        generate(tm, torch.from_numpy(IDS), video=tvideo, position_ids=torch.from_numpy(pos),
                 max_new_tokens=2, paged=True)


def test_engine_serves_video_requests(pair):
    """The engine's video path: video and text requests mixed in one decode
    batch (bucket padding, sampling at the last real token, text and video
    slots side by side). Each request's tokens are identical to JAX's
    ServingEngine on the same weights and requests, and to the port's paged
    `generate` of its prompt alone."""
    _, jm, params, _, tm = pair
    videos = [_video(10 + i) for i in range(3)]
    reqs = [(IDS[0], videos[0], 6), (np.array([3, 4, 5, 6]), None, 4),
            (np.array([8, 251, 251, 251, 251, 2]), videos[1], 5),
            (np.array([9, 251, 251, 251, 251]), videos[2], 3), (np.array([7, 7]), None, 5)]
    kw = dict(max_batch=2, page_size=4, num_pages=48, max_len=24, prompt_buckets=(8, 16))
    eng = ServingEngine(tm, **kw)
    rids = [eng.submit(p, n, video=None if v is None else v[0]) for p, v, n in reqs]
    out = eng.run()
    jeng = JServingEngine(jm, {"params": params}, impl="xla", **kw)
    jrids = [jeng.submit(p, n, video=None if v is None else v[0]) for p, v, n in reqs]
    jout = jeng.run()
    for rid, jrid in zip(rids, jrids):
        np.testing.assert_array_equal(out[rid], jout[jrid])
    for rid, (prompt, video, n) in zip(rids, reqs):
        want = generate(tm, torch.from_numpy(prompt)[None].long(),
                        video=None if video is None else torch.from_numpy(video),
                        max_new_tokens=n, paged=True, page_size=4)[0].numpy()
        np.testing.assert_array_equal(out[rid], want)


def test_hico_preset_matches_jax():
    from internvideo_tpu.models import presets as jpresets

    assert dataclasses.asdict(presets.internvideo25_hico_2b()) == \
        dataclasses.asdict(jpresets.internvideo25_hico_2b())
    dense = dataclasses.replace(presets.internvideo3_8b(), text=presets.qwen3_8b_dense())
    jdense = dataclasses.replace(jpresets.internvideo3_8b(), text=jpresets.qwen3_8b_dense())
    assert dataclasses.asdict(dense) == dataclasses.asdict(jdense)
    assert params_from_jax is not None
