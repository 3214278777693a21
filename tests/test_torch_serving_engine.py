"""The continuous-batching ServingEngine of the PyTorch port: the cases of
tests/test_serving_engine.py:51-243 that need no mesh (staggered, horizon,
pool reuse, eos, oversized, admission gating, reset, submit validation,
capacity) plus seeded sampling, on the tiny_llm config with the JAX
model's weights. Tokens are held against the port's `generate`, itself
token-identical to JAX `generate` (test_torch_llm_serving.py), and in the
staggered case against JAX `generate` directly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from internvideo_tpu.models.generation import generate as jax_generate
from internvideo_tpu_torch.serve import ServingEngine
from tests.torch_llm_pair import llm_pair as _pair
from tests.torch_llm_pair import reference_tokens as _reference_tokens


def _engine(**kw):
    return ServingEngine(_pair()[2], **kw)


def test_engine_matches_generate_staggered():
    jm, params, tm = _pair()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 97, size=n).astype(np.int32) for n in (3, 5, 9, 14)]
    eng = _engine(max_batch=2, page_size=4, num_pages=32, max_len=32, prompt_buckets=(4, 8, 16))
    free0 = len(eng.alloc.free)
    rids = [eng.submit(p, 6) for p in prompts]
    outs = eng.run()
    for rid, prompt in zip(rids, prompts):
        want = np.asarray(jax_generate(jm, params, jnp.asarray(prompt)[None],
                                       max_new_tokens=6, cache_dtype=jnp.float32))[0]
        np.testing.assert_array_equal(outs[rid], want, err_msg=f"rid={rid}")
        np.testing.assert_array_equal(outs[rid], _reference_tokens(tm, prompt, 6))
    assert len(eng.alloc.free) == free0
    assert not eng.has_work()


def test_engine_horizon_matches_generate():
    tm = _pair()[2]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 97, size=n).astype(np.int32) for n in (3, 5, 9)]
    eng = _engine(max_batch=2, page_size=4, num_pages=32, max_len=32, prompt_buckets=(4, 8, 16),
                  decode_horizon=4)
    free0 = len(eng.alloc.free)
    rids = [eng.submit(p, 6) for p in prompts]  # 6 is not a multiple of the horizon
    outs = eng.run()
    for rid, prompt in zip(rids, prompts):
        np.testing.assert_array_equal(outs[rid], _reference_tokens(tm, prompt, 6))
    assert len(eng.alloc.free) == free0


def test_engine_pool_reuse_is_clean():
    tm = _pair()[2]
    rng = np.random.default_rng(1)
    eng = _engine(max_batch=2, page_size=4, num_pages=16, max_len=24, prompt_buckets=(8,))
    for wave in range(2):
        prompts = [rng.integers(1, 97, size=n).astype(np.int32) for n in (6, 8, 7)]
        rids = [eng.submit(p, 5) for p in prompts]
        outs = eng.run()
        for rid, prompt in zip(rids, prompts):
            np.testing.assert_array_equal(outs[rid], _reference_tokens(tm, prompt, 5),
                                          err_msg=f"wave {wave} rid={rid}")


def test_engine_eos_frees_slot_early():
    tm = _pair()[2]
    prompt = np.arange(1, 6, dtype=np.int32)
    ref = _reference_tokens(tm, prompt, 8)
    eng = _engine(max_batch=1, page_size=4, num_pages=16, max_len=24, prompt_buckets=(8,),
                  eos_token_id=int(ref[2]))
    free0 = len(eng.alloc.free)
    rid = eng.submit(prompt, 8)
    outs = eng.run()
    np.testing.assert_array_equal(outs[rid], ref[:3])
    assert eng.requests[rid].finished
    assert len(eng.alloc.free) == free0


def test_engine_rejects_oversized_and_unported():
    eng = _engine(max_batch=1, page_size=4, num_pages=16, max_len=16, prompt_buckets=(8,))
    with pytest.raises(ValueError):
        eng.submit(np.zeros(9, np.int32), 2)  # > largest bucket
    with pytest.raises(ValueError):
        eng.submit(np.zeros(8, np.int32), 9)  # 8 + 9 > max_len
    with pytest.raises(ValueError):
        _engine(max_len=8, prompt_buckets=(16,))
    with pytest.raises(ValueError, match="multimodal"):  # a text-only model, as in JAX
        eng.submit(np.zeros(4, np.int32), 2, video=np.zeros((2, 8, 8, 3)))
    with pytest.raises(NotImplementedError, match="item 8"):
        _engine(mesh=object())


def test_engine_admission_gated_on_pages():
    tm = _pair()[2]
    rng = np.random.default_rng(4)
    # 4 pages of 4 = 16 tokens; each request's worst case is 3 pages
    eng = _engine(max_batch=2, page_size=4, num_pages=4, max_len=16, prompt_buckets=(8,))
    free0 = len(eng.alloc.free)
    prompts = [rng.integers(1, 97, size=7).astype(np.int32) for _ in range(3)]
    rids = [eng.submit(p, 4) for p in prompts]
    outs = eng.run()
    for rid, prompt in zip(rids, prompts):
        np.testing.assert_array_equal(outs[rid], _reference_tokens(tm, prompt, 4))
    assert len(eng.alloc.free) == free0


def test_engine_reset_reuses_the_pool():
    tm = _pair()[2]
    rng = np.random.default_rng(5)
    eng = _engine(max_batch=2, page_size=4, num_pages=16, max_len=24, prompt_buckets=(8,))
    pages = eng.pages
    eng.submit(rng.integers(1, 97, size=6).astype(np.int32), 5)
    eng.run()
    eng.reset()
    assert not eng.has_work() and len(eng.alloc.free) == 16 and eng.pages is pages
    prompt = rng.integers(1, 97, size=8).astype(np.int32)
    rid = eng.submit(prompt, 5)
    np.testing.assert_array_equal(eng.run()[rid], _reference_tokens(tm, prompt, 5))


def test_engine_submit_validation():
    eng = _engine(max_batch=1, page_size=4, num_pages=2, max_len=16, prompt_buckets=(8,))
    with pytest.raises(ValueError):
        eng.submit(np.zeros(4, np.int32), 0)  # max_new_tokens < 1
    with pytest.raises(ValueError):
        eng.submit(np.zeros(7, np.int32), 4)  # worst case 3 pages > a 2-page pool


def test_engine_capacity_queues_until_pages_free():
    tm = _pair()[2]
    rng = np.random.default_rng(2)
    eng = _engine(max_batch=2, page_size=4, num_pages=8, max_len=12, prompt_buckets=(8,))
    prompts = [rng.integers(1, 97, size=7).astype(np.int32) for _ in range(3)]
    rids = [eng.submit(p, 4) for p in prompts]
    outs = eng.run()
    for rid, prompt in zip(rids, prompts):
        np.testing.assert_array_equal(outs[rid], _reference_tokens(tm, prompt, 4))


def test_engine_sampling_is_seeded_and_in_vocab():
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 97, size=n).astype(np.int32) for n in (4, 7)]
    runs = []
    for _ in range(2):
        eng = _engine(max_batch=2, page_size=4, num_pages=16, max_len=24, prompt_buckets=(8,),
                      temperature=1.0, seed=11)
        rids = [eng.submit(p, 6) for p in prompts]
        outs = eng.run()
        runs.append([outs[r] for r in rids])
        assert all(((o >= 0) & (o < 97)).all() and len(o) == 6 for o in runs[-1])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
