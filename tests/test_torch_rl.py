"""GRPO RL training in the PyTorch port (train/rl.py, train/rl_trainer.py)
vs the JAX package: the ports of tests/test_rl_trainer.py and
tests/test_quant_rl_paged.py::test_grpo that need no mesh, each held against
JAX on the same weights (models/convert.py:params_from_jax) and inputs
where JAX gives the same numbers.

  * the four rl.py functions on seeded inputs, and the loss's gradient in
    logp: 1e-6;
  * the dense-GQA policy at tests/test_torch_gqa_llm.py's widths, depth 2,
    fp32, the port on its kernel route (on the CPU the K5 family's plain
    versions, backward included): the greedy compiled rollout is
    token-identical to JAX's `_rollout`; `logp_old` within 2e-5; one update
    from the same batch matches `jax.value_and_grad(_loss_of)`: loss and
    metrics 1e-5, every gradient 5e-4 (the JAX grad bar), and the weights
    after Adam's first step, whose update is -lr g / (|g| + eps): 1e-6
    absolute (about lr x 1e-4) where |g| > 1e-4, and within 2 lr elsewhere
    (there g / |g| is the sign of a gradient near 0, which rounding may
    flip);
  * the M2LA engine rollout at temperature 0 is token-identical to the JAX
    engine rollout, and the next wave serves the updated weights;
  * port-only, as the JAX tests are: grad_accum = 4 equals the
    unaccumulated update, minibatching, the eos mask, the replay buffer,
    the temperature-mismatch refusal, the video-GRPO smoke on a tiny
    VideoMLLM, checkpoint resume mid-run equal to the uninterrupted run,
    the reward improving under a fixed generator seed, and `mesh=` raising.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from internvideo_tpu.models.llm_gqa import GQAConfig as JGQAConfig
from internvideo_tpu.models.llm_gqa import GQATransformer as JGQATransformer
from internvideo_tpu.serve import ServingEngine as JServingEngine
from internvideo_tpu.train import rl as jrl
from internvideo_tpu.train.rl_trainer import RLTrainer as JRLTrainer
from internvideo_tpu.train.rl_trainer import RLTrainerConfig as JRLTrainerConfig
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.models.generation import generate
from internvideo_tpu_torch.models.llm import LLMConfig, MLATransformer
from internvideo_tpu_torch.models.llm_gqa import GQAConfig, GQATransformer
from internvideo_tpu_torch.models.mllm import MLLMConfig, VideoMLLM
from internvideo_tpu_torch.models.vision_tower import VisionTowerConfig
from internvideo_tpu_torch.nn.mla import MLAConfig
from internvideo_tpu_torch.serve import ServingEngine
from internvideo_tpu_torch.train import rl
from internvideo_tpu_torch.train.rl_trainer import ReplayBuffer, RLTrainer, RLTrainerConfig
from tests.torch_llm_pair import CONFIGS, JLLMConfig, JMLAConfig, JMLATransformer

TARGET = 3  # reward = the share of generated tokens equal to this id
# tests/test_torch_gqa_llm.py's widths at depth 2
GQA = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
           intermediate_size=128, qk_norm=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These policies are a few thousand weights: torch's intra-op thread
    pool only adds synchronisation to each of the loops' many tiny ops,
    which under parallel test workers costs more than the ops themselves
    (test_rl_reward_improves: 0.7 s alone, 36 s in a loaded 6-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reward(prompt_ids, response_ids):
    return float(np.mean(response_ids == TARGET))


def _tiny_mla(seed=0):
    """tests/test_rl_trainer.py's tiny M2LA policy (vocab 16), seeded."""
    cfg = LLMConfig(vocab_size=16, hidden_size=32, num_layers=2, intermediate_size=64,
                    mrope_section=None,
                    mla=MLAConfig(hidden_size=32, num_heads=2, kv_lora_rank=16,
                                  q_lora_rank=None, qk_rope_head_dim=8, qk_nope_head_dim=8,
                                  v_head_dim=8))
    return MLATransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))


def _prompts(rows=4):
    return np.tile(np.arange(4, dtype=np.int32)[None], (rows, 1))


# ---- rl.py ------------------------------------------------------------------


def test_grpo_functions_match_jax():
    """test_grpo's checks, and each function against JAX on the same
    inputs: advantages (population std), token log-probs, the loss and its
    metrics with a KL reference, and d loss / d logp."""
    rng = np.random.default_rng(0)
    rewards = np.array([1.0, 0.0, 1.0, 0.0, 5.0, 5.0, 5.0, 5.0], np.float32)
    adv = rl.group_relative_advantages(torch.from_numpy(rewards), 4)
    np.testing.assert_allclose(adv[4:].numpy(), 0.0, atol=1e-3)
    assert float(adv[0]) > 0 > float(adv[1])
    np.testing.assert_allclose(
        adv.numpy(), np.asarray(jrl.group_relative_advantages(jnp.asarray(rewards), 4)),
        atol=1e-6, rtol=1e-6)

    logits = rng.standard_normal((8, 5, 11)).astype(np.float32)
    tokens = rng.integers(0, 11, (8, 5)).astype(np.int32)
    logp = rl.token_logprobs(torch.from_numpy(logits), torch.from_numpy(tokens))
    assert logp.shape == (8, 5) and float(logp.max()) <= 0
    np.testing.assert_allclose(logp.numpy(),
                               np.asarray(jax.jit(jrl.token_logprobs)(logits, tokens)),
                               atol=1e-6, rtol=1e-6)

    lp = logp.numpy()
    old = lp - rng.uniform(-0.4, 0.4, lp.shape).astype(np.float32)  # some ratios clip
    ref = lp + rng.uniform(-0.2, 0.2, lp.shape).astype(np.float32)
    mask = (rng.uniform(size=lp.shape) > 0.3).astype(np.float32)
    a = rng.standard_normal(8).astype(np.float32)
    cfg, jcfg = rl.GRPOConfig(kl_beta=0.1), jrl.GRPOConfig(kl_beta=0.1)
    loss, m = rl.grpo_policy_loss(*(torch.from_numpy(x) for x in (lp, old, a, mask)), cfg,
                                  logp_ref=torch.from_numpy(ref))
    jloss, jm = jax.jit(lambda *x: jrl.grpo_policy_loss(*x, jcfg, logp_ref=ref))(lp, old, a, mask)
    assert np.isfinite(float(loss)) and float(m["kl"]) >= 0 and 0 < float(m["clip_frac"]) < 1
    for got, want in [(loss, jloss)] + [(m[k], jm[k]) for k in ("ratio_mean", "clip_frac", "kl")]:
        np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=1e-6)

    tl = torch.from_numpy(lp).requires_grad_()
    g = torch.autograd.grad(rl.grpo_policy_loss(tl, torch.from_numpy(old), torch.from_numpy(a),
                                                torch.from_numpy(mask), cfg,
                                                logp_ref=torch.from_numpy(ref))[0], tl)[0]
    jg = jax.jit(jax.grad(lambda x: jrl.grpo_policy_loss(x, old, a, mask, jcfg,
                                                         logp_ref=ref)[0]))(lp)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6, rtol=1e-6)
    # minimising the loss raises logp where the advantage is positive
    g0 = torch.autograd.grad(rl.grpo_policy_loss(tl, logp, adv, torch.ones(8, 5),
                                                 rl.GRPOConfig())[0], tl)[0]
    assert float(g0[0].sum()) < 0


# ---- the dense-GQA policy against the JAX trainer ---------------------------


@pytest.fixture(scope="module")
def gqa():
    """(JAX model, its params, a port GQATransformer factory on them)."""
    jm = JGQATransformer(JGQAConfig(**GQA, attn_impl="xla"))
    params = jax.device_get(fnn.unbox(jax.jit(jm.init)(jax.random.key(0),
                                                       jnp.zeros((1, 8), jnp.int32))))
    params["params"]["lm_head"]["kernel"] = params["params"]["lm_head"]["kernel"] * 25
    tcfg = GQAConfig(**GQA, attn_impl="kernel")

    def port():
        tm = GQATransformer(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
        tm.load_state_dict(params_from_jax(params, tcfg), strict=True)
        return tm

    return jm, params, tcfg, port


def _assert_adam_step_close(got, want, grad, lr, what):
    """Weights after one Adam step from the same start: the first step
    moves each weight by -lr g / (|g| + eps), so rounding noise in a
    gradient near 0 can flip its whole lr-sized step. Where |g| > 1e-4 the
    weights agree to 1e-6 (about lr x 1e-4); everywhere within 2 lr."""
    delta = np.abs(got - want)
    sure = np.abs(grad) > 1e-4
    assert (delta[sure] <= 1e-6 + 1e-6 * np.abs(want[sure])).all(), what
    assert (delta <= 2 * lr).all(), what


def _batch_to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_gqa_rollout_logp_and_update_match_jax(gqa):
    jm, params, tcfg, port = gqa
    kw = dict(max_new_tokens=6, rollout_temperature=0.0, lr=1e-2, cache_dtype="float32")
    jtr = JRLTrainer(jm, params, JRLTrainerConfig(grpo=jrl.GRPOConfig(group_size=2,
                                                                      kl_beta=0.05), **kw),
                     _reward)
    tm = port()
    ttr = RLTrainer(tm, RLTrainerConfig(grpo=rl.GRPOConfig(group_size=2, kl_beta=0.05), **kw),
                    _reward)
    prompts = np.random.default_rng(1).integers(1, 90, (4, 5)).astype(np.int32)
    # greedy compiled rollout: token-identical
    want = np.asarray(jtr._rollout(params, jnp.asarray(prompts), jax.random.key(0)))
    got = ttr._rollout(torch.from_numpy(prompts).long(), None).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 2  # the greedy path is not degenerate

    # logp_old under the rollout-time weights
    full = np.concatenate([prompts, want], axis=1)
    jlogp = np.asarray(jtr._logp(params, jnp.asarray(full)))
    from internvideo_tpu_torch.train.rl_trainer import sequence_logprobs

    with torch.no_grad():
        tlogp = sequence_logprobs(tm, torch.from_numpy(full).long(), head_rows=2)
    np.testing.assert_allclose(tlogp.numpy(), jlogp, atol=2e-5, rtol=0)

    # one update from one batch: logp_old off the current policy (ratios
    # clip), a reference policy away from it (the KL term is live)
    rng = np.random.default_rng(2)
    mask = np.zeros(jlogp.shape, np.float32)
    mask[:, 4:] = 1.0
    mask[1, 8:] = 0.0  # an eos-truncated row
    batch = {"full_ids": full.astype(np.int32),
             "logp_old": (jlogp + rng.uniform(-0.3, 0.3, jlogp.shape)).astype(np.float32),
             "advantages": rng.standard_normal(4).astype(np.float32), "mask": mask}
    ref_params = jax.tree.map(lambda x: x + 0.02 * np.sign(x), params)
    ttr.ref_model.load_state_dict(params_from_jax(ref_params, tcfg), strict=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jtr._loss_of, has_aux=True))(
        params, jb, ref_params)
    updates, _ = jax.jit(jtr.tx.update)(jgrads, jtr.opt_state, params)  # optax.adam (:128)
    jnew = optax.apply_updates(params, updates)
    tb = _batch_to_torch(batch)
    tb["full_ids"] = tb["full_ids"].long()
    met = ttr._minibatch_update(tb)
    assert 0 < met["clip_frac"] < 1 and met["kl"] > 0
    for k, v in dict(jmet, loss=jloss).items():
        np.testing.assert_allclose(met[k], float(v), atol=1e-5, rtol=1e-5, err_msg=k)
    want_g = params_from_jax(jax.device_get(jgrads), tcfg)
    want_p = params_from_jax(jax.device_get(jnew), tcfg)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), atol=5e-4, rtol=5e-4,
                                   err_msg=name)
        _assert_adam_step_close(p.detach().numpy(), want_p[name].numpy(), want_g[name].numpy(),
                                kw["lr"], name)


def test_gqa_policy_trains(gqa):
    """The rollout <-> train loop drives the dense-GQA policy (JAX
    test_rl_trainer_with_gqa_model), with grad accumulation over its
    backward."""
    tm = gqa[3]()
    cfg = RLTrainerConfig(grpo=rl.GRPOConfig(group_size=2, kl_beta=0.01), max_new_tokens=4,
                          lr=1e-2, grad_accum=2)
    history = RLTrainer(tm, cfg, lambda p, r: 1.0).fit(lambda i: _prompts(2), iterations=2)
    assert len(history) == 2 and np.isfinite(history[-1]["loss"])


# ---- the M2LA engine rollout against the JAX engine -------------------------


def test_engine_rollout_matches_jax_and_sees_updates():
    # tests/torch_llm_pair.py's tiny_llm pair, the JAX init jitted
    spec = dict(CONFIGS["tiny_llm"])
    mla = spec.pop("mla")
    jm = JMLATransformer(JLLMConfig(**spec, mla=JMLAConfig(**mla), attn_impl="xla"))
    params = jax.device_get(fnn.unbox(jax.jit(jm.init)(jax.random.key(0),
                                                       jnp.zeros((1, 8), jnp.int32))))
    tcfg = LLMConfig(**spec, mla=MLAConfig(**mla), attn_impl="kernel")
    tm = MLATransformer(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(params_from_jax(params, tcfg), strict=True)
    ekw = dict(max_batch=4, page_size=4, num_pages=64, max_len=16, prompt_buckets=(4,),
               temperature=0.0)
    cfg = dict(max_new_tokens=6, rollout_temperature=0.0, lr=3e-2)
    jtr = JRLTrainer(jm, params, JRLTrainerConfig(grpo=jrl.GRPOConfig(group_size=2), **cfg),
                     _reward, engine=JServingEngine(jm, params, **ekw))
    eng = ServingEngine(tm, **ekw)
    ttr = RLTrainer(tm, RLTrainerConfig(grpo=rl.GRPOConfig(group_size=2), **cfg), _reward,
                    engine=eng)
    expanded = np.repeat(np.random.default_rng(3).integers(1, 90, (3, 4)), 2, 0).astype(np.int32)
    want, wlen = jtr._engine_rollout(expanded, None)
    got, glen = ttr._engine_rollout(expanded, None)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(glen, wlen)
    # one update (greedy groups are identical, so the advantages are set by
    # hand), then the next wave serves the updated weights
    ttr.rollout_step(expanded[::2])
    ttr.buffer.items[0]["advantages"] = torch.tensor([1.0, -1.0] * 3)
    ttr.train_step()
    again, _ = ttr._engine_rollout(expanded, None)
    for row, ids in enumerate(expanded):
        np.testing.assert_array_equal(
            again[row], generate(tm, torch.from_numpy(ids).long()[None], max_new_tokens=6)[0])
    assert (again != got).any()


# ---- port-only cases of tests/test_rl_trainer.py ----------------------------


def test_replay_buffer():
    buf = ReplayBuffer()
    buf.add({"a": torch.ones(2)})
    buf.add({"a": torch.zeros(2)})
    assert len(buf) == 2
    items = buf.drain()
    assert len(items) == 2 and len(buf) == 0


def test_rl_reward_improves():
    cfg = RLTrainerConfig(grpo=rl.GRPOConfig(group_size=4, kl_beta=0.01), max_new_tokens=8,
                          rollout_temperature=1.0, ppo_epochs=2, lr=3e-2)
    trainer = RLTrainer(_tiny_mla(), cfg, _reward)
    history = trainer.fit(lambda i: _prompts(), iterations=12, seed=0)
    first = np.mean([h["reward_mean"] for h in history[:3]])
    last = np.mean([h["reward_mean"] for h in history[-3:]])
    assert last > first + 0.1, (first, last)
    kls = [h["kl"] for h in history]
    assert all(np.isfinite(k) for k in kls) and max(kls) < 50.0


def test_rl_eos_mask():
    """eos truncation: the mask covers response tokens up to and including
    the first eos."""
    cfg = RLTrainerConfig(grpo=rl.GRPOConfig(group_size=2), max_new_tokens=6, eos_token_id=0)
    trainer = RLTrainer(_tiny_mla(), cfg, lambda p, r: 1.0)
    trainer.rollout_step(np.ones((2, 3), np.int32), torch.Generator().manual_seed(1))
    batch = trainer.buffer.items[0]
    lp, hit = 3, False
    for row in range(batch["full_ids"].shape[0]):
        gen = batch["full_ids"][row, lp:].numpy()
        hits = np.nonzero(gen == 0)[0]
        hit |= bool(hits.size)
        end = (int(hits[0]) + 1) if hits.size else len(gen)
        expect = np.zeros(batch["mask"].shape[1], np.float32)
        expect[lp - 1:lp - 1 + end] = 1.0
        np.testing.assert_array_equal(batch["mask"][row].numpy(), expect)
    assert hit  # at least one row is truncated


def test_rl_engine_temperature_mismatch_rejected():
    model = _tiny_mla()
    eng = ServingEngine(model, max_batch=2, page_size=4, num_pages=16, max_len=16,
                        prompt_buckets=(4,), temperature=0.7)
    with pytest.raises(ValueError, match="temperature"):
        RLTrainer(model, RLTrainerConfig(rollout_temperature=1.0), lambda p, r: 1.0, engine=eng)
    with pytest.raises(ValueError, match="model"):
        RLTrainer(_tiny_mla(), RLTrainerConfig(rollout_temperature=0.7), lambda p, r: 1.0,
                  engine=eng)
    with pytest.raises(NotImplementedError, match="item 8"):
        RLTrainer(model, RLTrainerConfig(), lambda p, r: 1.0, mesh=object())


def test_rl_grad_accum_exact_parity():
    """grad_accum = 4 gives the unaccumulated update: the mask-weighted
    combine rebuilds the token-mean loss's whole-batch gradient (exact in
    real arithmetic; fp32 summation order leaves ~1e-7 relative), and the
    weights after Adam's first step agree as `_assert_adam_step_close`
    states."""
    cfg = dict(grpo=rl.GRPOConfig(group_size=4, kl_beta=0.05), max_new_tokens=6, lr=1e-2)
    a = RLTrainer(_tiny_mla(), RLTrainerConfig(**cfg), _reward)
    b = RLTrainer(_tiny_mla(), RLTrainerConfig(**cfg, grad_accum=4), _reward)
    a.rollout_step(_prompts(), torch.Generator().manual_seed(1))
    b.buffer.add({k: v.clone() for k, v in a.buffer.items[0].items()})
    ma, mb = a.train_step(), b.train_step()
    for k in ma:
        assert abs(ma[k] - mb[k]) < 1e-6, (k, ma[k], mb[k])
    for (n, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        np.testing.assert_allclose(pb.grad.numpy(), pa.grad.numpy(), atol=1e-8, rtol=1e-5,
                                   err_msg=n)
        _assert_adam_step_close(pb.detach().numpy(), pa.detach().numpy(), pa.grad.numpy(),
                                1e-2, n)


def test_rl_minibatch_updates():
    """minibatch_size 8 splits 16 rows into 2 updates; a bad split raises."""
    cfg = RLTrainerConfig(grpo=rl.GRPOConfig(group_size=4), max_new_tokens=6, lr=1e-2,
                          minibatch_size=8)
    tr = RLTrainer(_tiny_mla(), cfg, _reward)
    calls, orig = [], tr._minibatch_update

    def spy(sub):
        calls.append(sub["full_ids"].shape[0])
        return orig(sub)

    tr._minibatch_update = spy
    tr.rollout_step(_prompts(), torch.Generator().manual_seed(1))
    tr.train_step()
    assert calls == [8, 8]
    bad = RLTrainer(_tiny_mla(), dataclasses.replace(cfg, minibatch_size=5), _reward)
    bad.rollout_step(_prompts(), torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="minibatch_size"):
        bad.train_step()


def test_rl_checkpoint_resume_mid_run(tmp_path):
    """fit() with checkpoint_dir saves (weights, optimizer, iteration,
    generator); a fresh trainer resuming there finishes the schedule with
    the uninterrupted run's exact weights and rewards."""
    cfg = RLTrainerConfig(grpo=rl.GRPOConfig(group_size=4, kl_beta=0.01), max_new_tokens=6,
                          lr=1e-2)
    ckpt = str(tmp_path / "rl_ckpt")
    tr1 = RLTrainer(_tiny_mla(), cfg, _reward)
    h1 = tr1.fit(lambda i: _prompts(), iterations=2, seed=0, checkpoint_dir=ckpt,
                 checkpoint_every=1)
    assert len(h1) == 2 and tr1._iter == 2
    tr2 = RLTrainer(_tiny_mla(), cfg, _reward)
    h2 = tr2.fit(lambda i: _prompts(), iterations=4, seed=0, checkpoint_dir=ckpt)
    assert [h["iter"] for h in h2] == [2, 3] and tr2._iter == 4
    tr3 = RLTrainer(_tiny_mla(), cfg, _reward)
    h3 = tr3.fit(lambda i: _prompts(), iterations=4, seed=0)
    for pa, pb in zip(tr2.model.parameters(), tr3.model.parameters()):
        assert torch.equal(pa, pb)
    assert h2[-1]["reward_mean"] == h3[-1]["reward_mean"]


def test_rl_video_grpo_smoke():
    """Video-prompt GRPO (a VideoMLLM policy through the engine's video
    prefill): the loop closes, the loss is finite, the buffer carries
    pixels; the compiled backend refuses video prompts."""
    cfg = MLLMConfig(
        vision=VisionTowerConfig(hidden_size=16, num_layers=1, num_heads=2,
                                 intermediate_size=32, patch_size=8, temporal_patch_size=2,
                                 spatial_merge_size=2, pos_embed_grid=4, deepstack_indexes=(0,),
                                 text_hidden_size=32),
        text=LLMConfig(vocab_size=32, hidden_size=32, num_layers=1, intermediate_size=64,
                       mrope_section=None,
                       mla=MLAConfig(hidden_size=32, num_heads=2, kv_lora_rank=16,
                                     qk_rope_head_dim=8, qk_nope_head_dim=8, v_head_dim=8)),
        image_token_id=30, video_token_id=31)
    model = VideoMLLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    videos = np.random.default_rng(0).standard_normal((2, 2, 16, 16, 3)).astype(np.float32)
    prompts = np.full((2, 6), 5, np.int32)
    prompts[:, 1:5] = 31  # 4 merged visual tokens
    rl_cfg = RLTrainerConfig(grpo=rl.GRPOConfig(group_size=2), max_new_tokens=4, lr=1e-2)
    eng = ServingEngine(model, max_batch=2, page_size=4, num_pages=32, max_len=16,
                        prompt_buckets=(8,), temperature=1.0, seed=5)
    trainer = RLTrainer(model, rl_cfg, _reward, engine=eng)
    history = trainer.fit(lambda i: (prompts, videos), iterations=2, seed=0)
    assert len(history) == 2 and np.isfinite(history[-1]["loss"])
    trainer.rollout_step(prompts, videos=videos)
    assert trainer.buffer.items[0]["video"].shape == (4, 2, 16, 16, 3)
    plain = RLTrainer(VideoMLLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0)),
                      rl_cfg, _reward)
    with pytest.raises(ValueError, match="engine"):
        plain.rollout_step(prompts, videos=videos)
