"""VideoCLIP stage-2 training in the PyTorch port vs the JAX package, on the
CPU, at configs/clip_tiny.py's and configs/clip_stage2_tiny.py's widths.

Same params (JAX `init(init_all_branches=True)` -> `params_from_jax` ->
`load_state_dict(strict=True)`, every LayerScale gamma at 0.1), same
numpy inputs, same draws: the JAX key is split as the JAX `loss_fn` splits
it, the keep indices, VTM negatives and MLM corruption drawn with it by the
JAX functions and passed into the port's `clip_loss`. Held: `get_sim`,
`_idx_targets`, `vtc_loss`, `mlm_loss_from_logits` at 1e-6; each loss term
of JAX's own `loss_fn` at 1e-5 relative and every parameter's gradient at
5e-4; the bicubic resize against `jax.image.resize` at 1e-5; one optimizer
step with `uta=0`, after which the CLIP-align decoders that no loss reaches
equal JAX's (optax decays them). `mlm_corrupt` and `mine_negatives` are
held to their contracts (torch cannot reproduce JAX's random streams). The
tiny CLIs run on the CPU; the configs mirror the JAX ones.
"""

import dataclasses
import io
import math
import os
from contextlib import redirect_stdout

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import internvideo_tpu.train.engines.clip as jclip
from internvideo_tpu.core.config import config_to_dict as jax_to_dict
from internvideo_tpu.core.config import load_config as jax_load_config
from internvideo_tpu.models.teachers import CLIPTeacher as JaxCLIPTeacher
from internvideo_tpu.models.videoclip import VideoCLIP as JaxVideoCLIP
from internvideo_tpu.train.optim import build_optimizer as jax_build_optimizer
from internvideo_tpu.train.state import TrainState as JaxTrainState
from internvideo_tpu_torch.cli import train as cli
from internvideo_tpu_torch.core.config import apply_overrides, config_to_dict, load_config
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.models.teachers import CLIPTeacher
from internvideo_tpu_torch.models.videoclip import VideoCLIP
from internvideo_tpu_torch.train.engines import clip as tclip
from internvideo_tpu_torch.train.optim import build_optimizer

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = ("clip_tiny", "clip_stage2_tiny")


def _np(tree):
    return jax.tree.map(np.asarray, flax_nn.unbox(tree))


def _gammas(tree, value=0.1):
    """LayerScale gammas at `value`, so that every block moves the output."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, value) if k == "gamma" else _gammas(v, value))
                for k, v in tree.items()}
    return tree


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _batch(run, seed):
    v, b = run.model.vision, run.data["batch_size"]
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 1000, (b, run.data["text_len"])).astype(np.int32)
    ids[:, 0] = 101  # CLS, never masked
    mask = np.ones_like(ids)
    mask[1::2, -3:] = 0  # ragged texts: pads
    ids = ids * mask
    return {"video": rng.standard_normal((b, v.num_frames, v.img_size, v.img_size, 3))
            .astype(np.float32),
            "input_ids": ids, "attention_mask": mask,
            "idx": np.array([0, 0, 1, 2, 3, 3, 4, 5], np.int32)[:b]}


@pytest.fixture(scope="module", params=CONFIGS)
def pair(request):
    """One tiny recipe in both packages: the JAX model, params and teacher,
    the port's model and teacher loaded from them, a batch."""
    name = request.param
    jrun = jax_load_config(os.path.join(ROOT, "configs", f"{name}.py"))
    trun = load_config(os.path.join(ROOT, "configs", "torch", f"{name}.py"))
    batch = _batch(trun, 1)
    jmodel = JaxVideoCLIP(jrun.model)
    params = _gammas(_np(jax.jit(lambda v, i, m: jmodel.init(
        jax.random.key(0), v, i, m, init_all_branches=True))(
        batch["video"], batch["input_ids"], batch["attention_mask"])))
    model = VideoCLIP(trun.model, device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(params, trun.model), strict=True)
    jteacher = tparams = teacher = None
    if trun.engine.uta > 0:
        jteacher = JaxCLIPTeacher(jrun.teacher)
        tparams = _np(jax.jit(jteacher.init)(jax.random.key(1), batch["video"]))
        teacher = CLIPTeacher(trun.teacher, device="cpu",
                              generator=torch.Generator().manual_seed(1))
        teacher.load_state_dict(params_from_jax(tparams), strict=True)
        teacher.requires_grad_(False).eval()
    return dict(name=name, jrun=jrun, trun=trun, batch=batch, jmodel=jmodel, params=params,
                model=model, jteacher=jteacher, tparams=tparams, teacher=teacher)


def _jax_loss_fn(jmodel, cfg, jteacher, tparams):
    """The JAX engine's own loss_fn(params, batch, rng), taken from
    make_clip_train_step."""
    orig = jclip.make_accum_step
    jclip.make_accum_step = lambda loss_fn, grad_accum=1: loss_fn
    try:
        return jclip.make_clip_train_step(jmodel, cfg, clip_teacher=jteacher,
                                          teacher_params=tparams)
    finally:
        jclip.make_accum_step = orig


def _jax_draws(p, cfg, rng):
    """The keep indices, VTM negatives and MLM corruption that JAX's loss_fn
    draws from `rng`."""
    batch, jmodel, params = p["batch"], p["jmodel"], p["params"]
    r_neg, r_mlm, _, r_mask = jax.random.split(rng, 4)
    keep = None
    if cfg.uta > 0:
        keep, _, _ = jclip._teacher_targets_and_mask(
            p["jteacher"], p["tparams"], batch["video"], r_mask, cfg)
    out = jmodel.apply(params, batch["video"], batch["input_ids"], batch["attention_mask"],
                       keep_indices=keep)
    vis_neg, txt_neg = jclip.mine_negatives(r_neg, out.vision_proj, out.text_proj,
                                            jnp.asarray(batch["idx"]), out.temp,
                                            cfg.vtm_hard_neg)
    corrupted, labels = jclip.mlm_corrupt(r_mlm, jnp.asarray(batch["input_ids"]), cfg)
    draws = dict(vis_neg=vis_neg, txt_neg=txt_neg, corrupted=corrupted, mlm_labels=labels)
    if keep is not None:
        draws["keep"] = keep
    return {k: _t(v).long() if k != "corrupted" else _t(v) for k, v in draws.items()}


def _port_loss(p, cfg, draws):
    p["model"].zero_grad(set_to_none=True)
    loss, aux = tclip.clip_loss(p["model"], cfg, {k: _t(v) for k, v in p["batch"].items()},
                                teacher=p["teacher"], deterministic=False, **draws)
    loss.backward()
    return loss, aux


# -- the loss functions at 1e-6 -------------------------------------------------------

@pytest.mark.parametrize("shape,agg", [((6, 12), "mean"), ((6, 3, 12), "mean"),
                                       ((6, 3, 12), "max")])
def test_get_sim_matches_jax(shape, agg):
    rng = np.random.default_rng(2)
    v = rng.standard_normal(shape).astype(np.float32)
    t = rng.standard_normal((5, 12)).astype(np.float32)
    js = jclip.get_sim(v, t, 0.07, agg)
    ts = tclip.get_sim(_t(v), _t(t), 0.07, agg)
    for got, want in zip(ts, js):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_idx_targets_vtc_and_mlm_loss_match_jax():
    rng = np.random.default_rng(3)
    idx = np.array([0, 0, 1, 2, 2, 2, 3], np.int32)
    for i in (idx, None):
        np.testing.assert_allclose(
            tclip._idx_targets(None if i is None else _t(i), 7).numpy(),
            np.asarray(jclip._idx_targets(i, 7)), rtol=1e-6, atol=1e-6)
    v, t = (rng.standard_normal((7, 16)).astype(np.float32) for _ in range(2))
    for i in (idx, None):
        want = float(jclip.vtc_loss(v, t, i, 0.05))
        got = tclip.vtc_loss(_t(v), _t(t), None if i is None else _t(i), 0.05).item()
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)
    logits = rng.standard_normal((3, 9, 50)).astype(np.float32) * 3
    labels = np.where(rng.random((3, 9)) < 0.4, rng.integers(0, 50, (3, 9)), -100)
    labels = labels.astype(np.int32)
    for lab in (labels, np.full_like(labels, -100)):
        want = float(jclip.mlm_loss_from_logits(logits, lab))
        got = tclip.mlm_loss_from_logits(_t(logits), _t(lab)).item()
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)


# -- the whole loss and its gradients against JAX's loss_fn ----------------------------

def test_clip_loss_and_grads_match_jax(pair):
    p = pair
    cfg = p["trun"].engine
    jcfg = p["jrun"].engine
    rng = jax.random.key(7)
    loss_fn = _jax_loss_fn(p["jmodel"], jcfg, p["jteacher"], p["tparams"])
    jbatch = jax.tree.map(jnp.asarray, p["batch"])
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        p["params"]["params"], jbatch, rng)
    loss, aux = _port_loss(p, cfg, _jax_draws(p, jcfg, rng))

    want_keys = {"loss_vtc", "loss_vtm", "loss_mlm"} | ({"loss_uta"} if cfg.uta > 0 else set())
    assert set(aux) == set(jaux) == want_keys
    for key, want in [("loss", float(jloss))] + [(k, float(v)) for k, v in jaux.items()]:
        got = loss.item() if key == "loss" else aux[key].item()
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (p["name"], key, got, want)
    want = params_from_jax(_np({"params": jgrads}), p["trun"].model)
    got = dict(p["model"].named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        grad = got[name].grad
        grad = torch.zeros_like(got[name]) if grad is None else grad
        np.testing.assert_allclose(grad.numpy(), g.numpy(), atol=5e-4, rtol=5e-4,
                                   err_msg=f"{p['name']} {name}")
    if p["teacher"] is not None:
        assert all(q.grad is None for q in p["teacher"].parameters())


# -- the random draws by their contracts -----------------------------------------------

def test_mlm_corrupt_contract():
    cfg = tclip.CLIPLossConfig(vocab_size=1024, mlm_probability=0.5)
    rng = np.random.default_rng(4)
    ids = rng.integers(200, 1000, (64, 128))
    ids[:, 0] = cfg.cls_token_id
    ids[:, 100:] = cfg.pad_token_id
    ids = torch.from_numpy(ids)
    out, labels = tclip.mlm_corrupt(torch.Generator().manual_seed(0), ids, cfg)
    special = (ids == cfg.pad_token_id) | (ids == cfg.cls_token_id)
    sel = labels != -100
    assert not (sel & special).any() and torch.equal(out[special], ids[special])
    assert torch.equal(labels[sel], ids[sel]) and torch.equal(out[~sel], ids[~sel])
    n_ok, n = int((~special).sum()), int(sel.sum())

    def within_4_sigma(count, total, prob):
        return abs(count - total * prob) <= 4 * math.sqrt(total * prob * (1 - prob))

    assert n_ok >= 6000 and within_4_sigma(n, n_ok, cfg.mlm_probability), (n, n_ok)
    masked = int((out[sel] == cfg.mask_token_id).sum())
    kept = int((out[sel] == ids[sel]).sum())
    assert within_4_sigma(masked, n, 0.8), masked
    assert within_4_sigma(kept, n, 0.1), kept
    assert within_4_sigma(n - masked - kept, n, 0.1), n - masked - kept
    assert out.dtype == ids.dtype and int(out.max()) < cfg.vocab_size


@pytest.mark.parametrize("hard", [True, False])
def test_mine_negatives_never_draws_a_positive(hard):
    rng = np.random.default_rng(5)
    idx = torch.tensor([0, 0, 1, 1, 1, 2, 3, 4])
    gen = torch.Generator().manual_seed(0)
    for i in (idx, None):
        pos = (torch.eye(8, dtype=torch.bool) if i is None else i[:, None] == i[None, :])
        for _ in range(50):
            v, t = (torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
                    for _ in range(2))
            vis_neg, txt_neg = tclip.mine_negatives(gen, v, t, i, 0.5, hard)
            rows = torch.arange(8)
            assert not pos[rows, txt_neg].any() and not pos[rows, vis_neg].any()


def test_mine_negatives_hard_picks_the_dominant_logit():
    n = 8
    v = torch.eye(n)
    t = torch.roll(torch.eye(n), 1, dims=1)  # text j aligns with video j + 1
    gen = torch.Generator().manual_seed(1)
    for _ in range(20):
        vis_neg, txt_neg = tclip.mine_negatives(gen, v, t, None, 0.01, True)
        assert torch.equal(txt_neg, (torch.arange(n) - 1) % n)
        assert torch.equal(vis_neg, (torch.arange(n) + 1) % n)


# -- the teacher's bicubic resize ------------------------------------------------------

@pytest.mark.parametrize("size", [14, 22, 45], ids=["shrink_2x", "shrink", "grow"])
def test_bicubic_resize_matches_jax(size):
    x = np.random.default_rng(6).standard_normal((2, 2, 30, 30, 3)).astype(np.float32)
    want = jax.image.resize(x, (2, 2, size, size, 3), method="bicubic")
    got = tclip.resize_bicubic(_t(x), size)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# -- one optimizer step: the decoders no loss reaches decay as in optax ---------------

@pytest.mark.parametrize("pair", ["clip_stage2_tiny"], indirect=True)
def test_step_decays_the_unused_decoders_as_optax(pair):
    p = pair
    opt_cfg = dict(lr=1e-2, warmup_steps=0, weight_decay=0.05)
    cfg = dataclasses.replace(p["trun"].engine, uta=0.0)
    jcfg = dataclasses.replace(p["jrun"].engine, uta=0.0)
    jopt = dataclasses.replace(p["jrun"].trainer.optimizer, **opt_cfg)
    topt = dataclasses.replace(p["trun"].trainer.optimizer, **opt_cfg)

    jparams = jax.tree.map(jnp.asarray, p["params"]["params"])
    tx, _ = jax_build_optimizer(jopt, jparams)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                           opt_state=tx.init(jparams), tx=tx, apply_fn=p["jmodel"].apply)
    jstep = jax.jit(jclip.make_clip_train_step(p["jmodel"], jcfg))
    rng = jax.random.key(8)
    jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, p["batch"]), rng)

    model = VideoCLIP(p["trun"].model, device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(p["params"], p["trun"].model), strict=True)
    before = {n: q.detach().clone() for n, q in model.named_parameters()}
    opt, _ = build_optimizer(topt, model)
    # the JAX step folds the state's step into its key before loss_fn splits it
    draws = _jax_draws(p, jcfg, jax.random.fold_in(rng, 0))
    loss, _ = _port_loss(dict(p, model=model, teacher=None), cfg, draws)
    unused = [n for n, q in model.named_parameters() if q.grad is None]
    assert unused and all(n.startswith(("vision_encoder.clip_decoder.",
                                        "vision_encoder.final_clip_decoder.",
                                        "vision_encoder.clip_pos_embed")) for n in unused)
    opt.step()

    assert abs(loss.item() - float(jm["loss"])) <= 1e-5 * max(1.0, abs(float(jm["loss"])))
    want = params_from_jax(_np({"params": jstate.params}), p["trun"].model)
    got = dict(model.named_parameters())
    moved = 0
    for name in unused:
        np.testing.assert_allclose(got[name].detach().numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=0, err_msg=name)
        moved += int(not torch.equal(got[name], before[name]))
    assert moved > 0  # the decayed kernels moved, as optax moved them


# -- the CLI and the configs -------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_cli_clip_on_cpu(name):
    buf = io.StringIO()
    cfg = os.path.join(ROOT, "configs", "torch", f"{name}.py")
    with redirect_stdout(buf):
        rc = cli.main(["--config", cfg, "--device", "cpu", "trainer.total_steps=3",
                       "trainer.log_every=1"])
    assert rc == 0
    steps = [dict(kv.split(": ") for kv in ln.split("  "))
             for ln in buf.getvalue().splitlines() if ln.startswith("step: ")]
    assert len(steps) == 3
    keys = ["loss", "loss_vtc", "loss_vtm", "loss_mlm", "grad_norm"]
    keys += ["loss_uta"] if name == "clip_stage2_tiny" else []
    for rec in steps:
        for key in keys:
            assert math.isfinite(float(rec[key])), (key, rec)
    assert ("loss_uta" in steps[0]) == (name == "clip_stage2_tiny")


@pytest.mark.parametrize("name", CONFIGS)
def test_losses_fall_on_a_fixed_batch(name):
    """The step trains: its fresh draws each step (negatives, MLM corruption,
    keep) still let the loss fall on one repeated batch, as the JAX tests'
    steps do."""
    run = apply_overrides(load_config(os.path.join(ROOT, "configs", "torch", f"{name}.py")),
                              ["trainer.optimizer.lr=1e-3", "trainer.optimizer.total_steps=100"])
    trainer, batch, _ = cli.build_clip(run, torch.device("cpu"))
    fixed = trainer.put_batch(next(cli._synthetic_clip_stream(batch, run.model.text.vocab_size)))
    ms = [trainer._step(trainer.state, fixed) for _ in range(5)]
    keys = ["loss"] + (["loss_uta"] if run.engine.uta > 0 else [])
    for key in keys:
        vals = [float(m[key]) for m in ms]
        assert all(math.isfinite(v) for v in vals) and vals[-1] < vals[0], (key, vals)


def test_build_clip_teacher_is_frozen_and_checkpoints_raise():
    run = load_config(os.path.join(ROOT, "configs", "torch", "clip_stage2_tiny.py"))
    trainer, batch, teacher = cli.build_clip(run, torch.device("cpu"))
    assert batch == {"video": (8, 2, 28, 28, 3), "input_ids": (8, 16),
                     "attention_mask": (8, 16), "idx": (8,)}
    assert not teacher.training and not any(q.requires_grad for q in teacher.parameters())
    assert {id(q) for q in trainer.state.optimizer.params} == {
        id(q) for q in trainer.model.parameters()}
    plain = dataclasses.replace(run, engine=dataclasses.replace(run.engine, uta=0.0))
    assert cli.build_clip(plain, torch.device("cpu"))[2] is None
    for key in ("init_state_dict", "teacher_checkpoint"):
        with pytest.raises(NotImplementedError, match="item 9"):
            cli.build_clip(dataclasses.replace(run, data={**run.data, key: "x.pt"}),
                           torch.device("cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(["--config", os.path.join(ROOT, "configs", "torch", "clip_tiny.py"),
                      "--device", "cuda"])
    with pytest.raises(ValueError, match="teacher"):
        tclip.make_clip_train_step(run.engine, None)
    with pytest.raises(ValueError, match="special ids"):
        tclip.make_clip_train_step(dataclasses.replace(run.engine, uta=0.0, vocab_size=100))


@pytest.mark.parametrize("name", ["clip_stage2_1b", "clip_tiny", "clip_stage2_tiny"])
def test_clip_configs_mirror_the_jax_configs(name):
    jrun = jax_load_config(os.path.join(ROOT, "configs", f"{name}.py"))
    trun = load_config(os.path.join(ROOT, "configs", "torch", f"{name}.py"))
    for field in ("task", "trainer", "model", "data", "engine", "teacher"):
        assert config_to_dict(getattr(trun, field)) == jax_to_dict(getattr(jrun, field)), field
