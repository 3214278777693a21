"""The finetune training slice of the PyTorch port vs the JAX package.

Same params (JAX `init` -> `params_from_jax`), same batches (numpy from a
seed), same gradients: the optimizer against the optax chain, mixup/cutmix
against the JAX function on JAX's own draws, DropPath against the JAX
module on the same mask, and the finetune step on the tiny config against
the JAX step. The Trainer, the checkpoint manager and the CLI are checked
on the port alone (resume equals an uninterrupted run).
"""

import dataclasses
import io
import json
import os
from contextlib import redirect_stdout

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internvideo_tpu.core.config import load_config as jax_load_config
from internvideo_tpu.data.mixup import MixupConfig as JaxMixupConfig
from internvideo_tpu.data.mixup import mixup_cutmix as jax_mixup_cutmix
from internvideo_tpu.models.internvideo2 import InternVideo2 as JaxInternVideo2
from internvideo_tpu.nn.transformer import DropPath as JaxDropPath
from internvideo_tpu.train.engines.finetune import FinetuneConfig as JaxFinetuneConfig
from internvideo_tpu.train.engines.finetune import make_finetune_step as jax_finetune_step
from internvideo_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
from internvideo_tpu.train.optim import build_optimizer as jax_build_optimizer
from internvideo_tpu.train.state import TrainState as JaxTrainState
from internvideo_tpu_torch.cli import train as cli
from internvideo_tpu_torch.core.config import apply_overrides, load_config
from internvideo_tpu_torch.data.mixup import MixupConfig, mixup_cutmix, mixup_cutmix_apply
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.models.internvideo2 import InternVideo2
from internvideo_tpu_torch.nn.transformer import DropPath, draw_keep_masks
from internvideo_tpu_torch.train.engines.finetune import FinetuneConfig, make_finetune_step
from internvideo_tpu_torch.train.optim import OptimizerConfig, build_optimizer, cosine_schedule
from internvideo_tpu_torch.train.state import TrainState
from internvideo_tpu_torch.train.trainer import Trainer, TrainerConfig

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY_JAX = os.path.join(ROOT, "configs", "finetune_tiny.py")
TINY = os.path.join(ROOT, "configs", "torch", "finetune_tiny.py")


def _video_batch(cfg, batch, seed, num_classes):
    rng = np.random.default_rng(seed)
    return {
        "video": rng.standard_normal(
            (batch, cfg.num_frames, cfg.img_size, cfg.img_size, 3)).astype(np.float32),
        "label": rng.integers(0, num_classes, size=(batch,)).astype(np.int32),
    }


def _visible(params):
    """LayerScale gammas 0.1 and a head at std ~0.02, so that every branch
    moves the loss well above the tolerances."""
    def walk(tree):
        return {k: (np.full_like(v, 0.1) if k == "gamma" else
                    walk(v) if isinstance(v, dict) else v) for k, v in tree.items()}

    params = walk(params)
    params["head"]["kernel"] = params["head"]["kernel"] * 1000
    return params


@pytest.fixture(scope="module")
def tiny_params():
    """(JAX run config, port run config, visible JAX params as numpy)."""
    jrun, trun = jax_load_config(TINY_JAX), load_config(TINY)
    video = _video_batch(jrun.model, 1, 0, 8)["video"]
    params = jax.jit(JaxInternVideo2(jrun.model).init)(jax.random.key(0), video)
    params = jax.tree.map(np.asarray, flax_nn.unbox(params))["params"]
    return jrun, trun, _visible(params)


def _port_model(trun, params, **overrides):
    cfg = dataclasses.replace(trun.model, **overrides)
    model = InternVideo2(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(params, cfg), strict=True)
    return model


# -- optimizer ---------------------------------------------------------------

OPT = dict(lr=1e-2, min_lr=1e-4, warmup_steps=2, total_steps=10, weight_decay=0.05,
           clip_grad_norm=1.0, layer_decay=0.9, num_layers=2)


@pytest.mark.parametrize("extra", [
    {},
    {"lr_mult_patterns": (("head", 10.0),)},
    # without layer decay: the JAX chain's layer-decay scales do not take
    # the masked tree multi_transform hands them (a JAX-side fault)
    {"trainable_patterns": (r"head", r"fc_norm", r"blocks[._]1"), "layer_decay": None},
])
def test_optimizer_matches_optax_chain(tiny_params, extra):
    jrun, trun, params = tiny_params
    model = _port_model(trun, params)
    opt, _ = build_optimizer(OptimizerConfig(**{**OPT, **extra}), model)
    tx, _ = jax_build_optimizer(JaxOptimizerConfig(**{**OPT, **extra}), params)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jparams)
    rng = np.random.default_rng(0)
    for _ in range(3):
        # large enough that clipping at 1.0 triggers every step
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        tgrads = params_from_jax(grads, trun.model)
        for name, p in model.named_parameters():
            p.grad = tgrads[name].clone()
        opt.step()
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
    want = params_from_jax(jax.tree.map(np.asarray, jparams), trun.model)
    moved = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)
        moved += not torch.equal(p.detach(), params_from_jax(params, trun.model)[name])
    assert moved > 0


def test_cosine_schedule_matches_optax():
    from internvideo_tpu.train.optim import cosine_schedule as jax_schedule

    for args in [(1e-3, 1e-6, 5, 20), (2e-5, 1e-6, 0, 10)]:
        ours, ref = cosine_schedule(*args), jax_schedule(*args)
        for count in range(0, 25):
            np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-6, atol=1e-12)


# -- mixup / cutmix ------------------------------------------------------------

def _jax_draws(rng, video_shape, cfg):
    """The draws of internvideo_tpu/data/mixup.py:40-63, replayed."""
    r_lam, r_switch, r_box = jax.random.split(rng, 3)
    h, w = video_shape[2], video_shape[3]
    use_cutmix = bool(jax.random.uniform(r_switch) < cfg.switch_prob)
    lam_mix = float(jax.random.beta(r_lam, cfg.mixup_alpha, cfg.mixup_alpha))
    lam_cut = jax.random.beta(r_lam, cfg.cutmix_alpha, cfg.cutmix_alpha)
    cut = jnp.sqrt(1.0 - lam_cut)
    ch, cw = int((h * cut).astype(jnp.int32)), int((w * cut).astype(jnp.int32))
    cy = int(jax.random.randint(r_box, (), 0, h))
    cx = int(jax.random.randint(jax.random.fold_in(r_box, 1), (), 0, w))
    box = (min(max(cy - ch // 2, 0), h), min(max(cy + ch // 2, 0), h),
           min(max(cx - cw // 2, 0), w), min(max(cx + cw // 2, 0), w))
    return use_cutmix, lam_mix, box


def test_mixup_cutmix_apply_matches_jax_on_its_draws():
    kw = dict(mixup_alpha=0.8, cutmix_alpha=1.0, switch_prob=0.5, label_smoothing=0.1,
              num_classes=7)
    jcfg, cfg = JaxMixupConfig(**kw), MixupConfig(**kw)
    data = np.random.default_rng(0)
    branches = set()
    for seed in range(8):
        video = data.standard_normal((4, 2, 12, 10, 3)).astype(np.float32)
        labels = data.integers(0, 7, size=(4,)).astype(np.int32)
        key = jax.random.key(seed)
        jv, jl = jax_mixup_cutmix(key, jnp.asarray(video), jnp.asarray(labels), jcfg)
        use_cutmix, lam, box = _jax_draws(key, video.shape, jcfg)
        branches.add(use_cutmix)
        tv, tl = mixup_cutmix_apply(torch.from_numpy(video), torch.from_numpy(labels), cfg,
                                    use_cutmix=use_cutmix, lam=lam, box=box)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6, rtol=1e-6)
    assert branches == {True, False}


def test_mixup_cutmix_draws_are_soft_targets():
    cfg = MixupConfig(num_classes=5)
    video = torch.randn(6, 2, 16, 16, 3)
    labels = torch.arange(6) % 5
    rng = np.random.default_rng(0)
    for _ in range(10):
        out, soft = mixup_cutmix(rng, video, labels, cfg)
        assert out.shape == video.shape and soft.shape == (6, 5)
        torch.testing.assert_close(soft.sum(-1), torch.ones(6))
        assert (soft >= cfg.label_smoothing / 5 - 1e-7).all()


# -- DropPath and remat --------------------------------------------------------

def test_drop_path_matches_jax_on_the_same_mask():
    rate, b = 0.4, 64
    jmod = JaxDropPath(rate)
    key = jax.random.key(3)
    ones = np.ones((b, 5, 8), np.float32)
    jmask = np.asarray(jmod.apply({}, ones, deterministic=False, rngs={"droppath": key})) > 0
    keep = torch.from_numpy(jmask[:, 0, 0].copy())
    x = np.random.default_rng(0).standard_normal((b, 5, 8)).astype(np.float32)
    ref = np.asarray(jmod.apply({}, x, deterministic=False, rngs={"droppath": key}))
    out = DropPath(rate)(torch.from_numpy(x), keep)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-7, rtol=1e-6)
    assert 0 < keep.sum() < b
    # deterministic / rate 0: identity
    assert torch.equal(DropPath(rate)(torch.from_numpy(x), None), torch.from_numpy(x))
    assert torch.equal(DropPath(0.0)(torch.from_numpy(x), keep), torch.from_numpy(x))
    # bf16 stays bf16, scaled in bf16 as jnp.where(mask, x / keep, 0)
    xb = torch.from_numpy(x).bfloat16()
    torch.testing.assert_close(DropPath(rate)(xb, keep), torch.where(
        keep[:, None, None], xb / (1 - rate), torch.zeros_like(xb)), atol=0, rtol=0)


def test_keep_masks_follow_the_ramp():
    gen = torch.Generator().manual_seed(0)
    keep = draw_keep_masks([0.0, 0.25, 0.5], 4000, gen)
    assert keep.shape == (3, 2, 4000) and keep.dtype == torch.bool
    assert keep[0].all()
    for i, rate in ((1, 0.25), (2, 0.5)):
        assert abs(keep[i].float().mean().item() - (1 - rate)) < 0.03


def test_remat_grads_equal_plain_grads(tiny_params):
    _, trun, params = tiny_params
    video = torch.from_numpy(_video_batch(trun.model, 4, 1, 8)["video"])
    grads = []
    for remat in (False, True):
        model = _port_model(trun, params, remat=remat, drop_path_rate=0.3)
        out = model(video, deterministic=False, generator=torch.Generator().manual_seed(5))
        out.logits.square().sum().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name], atol=0, rtol=0, msg=name)
    # the masks differ from deterministic: drop path was applied
    model = _port_model(trun, params, drop_path_rate=0.3)
    det = model(video).logits
    drop = model(video, deterministic=False, generator=torch.Generator().manual_seed(5)).logits
    assert not torch.allclose(det, drop)
    with pytest.raises(ValueError, match="generator"):
        model(video, deterministic=False)


# -- the finetune step against JAX ----------------------------------------------

@pytest.mark.parametrize("grad_accum", [1, 2])
def test_finetune_step_matches_jax(tiny_params, grad_accum):
    jrun, trun, params = tiny_params
    nc = trun.model.num_classes
    jeng = JaxFinetuneConfig(mixup=None, num_classes=nc)
    jmodel = JaxInternVideo2(jrun.model)
    tx, _ = jax_build_optimizer(jrun.trainer.optimizer, params)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                           opt_state=tx.init(jparams), tx=tx, apply_fn=jmodel.apply)
    jstep = jax.jit(jax_finetune_step(jmodel, jeng, grad_accum=grad_accum))

    model = _port_model(trun, params)
    opt, _ = build_optimizer(trun.trainer.optimizer, model)
    state = TrainState.create(model, opt, seed=0)
    step = make_finetune_step(FinetuneConfig(mixup=None, num_classes=nc), grad_accum=grad_accum)

    bs = trun.data["batch_size"]
    for i in range(3):
        batch = _video_batch(trun.model, bs, 10 + i, nc)
        if grad_accum > 1:
            batch = {k: v.reshape((grad_accum, -1) + v.shape[1:]) for k, v in batch.items()}
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch), jax.random.key(0))
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm", "acc"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-4, atol=0,
                                       err_msg=f"step {i} {key}")
    assert state.step == 3
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), trun.model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)


# -- Trainer, checkpoints, CLI -----------------------------------------------------

def _tiny_trainer(tmp_path, steps, **trainer_kw):
    run = load_config(TINY)
    run = apply_overrides(run, [f"trainer.total_steps={steps}", "model.drop_path_rate=0.2"])
    run = dataclasses.replace(run, trainer=dataclasses.replace(run.trainer, **trainer_kw))
    trainer, batch = cli.build_finetune(run, torch.device("cpu"))
    trainer.metrics.print_fn = lambda msg: None
    return trainer, cli.synthetic_stream(batch, run.model.num_classes)


def _logged_steps(trainer):
    """Make `trainer` record the step of every line it logs."""
    steps = []
    trainer.metrics.print_fn = lambda msg: steps.append(int(msg.split("  ")[0][len("step: "):]))
    return steps


def test_fit_and_resume_equal_an_uninterrupted_run(tmp_path):
    full, data = _tiny_trainer(tmp_path, 4, checkpoint_dir=str(tmp_path / "a"),
                               checkpoint_every=2)
    full.fit(data)
    assert full.state.step == 4 and full.ckpt.all_steps() == [1, 2, 4]

    first, data = _tiny_trainer(tmp_path, 2, checkpoint_dir=str(tmp_path / "b"),
                                checkpoint_every=2)
    first.fit(data)
    resumed, data = _tiny_trainer(tmp_path, 4, checkpoint_dir=str(tmp_path / "b"),
                                  checkpoint_every=2)
    assert resumed.state.step == 2
    resumed.fit(data)  # fast-forwards the stream past the 2 trained batches
    assert resumed.state.step == 4
    a, b = full.model.state_dict(), resumed.model.state_dict()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert full.state.optimizer.count == resumed.state.optimizer.count == 4


def test_metrics_read_once_per_window_and_nan_halts(tmp_path, monkeypatch):
    """The host reads the step metrics once per log window (one stacked
    .tolist()), never a single metric per step."""
    trainer, data = _tiny_trainer(tmp_path, 8, log_every=4, ema_decay=0.9)
    produced, reads = [], []
    step = trainer._step
    trainer._step = lambda state, batch: produced.append(step(state, batch)) or produced[-1]
    real_tolist, real_item = torch.Tensor.tolist, torch.Tensor.item

    def watch(real, what):
        def read(t):
            if any(t is v for m in produced for v in m.values()):
                reads.append(f"{what} of a step metric")
            elif what == "tolist":
                reads.append("tolist")
            return real(t)
        return read

    logged = _logged_steps(trainer)
    monkeypatch.setattr(torch.Tensor, "tolist", watch(real_tolist, "tolist"))
    monkeypatch.setattr(torch.Tensor, "item", watch(real_item, "item"))
    init = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    trainer.fit(data)
    monkeypatch.undo()
    assert len(produced) == 8 and reads == ["tolist", "tolist"], reads
    assert logged == [4, 8]
    name = "blocks.0.attn.qkv.weight"
    ema, p = trainer.state.ema_params[name], dict(trainer.model.named_parameters())[name]
    assert 0 < (ema - init[name]).abs().mean() < (p.detach() - init[name]).abs().mean()

    poisoned, data = _tiny_trainer(tmp_path, 4, log_every=2)

    def nan_stream():
        for batch in data:
            batch["video"][:] = np.nan
            yield batch

    with pytest.raises(FloatingPointError, match="non-finite"):
        poisoned.fit(nan_stream())


def test_grad_accum_trainer_and_unported_options(tmp_path):
    trainer, data = _tiny_trainer(tmp_path, 2, grad_accum=2, log_every=1)
    logged = _logged_steps(trainer)
    other, _ = _tiny_trainer(tmp_path, 2)
    with torch.no_grad():
        for p in other.model.parameters():
            p.add_(1.0)
    trainer.load_params(other.model.state_dict())
    for name, p in trainer.model.state_dict().items():
        assert torch.equal(p, other.model.state_dict()[name]), name
    trainer.fit(data)
    assert trainer.state.step == 2 and logged == [1, 2]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _tiny_trainer(tmp_path, 2, health_check_every=5)
    # ported: hf_export_every without an export_fn does nothing, as in JAX;
    # flops_per_batch logs (tensorboard_dir too: tests/test_torch_utils_io.py)
    for kw in (dict(hf_export_every=5), dict(flops_per_batch=1e9)):
        assert _tiny_trainer(tmp_path, 2, **kw)[0].export_fn is None
    from internvideo_tpu_torch.core.mesh import MeshConfig

    with pytest.raises(NotImplementedError, match="item 8"):
        _tiny_trainer(tmp_path, 2, mesh=MeshConfig(fsdp=4))


def test_cli_train_on_cpu(tmp_path):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["--config", TINY, "--device", "cpu", "trainer.total_steps=4",
                       f"trainer.checkpoint_dir={tmp_path / 'ckpt'}", "trainer.checkpoint_every=2"])
    assert rc == 0
    lines = buf.getvalue().splitlines()
    steps = [ln for ln in lines if ln.startswith("step:")]
    assert len(steps) == 2 and all("loss:" in s and "grad_norm:" in s for s in steps)
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "step_00000001.pt", "step_00000002.pt", "step_00000004.pt"]
    assert json.loads(json.dumps(lines[0].split("config: ", 1)[1].replace("'", '"')
                                 .replace("None", "null").replace("True", "true")
                                 .replace("False", "false")))
    # tasks distill and clip_av are ported: their tiny configs train on the CPU
    for name in ("distill_tiny", "clip_av_tiny"):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert cli.main(["--config", TINY.replace("finetune_tiny", name), "--device",
                             "cpu", "trainer.total_steps=2", "trainer.log_every=1"]) == 0
        assert len([ln for ln in buf.getvalue().splitlines() if ln.startswith("step:")]) == 2
    with pytest.raises(SystemExit, match="unknown task"):
        cli.main(["--config", TINY, "--device", "cpu", "task=smell"])


@pytest.mark.parametrize("name", ["finetune_k400_1b", "finetune_tiny"])
def test_port_configs_mirror_the_jax_configs(name):
    from internvideo_tpu.core.config import config_to_dict as jax_to_dict
    from internvideo_tpu_torch.core.config import config_to_dict

    jrun = jax_load_config(os.path.join(ROOT, "configs", f"{name}.py"))
    trun = load_config(os.path.join(ROOT, "configs", "torch", f"{name}.py"))
    for field in ("task", "trainer", "model", "data", "engine"):
        assert config_to_dict(getattr(trun, field)) == jax_to_dict(getattr(jrun, field)), field


def test_preemption_saves_the_current_step_and_stops(tmp_path):
    """What the SIGTERM / SIGINT handler triggers: the flag set during step
    2 makes fit save step 3 and stop there, without the end-of-run save."""
    trainer, data = _tiny_trainer(tmp_path, 6, checkpoint_dir=str(tmp_path / "ckpt"),
                                  checkpoint_every=100)

    def stream():
        for i, batch in enumerate(data):
            if i == 2:
                trainer._preempted = True
            yield batch

    trainer.fit(stream())
    assert trainer.state.step == 3
    assert trainer.ckpt.all_steps() == [1, 3]
