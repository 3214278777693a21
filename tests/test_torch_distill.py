"""Task `distill` of the PyTorch port vs the JAX package.

Same params (JAX `init` -> `params_from_jax` -> `load_state_dict(strict=
True)`, every LayerScale gamma at 0.1), same numpy video, same keep
indices: JAX's `make_distill_step` loss_fn draws them from its key (tube,
random, or all positions), the port's `distill_loss` takes them as an
argument. At tests/test_models_extra.py::test_distill_step's widths the
loss and both terms agree to 1e-5 relative and every student gradient to
5e-4 (fp32); the teacher gets none. The port's step trains (the loss
falls, as in the JAX test); the tiny CLI runs on the CPU; the configs
mirror the JAX one and the full-width config gives the slice's shapes.
"""

import dataclasses
import io
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import internvideo_tpu.train.engines.distill as jdistill
from internvideo_tpu.core.config import config_to_dict as jax_to_dict
from internvideo_tpu.core.config import load_config as jax_load_config
from internvideo_tpu.data.masking import random_keep_indices as jax_random_keep
from internvideo_tpu.data.masking import tube_keep_indices as jax_tube_keep
from internvideo_tpu.models.internvideo2 import InternVideo2 as JInternVideo2
from internvideo_tpu.models.internvideo2 import InternVideo2Config as JConfig
from internvideo_tpu.models.pretrain import PretrainConfig as JPretrainConfig
from internvideo_tpu.models.pretrain import PretrainInternVideo2 as JPretrain
from internvideo_tpu_torch.cli import train as cli
from internvideo_tpu_torch.core.config import config_to_dict, load_config
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.models.internvideo2 import InternVideo2, InternVideo2Config
from internvideo_tpu_torch.models.pretrain import PretrainConfig, PretrainInternVideo2
from internvideo_tpu_torch.train.engines.distill import (
    DistillConfig,
    distill_loss,
    make_distill_step,
)
from internvideo_tpu_torch.train.optim import OptimizerConfig, build_optimizer
from internvideo_tpu_torch.train.state import TrainState, frozen_teacher

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = os.path.join(ROOT, "configs", "torch", "distill_tiny.py")
VIS = dict(embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0, patch_size=14, img_size=28,
           num_frames=2, tubelet_size=1, clip_embed_dim=16, num_classes=0)
TEACHER = dict(VIS, embed_dim=48)
PRE = dict(clip_output_dim=48, clip_final_output_dim=16, clip_return_layers=2,
           mae_return_layers=0)


def _np(tree):
    return jax.tree.map(np.asarray, fnn.unbox(tree))


def _gammas(tree, value=0.1):
    if isinstance(tree, dict):
        return {k: (np.full_like(v, value) if k == "gamma" else _gammas(v, value))
                for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def pair():
    """The JAX student / teacher with their params, and the port's loaded
    from them; a video of B 2."""
    video = np.random.default_rng(0).standard_normal((2, 2, 28, 28, 3)).astype(np.float32)
    n = JConfig(**VIS).num_patches
    keep0 = np.broadcast_to(np.arange(n, dtype=np.int32), (2, n))
    jteacher = JInternVideo2(JConfig(**TEACHER, attn_impl="xla"))
    jstudent = JPretrain(JPretrainConfig(encoder=JConfig(**VIS, attn_impl="xla"), **PRE))
    # jitted inits: the same params bit for bit as eager ones, in a third of the time
    tparams = _gammas(_np(jax.jit(jteacher.init)(jax.random.key(1), video)))
    sparams = _gammas(_np(jax.jit(jstudent.init)(jax.random.key(2), video, keep0)))
    gen = torch.Generator().manual_seed(0)
    student = PretrainInternVideo2(PretrainConfig(encoder=InternVideo2Config(**VIS), **PRE),
                                   device="cpu", generator=gen)
    student.load_state_dict(params_from_jax(sparams), strict=True)
    teacher = InternVideo2(InternVideo2Config(**TEACHER), device="cpu", generator=gen)
    teacher.load_state_dict(params_from_jax(tparams), strict=True)
    return jstudent, jteacher, sparams, tparams, student, frozen_teacher(teacher), video


def _jax_loss_fn(jstudent, jteacher, cfg):
    """The JAX engine's own loss_fn(params, teacher_params, batch, rng)."""
    orig = jdistill.make_accum_step
    jdistill.make_accum_step = lambda loss_fn, grad_accum=1: loss_fn
    try:
        return jdistill.make_distill_step(jstudent, jteacher, cfg)
    finally:
        jdistill.make_accum_step = orig


def _jax_keep(cfg, rng, b, enc):
    """The keep indices JAX's loss_fn draws from `rng` (distill.py:58-73)."""
    n_spatial = (enc["img_size"] // enc["patch_size"]) ** 2
    n = (enc["num_frames"] // enc["tubelet_size"]) * n_spatial
    if cfg.mask_type == "tube" and cfg.mask_ratio > 0:
        keep = jax_tube_keep(rng, b, enc["num_frames"] // enc["tubelet_size"], n_spatial,
                             cfg.mask_ratio)
    elif cfg.mask_type == "random" and cfg.mask_ratio > 0:
        keep = jax_random_keep(rng, b, n, cfg.mask_ratio)
    else:
        keep = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), (b, n))
    return np.asarray(keep)


@pytest.mark.parametrize("mask", [("tube", 0.5), ("random", 0.5), ("none", 0.0)])
@pytest.mark.parametrize("layers", [(1, 0), (0, 1)])
def test_distill_loss_and_grads_match_jax(pair, mask, layers):
    jstudent, jteacher, sparams, tparams, student, teacher, video = pair
    kw = dict(teacher_layer_indices=layers, mask_type=mask[0], mask_ratio=mask[1],
              loss_ratio=(1.0, 0.5))
    jcfg, cfg = jdistill.DistillConfig(**kw), DistillConfig(**kw)
    rng = jax.random.key(3)
    loss_fn = _jax_loss_fn(jstudent, jteacher, jcfg)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        sparams["params"], tparams, {"video": jnp.asarray(video)}, rng)
    keep = _jax_keep(jcfg, rng, 2, VIS)
    assert keep.shape == (2, {"tube": 4, "random": 4, "none": 8}[mask[0]])

    student.zero_grad(set_to_none=True)
    loss, aux, used = distill_loss(student, teacher, cfg, torch.from_numpy(video),
                                   keep=torch.from_numpy(keep))
    loss.backward()
    assert torch.equal(used, torch.from_numpy(keep).long())
    assert set(aux) == set(jaux) == {"loss_middle", "loss_final"}
    for key, got, want in [("loss", loss, jloss)] + [(k, aux[k], jaux[k]) for k in aux]:
        assert abs(got.item() - float(want)) <= 1e-5 * max(1.0, abs(float(want))), key
    want = params_from_jax(_np({"params": jgrads}))
    got = dict(student.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        grad = got[name].grad
        grad = torch.zeros_like(got[name]) if grad is None else grad
        np.testing.assert_allclose(grad.numpy(), g.numpy(), atol=5e-4, rtol=5e-4, err_msg=name)
    assert all(p.grad is None for p in teacher.parameters())


def test_distill_step_trains(pair):
    *_, student, teacher, video = pair
    model = PretrainInternVideo2(student.config, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    model.load_state_dict(student.state_dict())
    opt, _ = build_optimizer(OptimizerConfig(lr=1e-3, total_steps=10, warmup_steps=0), model)
    state = TrainState.create(model, opt, seed=0)
    step = make_distill_step(teacher, DistillConfig(teacher_layer_indices=(1, 0),
                                                    mask_type="tube", mask_ratio=0.5))
    batch = {"video": torch.from_numpy(video)}
    losses = [step(state, batch)["loss"].item() for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_cli_distill_on_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(["--config", TINY, "--device", "cpu"]) == 0
    steps = [ln for ln in buf.getvalue().splitlines() if ln.startswith("step:")]
    assert len(steps) == 3
    for line in steps:
        fields = dict(f.split(": ") for f in line.split("  "))
        for key in ("loss", "loss_middle", "loss_final", "grad_norm"):
            assert np.isfinite(float(fields[key])), key


def test_distill_configs_mirror_jax_and_give_the_slice_shapes(tmp_path):
    jrun = jax_load_config(os.path.join(ROOT, "configs", "distill_tiny.py"))
    trun = load_config(TINY)
    for field in ("task", "trainer", "model", "data", "engine", "teacher"):
        assert config_to_dict(getattr(trun, field)) == jax_to_dict(getattr(jrun, field)), field
    big = load_config(os.path.join(ROOT, "configs", "torch", "distill_l14_1b.py"))
    enc, eng = big.model.encoder, big.engine
    n_spatial = (enc.img_size // enc.patch_size) ** 2
    n_vis = cli._num_visible_tokens(eng.mask_type, eng.mask_ratio, enc.num_frames, n_spatial)
    assert 1 + n_vis == 417 and 1 + big.teacher.num_patches == 2049
    assert (enc.embed_dim, enc.depth, enc.num_heads) == (1024, 24, 16)
    assert (big.teacher.embed_dim, big.teacher.depth, big.teacher.num_heads) == (1408, 40, 16)
    assert big.model.clip_output_dim == big.teacher.embed_dim
    assert big.model.clip_final_output_dim == big.teacher.clip_embed_dim
    assert len(eng.teacher_layer_indices) == len(big.model.clip_indices) == 6
    # data.teacher_checkpoint loads (it raised until checkpoint I/O was
    # ported): a reference encoder state dict through the convert CLI's npz
    from internvideo_tpu_torch.core.checkpoint import write_safetensors
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2
    from internvideo_tpu_torch.tools import convert_cli
    from tests.torch_ckpt_synth import encoder_reference_sd, same_weights

    other = InternVideo2(trun.teacher, device="cpu", generator=torch.Generator().manual_seed(9))
    write_safetensors(str(tmp_path / "t.safetensors"),
                      encoder_reference_sd(other.state_dict(), trun.teacher))
    with redirect_stdout(io.StringIO()):
        convert_cli.main(["--kind", "internvideo2_encoder", "--depth", str(trun.teacher.depth),
                          "--src", str(tmp_path / "t.safetensors"),
                          "--dst", str(tmp_path / "t.npz")])
    _, _, teacher = cli.build_distill(dataclasses.replace(trun, data={
        **trun.data, "teacher_checkpoint": str(tmp_path / "t.npz")}), torch.device("cpu"))
    assert same_weights(teacher, other) and not teacher.training
