"""The UMT masked-pretrain slice of the PyTorch port vs the JAX package.

Same params (JAX `init` -> `params_from_jax` -> `load_state_dict(strict=
True)`), same inputs (numpy from a seed), same keep indices: the CLIP
teacher (z, pooled, attention), the MAE teacher (z), the LayerNorm Block,
CrossAttention's returned attention and the pretrain student are held
against the JAX modules at 1e-5; the whole pretrain loss and the student's
gradients at fixed keep indices against the same loss built from the JAX
modules and the JAX engine's `_align_loss`, at 1e-5 (loss) and 5e-4
(grads). The tiny CLI runs on the CPU; the configs mirror the JAX ones.
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

from internvideo_tpu.core.config import config_to_dict as jax_to_dict
from internvideo_tpu.core.config import load_config as jax_load_config
from internvideo_tpu.models.pretrain import PretrainInternVideo2 as JaxPretrain
from internvideo_tpu.models.teachers import CLIPTeacher as JaxCLIPTeacher
from internvideo_tpu.models.teachers import MAETeacher as JaxMAETeacher
from internvideo_tpu.models.teachers import sinusoid_table_1d as jax_sinusoid
from internvideo_tpu.nn.transformer import Block as JaxBlock
from internvideo_tpu.nn.transformer import CrossAttention as JaxCrossAttention
from internvideo_tpu.train.engines.pretrain import _align_loss as jax_align_loss
from internvideo_tpu_torch.cli import train as cli
from internvideo_tpu_torch.core.config import config_to_dict, load_config
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.models.pretrain import PretrainInternVideo2
from internvideo_tpu_torch.models.teachers import (
    CLIPTeacher,
    MAETeacher,
    TeacherConfig,
    sinusoid_table_1d,
)
from internvideo_tpu_torch.nn.transformer import Block, CrossAttention
from internvideo_tpu_torch.train.engines.pretrain import pretrain_loss

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY_JAX = os.path.join(ROOT, "configs", "pretrain_tiny.py")
TINY = os.path.join(ROOT, "configs", "torch", "pretrain_tiny.py")


def _np(tree):
    return jax.tree.map(np.asarray, flax_nn.unbox(tree))


def _gammas(tree, value=0.1):
    """LayerScale gammas at `value`, so that every block moves the output."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, value) if k == "gamma" else _gammas(v, value))
                for k, v in tree.items()}
    return tree


def _load(module, params, cfg=None):
    module.load_state_dict(params_from_jax(params, cfg), strict=True)
    return module.eval()


def _close(got, want, atol=1e-5, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=atol, err_msg=what)


def _video(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


CLIP_CFG = dict(embed_dim=64, depth=3, num_heads=2, mlp_ratio=2.0, patch_size=14,
                img_size=56, clip_embed_dim=24, return_layers=2)


def test_clip_teacher_matches_jax():
    cfg = TeacherConfig(**CLIP_CFG)
    video = _video((2, 3, 56, 56, 3), 0)
    jt = JaxCLIPTeacher(cfg)
    params = _np(jax.jit(jt.init)(jax.random.key(0), video))
    jz, jpooled, jattn = jax.jit(jt.apply)(params, video)
    tt = _load(CLIPTeacher(cfg, device="cpu", generator=torch.Generator().manual_seed(0)),
               params)
    with torch.no_grad():
        tz, tpooled, tattn = tt(torch.from_numpy(video))
    assert tz.shape == (2, 2, 1 + 3 * 16, 64) and tattn.shape == (6, 16)
    for name, t, j in (("z", tz, jz), ("pooled", tpooled, jpooled), ("attn", tattn, jattn)):
        _close(t, j, what=name)


def test_mae_teacher_matches_jax():
    cfg = TeacherConfig(embed_dim=48, depth=3, num_heads=2, mlp_ratio=48 / 11,
                        patch_size=14, img_size=56, return_layers=2, tubelet_size=2,
                        norm_type="layernorm", qk_normalization=False)
    video = _video((2, 4, 56, 56, 3), 1)
    jt = JaxMAETeacher(cfg)
    params = _np(jax.jit(jt.init)(jax.random.key(1), video))
    jz = jax.jit(jt.apply)(params, video)
    tt = _load(MAETeacher(cfg, num_frames=4, device="cpu",
                          generator=torch.Generator().manual_seed(0)), params, cfg)
    assert tt.norm.eps == 1e-5 and tt.blocks[0].norm1.eps == 1e-6
    with torch.no_grad():
        tz = tt(torch.from_numpy(video))
    assert tz.shape == (2, 2, 2 * 16, 48)
    _close(tz, jz, what="z")
    np.testing.assert_array_equal(sinusoid_table_1d(32, 48), np.asarray(jax_sinusoid(32, 48)))


@pytest.mark.parametrize("qk_norm", [False, True])
def test_layernorm_block_matches_jax(qk_norm):
    x = _video((2, 19, 48), 2)
    jb = JaxBlock(num_heads=2, mlp_ratio=3.0, qkv_bias=True, qk_normalization=qk_norm,
                  init_values=0.1, norm_type="layernorm")
    params = _np(jb.init(jax.random.key(2), x))
    tb = _load(Block(48, 2, mlp_ratio=3.0, qkv_bias=True, qk_normalization=qk_norm,
                     init_values=0.1, norm_type="layernorm"), params)
    with torch.no_grad():
        _close(tb(torch.from_numpy(x)), jb.apply(params, x))


def test_cross_attention_return_attn_matches_jax():
    xq, xk = _video((2, 1, 32), 3), _video((2, 17, 32), 4)
    jc = JaxCrossAttention(num_heads=4, qkv_bias=True)
    params = _np(jc.init(jax.random.key(3), xq, xk, xk, return_attn=True))
    jout, jattn = jc.apply(params, xq, xk, xk, return_attn=True)
    tc = _load(CrossAttention(32, 4, qkv_bias=True), params)
    with torch.no_grad():
        tout, tattn = tc(*(torch.from_numpy(x) for x in (xq, xk, xk)), return_attn=True)
    assert tattn.shape == (2, 1, 17)
    _close(tout, jout, what="out")
    _close(tattn, jattn, what="attn")


@pytest.fixture(scope="module")
def tiny_slice():
    """The tiny recipe in both packages: JAX modules with their params (the
    student's gammas raised to 0.1), the port's modules loaded from them,
    a full-rate video and fixed keep indices."""
    jrun, trun = jax_load_config(TINY_JAX), load_config(TINY)
    enc = jrun.model.encoder
    t_full = enc.num_frames * jrun.engine.td_ratio
    video = _video((2, t_full, enc.img_size, enc.img_size, 3), 5)
    sv = video[:, ::jrun.engine.td_ratio]
    n = enc.num_patches
    keep = np.stack([np.sort(np.random.default_rng(s).permutation(n)[:n // 2])
                     for s in range(2)]).astype(np.int32)
    jmods = (JaxPretrain(jrun.model), JaxCLIPTeacher(jrun.teacher),
             JaxMAETeacher(jrun.mae_teacher))
    jparams = (_gammas(_np(jax.jit(jmods[0].init)(jax.random.key(0), sv, keep))),
               _np(jax.jit(jmods[1].init)(jax.random.key(1), sv)),
               _np(jax.jit(jmods[2].init)(jax.random.key(2), video)))
    gen = torch.Generator().manual_seed(0)
    tmods = (PretrainInternVideo2(trun.model, device="cpu", generator=gen),
             CLIPTeacher(trun.teacher, device="cpu", generator=gen),
             MAETeacher(trun.mae_teacher, num_frames=t_full, device="cpu", generator=gen))
    for m, p in zip(tmods, jparams):
        _load(m, p)
    return jrun, trun, jmods, jparams, tmods, video, keep


def test_pretrain_student_matches_jax_at_given_keep(tiny_slice):
    jrun, _, (jstudent, _, _), (jp, _, _), (student, _, _), video, keep = tiny_slice
    sv = video[:, ::jrun.engine.td_ratio]
    jout = jax.jit(jstudent.apply)(jp, sv, keep)
    with torch.no_grad():
        tout = student(torch.from_numpy(sv), torch.from_numpy(keep))
    for name in ("clip_middle", "clip_final", "mae", "tokens", "pooled"):
        _close(getattr(tout, name), getattr(jout, name), what=name)
    n_vis = keep.shape[1]
    assert tout.clip_middle.shape == (2, 2, 1 + n_vis, jrun.model.clip_output_dim)
    assert tout.mae.shape == (1, 2, n_vis, jrun.model.mae_output_dim)


def _jax_loss(jrun, jmods, jparams, video, keep):
    """The JAX engine's loss (train/engines/pretrain.py:71-135) at given
    keep indices with DropPath off, built from the JAX modules."""
    jstudent, jclip, jmae = jmods
    _, cp, mp = jparams
    cfg = jrun.engine
    sv = video[:, ::cfg.td_ratio]
    z_clip, clip_final_t, _ = jclip.apply(cp, sv)
    z_mae = jmae.apply(mp, video)

    def loss(params):
        out = jstudent.apply({"params": params}, sv, keep, deterministic=True)
        gather = jnp.concatenate([jnp.zeros((keep.shape[0], 1), jnp.int32), keep + 1], axis=1)
        tgt_clip = jnp.take_along_axis(z_clip, gather[None, :, :, None], axis=2)
        tgt_mae = jnp.take_along_axis(z_mae, keep[None, :, :, None], axis=2)
        return (jax_align_loss(out.clip_middle, tgt_clip) * cfg.clip_loss_ratio[0]
                + jax_align_loss(out.clip_final, clip_final_t) * cfg.clip_loss_ratio[1]
                + jax_align_loss(out.mae, tgt_mae) * cfg.mae_loss_ratio)

    return loss


def test_pretrain_loss_and_student_grads_match_jax(tiny_slice):
    jrun, trun, jmods, jparams, (student, clip_t, mae_t), video, keep = tiny_slice
    loss_fn = _jax_loss(jrun, jmods, jparams, video, keep)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams[0]["params"])
    want = params_from_jax(_np(jgrads))

    student.zero_grad(set_to_none=True)
    for m in (clip_t, mae_t):
        m.requires_grad_(False)
    loss, aux, used = pretrain_loss(student, clip_t, mae_t, trun.engine,
                                    torch.from_numpy(video), keep=torch.from_numpy(keep),
                                    deterministic=True)
    loss.backward()
    assert torch.equal(used, torch.from_numpy(keep).long())
    assert abs(loss.item() - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss)))
    assert set(aux) == {"loss_clip_middle", "loss_clip_final", "loss_mae"}
    got = dict(student.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(), atol=5e-4, rtol=5e-4,
                                   err_msg=name)
    assert all(p.grad is None for m in (clip_t, mae_t) for p in m.parameters())


def test_cli_pretrain_on_cpu_and_frozen_teachers():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["--config", TINY, "--device", "cpu", "trainer.total_steps=3",
                       "trainer.log_every=1"])
    assert rc == 0
    steps = [dict(kv.split(": ") for kv in ln.split("  "))
             for ln in buf.getvalue().splitlines() if ln.startswith("step: ")]
    assert len(steps) == 3
    for rec in steps:
        for key in ("loss", "loss_clip_middle", "loss_clip_final", "loss_mae", "grad_norm"):
            assert math.isfinite(float(rec[key])), (key, rec)

    run = load_config(TINY)
    trainer, shape, teachers = cli.build_pretrain(run, torch.device("cpu"))
    assert shape == (4, 4, 28, 28, 3)
    for t in teachers:
        assert not t.training and not any(p.requires_grad for p in t.parameters())
    in_opt = {id(p) for p in trainer.state.optimizer.params}
    assert in_opt == {id(p) for p in trainer.model.parameters()}
    assert not any(k.startswith(("clip_teacher", "mae_teacher"))
                   for k in trainer.model.state_dict())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.build_pretrain(dataclasses.replace(run, data={**run.data,
                                                          "clip_teacher_checkpoint": "x.npz"}),
                           torch.device("cpu"))


@pytest.mark.parametrize("name", ["pretrain_1b_umt", "pretrain_tiny"])
def test_pretrain_configs_mirror_the_jax_configs(name):
    jrun = jax_load_config(os.path.join(ROOT, "configs", f"{name}.py"))
    trun = load_config(os.path.join(ROOT, "configs", "torch", f"{name}.py"))
    for field in ("task", "trainer", "model", "data", "engine", "teacher", "mae_teacher"):
        assert config_to_dict(getattr(trun, field)) == jax_to_dict(getattr(jrun, field)), field
