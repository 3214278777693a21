"""Audio-visual stage-2 training (task `clip_av`) in the PyTorch port vs the
JAX package, on the CPU.

At tests/test_audio.py::test_av_clip_train_step_all_media's widths (the
simple tower at `AUD`, dropout 0; JAX's Blocks at `attn_impl="xla"`), and
with the BEATs tower at test_av_model_beats_tower's: same params (JAX
`init(init_all_branches=True)` -> `params_from_jax` ->
`load_state_dict(strict=True)`), same numpy batch, same draws (the VTM
negatives and MLM corruption JAX's `loss_fn` draws from its key, passed to
the port's `av_clip_loss`). Held per media type against JAX's own
`make_av_clip_train_step` loss_fn: the loss and each term at 1e-5
relative, every parameter's gradient at 5e-4 max-abs (those the media type
does not reach are 0 in both). The tiny CLI trains every media type on the
CPU; the synthetic stream is JAX's draw for draw; the tiny config mirrors
the JAX one; the full-width config holds the recipe it states.
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
from internvideo_tpu.cli import train as jcli
from internvideo_tpu.core.config import config_to_dict as jax_to_dict
from internvideo_tpu.core.config import load_config as jax_load_config
from internvideo_tpu.models import audio as jaudio
from internvideo_tpu.models import beats as jbeats
from internvideo_tpu.models.bert import BertConfig as JBertConfig
from internvideo_tpu.models.internvideo2 import InternVideo2Config as JInternVideo2Config
from internvideo_tpu.models.videoclip_av import VideoCLIPAV as JVideoCLIPAV
from internvideo_tpu.models.videoclip_av import VideoCLIPAVConfig as JVideoCLIPAVConfig
from internvideo_tpu_torch.cli import train as cli
from internvideo_tpu_torch.core.config import apply_overrides, config_to_dict, load_config
from internvideo_tpu_torch.models import audio as taudio
from internvideo_tpu_torch.models import beats as tbeats
from internvideo_tpu_torch.models.bert import BertConfig
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.models.internvideo2 import InternVideo2Config
from internvideo_tpu_torch.models.videoclip_av import VideoCLIPAV, VideoCLIPAVConfig
from internvideo_tpu_torch.train.engines import clip as tclip

ROOT = os.path.join(os.path.dirname(__file__), "..")
MEDIA = ("video", "audio", "audio_video")
AUD = dict(embed_dim=32, depth=2, num_heads=2, patch_size=16, n_mels=32, max_frames=64,
           attn_impl="xla")
BEATS = dict(input_patch_size=8, embed_dim=16, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
             encoder_layers=2, encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4,
             num_buckets=32, max_distance=16)
VISION = dict(embed_dim=32, depth=1, num_heads=2, mlp_ratio=2.0, patch_size=14, img_size=28,
              num_frames=2, tubelet_size=1, clip_embed_dim=16, attn_impl="xla")
TEXT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            fusion_layer=1, dropout=0.0, attn_impl="xla")
LOSS = dict(vocab_size=64, mask_token_id=1, cls_token_id=2, mlm_probability=0.3)


def _np(tree):
    return jax.tree.map(np.asarray, flax_nn.unbox(tree))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=["simple", "beats"])
def pair(request):
    """One tiny AV model in both packages, JAX's init params loaded into the
    port's, a batch of 4 (two rows share an idx, one text is padded)."""
    tower = request.param
    jkw = dict(vision=JInternVideo2Config(**VISION), audio=jaudio.AudioEncoderConfig(**AUD),
               text=JBertConfig(**TEXT), embed_dim=24, audio_tower=tower)
    tkw = dict(vision=InternVideo2Config(**VISION), audio=taudio.AudioEncoderConfig(**AUD),
               text=BertConfig(**TEXT), embed_dim=24, audio_tower=tower)
    if tower == "beats":
        jkw["beats"], tkw["beats"] = jbeats.BEATsConfig(**BEATS), tbeats.BEATsConfig(**BEATS)
    jcfg, tcfg = JVideoCLIPAVConfig(**jkw), VideoCLIPAVConfig(**tkw)
    rng = np.random.default_rng(11)
    b = 4
    ids = rng.integers(4, 60, (b, 8)).astype(np.int32)
    ids[:, 0] = 2  # CLS, never masked
    mask = np.ones_like(ids)
    mask[1, -2:] = 0
    ids = ids * mask
    batch = {"video": rng.standard_normal((b, 2, 28, 28, 3)).astype(np.float32),
             "audio": rng.standard_normal((b, 64, 32)).astype(np.float32),
             "input_ids": ids, "attention_mask": mask,
             "idx": np.array([0, 0, 1, 2], np.int32)}
    jmodel = JVideoCLIPAV(jcfg)
    params = _np(jax.jit(lambda i, m, v, a: jmodel.init(
        jax.random.key(3), i, m, v, a, media_type="audio_video", init_all_branches=True))(
        batch["input_ids"], batch["attention_mask"], batch["video"], batch["audio"]))
    model = VideoCLIPAV(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(params, tcfg), strict=True)
    return dict(tower=tower, tcfg=tcfg, batch=batch, jmodel=jmodel, params=params, model=model)


def _jax_loss_fn(jmodel, cfg, media):
    """The JAX engine's own loss_fn(params, batch, rng) of one media type."""
    orig = jclip.make_accum_step
    jclip.make_accum_step = lambda loss_fn, grad_accum=1: loss_fn
    try:
        return jclip.make_av_clip_train_step(jmodel, cfg, media)
    finally:
        jclip.make_accum_step = orig


def _jax_draws(p, cfg, media, rng):
    """The VTM negatives and MLM corruption JAX's loss_fn draws from `rng`
    (dropout is 0, so the forward that feeds the negatives is deterministic)."""
    batch = p["batch"]
    r_neg, r_mlm, _ = jax.random.split(rng, 3)
    out = p["jmodel"].apply(p["params"], batch["input_ids"], batch["attention_mask"],
                            video=batch["video"], audio=batch["audio"], media_type=media)
    vis_neg, txt_neg = jclip.mine_negatives(r_neg, out.vision_proj, out.text_proj,
                                            jnp.asarray(batch["idx"]), out.temp,
                                            cfg.vtm_hard_neg)
    corrupted, labels = jclip.mlm_corrupt(r_mlm, jnp.asarray(batch["input_ids"]), cfg)
    return dict(vis_neg=_t(vis_neg).long(), txt_neg=_t(txt_neg).long(),
                corrupted=_t(corrupted), mlm_labels=_t(labels).long())


@pytest.mark.parametrize("media", MEDIA)
def test_av_loss_and_grads_match_jax(pair, media):
    p = pair
    jcfg, cfg = jclip.CLIPLossConfig(**LOSS), tclip.CLIPLossConfig(**LOSS)
    rng = jax.random.key(17)
    jbatch = jax.tree.map(jnp.asarray, p["batch"])
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(p["jmodel"], jcfg, media), has_aux=True))(p["params"]["params"], jbatch, rng)
    model = p["model"]
    model.zero_grad(set_to_none=True)
    loss, aux = tclip.av_clip_loss(model, cfg, media, {k: _t(v) for k, v in p["batch"].items()},
                                   deterministic=False, **_jax_draws(p, jcfg, media, rng))
    loss.backward()

    assert set(aux) == set(jaux) == {"loss_vtc", "loss_vtm", "loss_mlm"}
    for key, want in [("loss", float(jloss))] + [(k, float(v)) for k, v in jaux.items()]:
        got = loss.item() if key == "loss" else aux[key].item()
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (p["tower"], media, key, got, want)
    want = params_from_jax(_np({"params": jgrads}), p["tcfg"])
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    reached = 0
    for name, g in want.items():
        grad = got[name].grad
        reached += grad is not None and bool(grad.abs().max() > 0)
        grad = torch.zeros_like(got[name]) if grad is None else grad
        np.testing.assert_allclose(grad.numpy(), g.numpy(), atol=5e-4, rtol=5e-4,
                                   err_msg=f"{p['tower']} {media} {name}")
    towers = {"video": ("vision_encoder.",), "audio": ("audio_encoder.",),
              "audio_video": ("vision_encoder.", "audio_encoder.")}[media]
    for prefix in ("vision_encoder.", "audio_encoder."):
        moved = any(got[n].grad is not None and bool(got[n].grad.abs().max() > 0)
                    for n in got if n.startswith(prefix))
        assert moved == (prefix in towers), (media, prefix)
    assert reached > 0


def test_draws_come_from_the_generator_when_not_given(pair):
    """Without explicit draws the loss draws them from its generator: the
    same seed gives the same loss, and it is finite."""
    cfg = tclip.CLIPLossConfig(**LOSS)
    batch = {k: _t(v) for k, v in pair["batch"].items()}
    losses = [tclip.av_clip_loss(pair["model"], cfg, "audio_video", batch,
                                 generator=torch.Generator().manual_seed(5))[0].item()
              for _ in range(2)]
    assert losses[0] == losses[1] and math.isfinite(losses[0])
    with pytest.raises(ValueError, match="media_type"):
        tclip.make_av_clip_train_step(cfg, "smell")
    with pytest.raises(ValueError, match="special ids"):
        tclip.make_av_clip_train_step(dataclasses.replace(cfg, vocab_size=2))


# -- the CLI, its stream and the configs ---------------------------------------------------

def test_synthetic_av_stream_is_jaxs():
    shapes = {"video": (3, 2, 28, 28, 3), "audio": (3, 32, 32), "input_ids": (3, 16),
              "attention_mask": (3, 16), "idx": (3,)}
    want = jcli._synthetic_av_stream({k: np.zeros(s) for k, s in shapes.items()}, seed=4)
    got = cli._synthetic_av_stream(shapes, seed=4)
    for _ in range(2):
        w, g = next(want), next(got)
        assert w.keys() == g.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("media", MEDIA)
def test_cli_clip_av_on_cpu(media):
    buf = io.StringIO()
    cfg = os.path.join(ROOT, "configs", "torch", "clip_av_tiny.py")
    with redirect_stdout(buf):
        rc = cli.main(["--config", cfg, "--device", "cpu", "trainer.total_steps=3",
                       "trainer.log_every=1", f"data.media_type={media}"])
    assert rc == 0
    steps = [dict(kv.split(": ") for kv in ln.split("  "))
             for ln in buf.getvalue().splitlines() if ln.startswith("step: ")]
    assert len(steps) == 3
    for rec in steps:
        for key in ("loss", "loss_vtc", "loss_vtm", "loss_mlm", "grad_norm"):
            assert math.isfinite(float(rec[key])), (media, key, rec)


@pytest.mark.parametrize("media", MEDIA)
def test_losses_fall_on_a_fixed_batch(media):
    run = apply_overrides(load_config(os.path.join(ROOT, "configs", "torch", "clip_av_tiny.py")),
                          ["trainer.optimizer.lr=1e-3", "trainer.optimizer.total_steps=100",
                           f"data.media_type={media}"])
    trainer, batch = cli.build_clip_av(run, torch.device("cpu"))
    assert batch == {"video": (8, 2, 28, 28, 3), "audio": (8, 32, 32), "input_ids": (8, 16),
                     "attention_mask": (8, 16), "idx": (8,)}
    fixed = trainer.put_batch(next(cli._synthetic_av_stream(batch)))
    vals = [float(trainer._step(trainer.state, fixed)["loss"]) for _ in range(6)]
    assert all(math.isfinite(v) for v in vals) and vals[-1] < vals[0], (media, vals)


def test_clip_av_tiny_mirrors_the_jax_config():
    jrun = jax_load_config(os.path.join(ROOT, "configs", "clip_av_tiny.py"))
    trun = load_config(os.path.join(ROOT, "configs", "torch", "clip_av_tiny.py"))
    for field in ("task", "trainer", "model", "data", "engine"):
        assert config_to_dict(getattr(trun, field)) == jax_to_dict(getattr(jrun, field)), field


def test_clip_av_stage2_1b_holds_its_recipe():
    """The full-width config: clip_stage2_1b.py's tower, text tower,
    optimizer and loss; BEATsConfig()'s geometry in bf16; the stage-2 fbank
    of 998 x 64, which BEATs' SAME padding makes 252 tokens."""
    av = load_config(os.path.join(ROOT, "configs", "torch", "clip_av_stage2_1b.py"))
    v = load_config(os.path.join(ROOT, "configs", "torch", "clip_stage2_1b.py"))
    assert av.task == "clip_av" and av.model.audio_tower == "beats"
    assert av.model.vision == v.model.vision and av.model.text == v.model.text
    assert av.trainer.optimizer == v.trainer.optimizer
    assert av.engine == dataclasses.replace(v.engine, mask_type="attention", uta=0.0)
    assert av.model.embed_dim == v.model.embed_dim == 512
    assert av.model.beats == dataclasses.replace(tbeats.BEATsConfig(), dtype="bfloat16")
    assert (av.model.audio.max_frames, av.model.audio.n_mels) == (998, 64)
    assert {k: av.data[k] for k in ("batch_size", "text_len", "media_type")} == {
        "batch_size": 64, "text_len": 32, "media_type": "audio_video"}
    p = av.model.beats.input_patch_size
    n = -(-998 // p) * (64 // p)
    assert n == 252 and sum(tbeats.same_padding(998, p)) == 63 * p - 998
