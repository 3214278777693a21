"""The audio frontends, both audio towers and the audio-visual VideoCLIP in
the PyTorch port vs the JAX package, on the CPU in fp32.

Same seeded numpy inputs through both packages; the port's modules load
the JAX init params (`params_from_jax` -> `load_state_dict(strict=True)`).
Held: `mel_filterbank`, `log_mel_spectrogram`, `kaldi_fbank` and
`beats_preprocess` at max-abs 1e-6; BEATs' relative-position buckets
exactly; `AudioEncoder` at tests/test_audio.py's `AUD` and `BEATsEncoder`
at `test_av_model_beats_tower`'s config, tokens and pooled at 2e-5
(JAX's Blocks at `attn_impl="xla"`), BEATs also at the stage-2
audio-visual fbank of 998 x 64 with 16 x 16 patches, where JAX's SAME
padding gives 63 x 4 = 252 tokens (the reference's unpadded Conv2d: 62 x 4
= 248); `VideoCLIPAV`'s media tokens, projections and text outputs for
every media type with either tower at 2e-5.
"""

import dataclasses

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internvideo_tpu.models import audio as jaudio
from internvideo_tpu.models import beats as jbeats
from internvideo_tpu.models.bert import BertConfig as JBertConfig
from internvideo_tpu.models.internvideo2 import InternVideo2Config as JInternVideo2Config
from internvideo_tpu.models.videoclip_av import VideoCLIPAV as JVideoCLIPAV
from internvideo_tpu.models.videoclip_av import VideoCLIPAVConfig as JVideoCLIPAVConfig
from internvideo_tpu_torch.models import audio as taudio
from internvideo_tpu_torch.models import beats as tbeats
from internvideo_tpu_torch.models.bert import BertConfig
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.models.internvideo2 import InternVideo2Config
from internvideo_tpu_torch.models.videoclip_av import VideoCLIPAV, VideoCLIPAVConfig

TOL = 2e-5
# tests/test_audio.py's AUD
AUD = dict(embed_dim=32, depth=2, num_heads=2, patch_size=16, n_mels=32, max_frames=64,
           attn_impl="xla")
# tests/test_audio.py::test_av_model_beats_tower's BEATs
BEATS = dict(input_patch_size=8, embed_dim=16, encoder_embed_dim=32, encoder_ffn_embed_dim=64,
             encoder_layers=2, encoder_attention_heads=4, conv_pos=16, conv_pos_groups=4,
             num_buckets=32, max_distance=16)
VISION = dict(embed_dim=32, depth=1, num_heads=2, mlp_ratio=2.0, patch_size=14, img_size=28,
              num_frames=2, tubelet_size=1, clip_embed_dim=16, num_classes=0, attn_impl="xla")
TEXT = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            fusion_layer=1, dropout=0.0, attn_impl="xla")


def _np(tree):
    return jax.tree.map(np.asarray, flax_nn.unbox(tree))


def _close(got: torch.Tensor, want, what: str, tol: float = TOL):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, (what, tuple(got.shape), want.shape)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=tol, err_msg=what)


def _wav(seconds: float, seed: int, sr: int = 16000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    return (0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(t.shape))


# -- the host frontends ------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(n_mels=16, n_fft=64, sr=1600, fmax=800),
                                dict(n_mels=64, n_fft=512, fmin=20.0)])
def test_mel_filterbank_matches_jax(kw):
    np.testing.assert_allclose(taudio.mel_filterbank(**kw), jaudio.mel_filterbank(**kw),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_mels", [32, 128])
def test_log_mel_spectrogram_matches_jax(n_mels):
    wav = _wav(0.8, 0).astype(np.float32)
    got = taudio.log_mel_spectrogram(wav, n_mels=n_mels)
    want = jaudio.log_mel_spectrogram(wav, n_mels=n_mels)
    assert got.shape == want.shape == (1 + (len(wav) - 400) // 160, n_mels)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("seconds,n_mels", [(1.3, 128), (10.0, 64), (0.01, 64)])
def test_kaldi_fbank_and_beats_preprocess_match_jax(seconds, n_mels):
    wav = _wav(seconds, 1)
    fb = taudio.kaldi_fbank(wav * 2 ** 15, n_mels=n_mels)
    np.testing.assert_allclose(fb, jaudio.kaldi_fbank(wav * 2 ** 15, n_mels=n_mels),
                               atol=1e-6, rtol=0)
    got = taudio.beats_preprocess(wav, n_mels=n_mels)
    want = jaudio.beats_preprocess(wav, n_mels=n_mels)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if seconds == 10.0:  # the stage-2 audio-visual geometry
        assert got.shape == (998, 64)


def test_relative_position_buckets_match_jax():
    pos = np.arange(300)
    rel = pos[None, :] - pos[:, None]
    for nb, md in ((320, 800), (32, 16)):
        want = np.asarray(jbeats._relative_position_bucket(jnp.asarray(rel), nb, md))
        got = tbeats._relative_position_bucket(torch.from_numpy(rel), nb, md)
        np.testing.assert_array_equal(got.numpy(), want)


# -- the towers ---------------------------------------------------------------------------

def test_audio_encoder_matches_jax():
    jcfg, tcfg = jaudio.AudioEncoderConfig(**AUD), taudio.AudioEncoderConfig(**AUD)
    fbank = np.random.default_rng(2).standard_normal((2, 64, 32)).astype(np.float32)
    jmodel = jaudio.AudioEncoder(jcfg)
    params = _np(jmodel.init(jax.random.key(1), fbank))
    tokens, pooled = jmodel.apply(params, fbank)
    model = taudio.AudioEncoder(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(params), strict=True)
    got_tokens, got_pooled = model(torch.from_numpy(fbank))
    assert tuple(got_tokens.shape) == (2, (64 // 16) * (32 // 16), 32)
    _close(got_tokens, tokens, "tokens")
    _close(got_pooled, pooled, "pooled")
    with pytest.raises(ValueError, match="does not tile"):
        model(torch.zeros(1, 40, 32))


@pytest.mark.parametrize("patch,shape,tokens", [
    (8, (2, 32, 32), 16),  # test_av_model_beats_tower's input
    (16, (2, 998, 64), 252),  # the stage-2 fbank: time padded 5 + 5 -> 63 x 4
    (16, (1, 1001, 72), 315),  # both axes padded, the time axis 3 + 4: 63 x 5
], ids=["tiny", "av_998x64", "ragged"])
def test_beats_encoder_matches_jax(patch, shape, tokens):
    kw = dict(BEATS, input_patch_size=patch)
    jcfg, tcfg = jbeats.BEATsConfig(**kw), tbeats.BEATsConfig(**kw)
    fbank = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    jmodel = jbeats.BEATsEncoder(jcfg)
    params = _np(jax.jit(jmodel.init)(jax.random.key(4), fbank))
    # a nonzero gate scale and bias table, so that the gated bias matters
    layer0 = params["params"]["layers_0"]["self_attn"]
    layer0["relative_attention_bias"] = np.random.default_rng(5).standard_normal(
        layer0["relative_attention_bias"].shape).astype(np.float32)
    for i in range(jcfg.encoder_layers):
        attn = params["params"][f"layers_{i}"]["self_attn"]
        attn["grep_a"] = attn["grep_a"] * 1.5
    want_tokens, want_pooled = jax.jit(jmodel.apply)(params, fbank)
    model = tbeats.BEATsEncoder(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(params), strict=True)
    assert model.layers[0].self_attn.relative_attention_bias is not None
    assert model.layers[1].self_attn.relative_attention_bias is None
    got_tokens, got_pooled = model(torch.from_numpy(fbank))
    assert tuple(got_tokens.shape) == (shape[0], tokens, 32)
    _close(got_tokens, want_tokens, "tokens")
    _close(got_pooled, want_pooled, "pooled")
    if shape[1] == 998:
        # JAX's SAME padding vs the reference's unpadded torch Conv2d (ROADMAP queue 3)
        assert tbeats.same_padding(998, 16) == (5, 5)
        unpadded = torch.nn.functional.conv2d(torch.zeros(1, 1, 998, 64),
                                              torch.zeros(16, 1, 16, 16), stride=16)
        assert tuple(unpadded.shape[2:]) == (62, 4)


# -- the audio-visual model ---------------------------------------------------------------

def _av_configs(tower: str):
    common = dict(embed_dim=24, audio_tower=tower)
    jcfg = JVideoCLIPAVConfig(
        vision=JInternVideo2Config(**VISION), audio=jaudio.AudioEncoderConfig(**AUD),
        text=JBertConfig(**TEXT), **common)
    tcfg = VideoCLIPAVConfig(
        vision=InternVideo2Config(**VISION), audio=taudio.AudioEncoderConfig(**AUD),
        text=BertConfig(**TEXT), **common)
    if tower == "beats":
        jcfg = dataclasses.replace(jcfg, beats=jbeats.BEATsConfig(**BEATS))
        tcfg = dataclasses.replace(tcfg, beats=tbeats.BEATsConfig(**BEATS))
    return jcfg, tcfg


@pytest.mark.parametrize("tower", ["simple", "beats"])
def test_videoclip_av_matches_jax(tower):
    jcfg, tcfg = _av_configs(tower)
    rng = np.random.default_rng(6)
    video = rng.standard_normal((2, 2, 28, 28, 3)).astype(np.float32)
    audio = rng.standard_normal((2, 64 if tower == "simple" else 32, 32)).astype(np.float32)
    ids = rng.integers(1, 120, (2, 8)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, -2:] = 0
    jmodel = JVideoCLIPAV(jcfg)
    params = _np(jax.jit(lambda *a: jmodel.init(jax.random.key(7), *a, media_type="audio_video",
                                                init_all_branches=True))(ids, mask, video, audio))
    model = VideoCLIPAV(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(params, tcfg), strict=True)
    assert set(model.state_dict()) == set(params_from_jax(params))
    t = {k: torch.from_numpy(v) for k, v in dict(video=video, audio=audio, ids=ids,
                                                   mask=mask).items()}
    for media in ("video", "audio", "audio_video"):
        out = jmodel.apply(params, ids, mask, video=video, audio=audio, media_type=media)
        got = model(t["ids"], t["mask"], video=t["video"], audio=t["audio"], media_type=media,
                    init_all_branches=True)
        for field in ("vision_embeds", "vision_proj", "text_embeds", "text_proj", "temp"):
            _close(getattr(got, field), getattr(out, field), f"{tower} {media} {field}")
        n_audio = 4 * 2 if tower == "simple" else 4 * 4
        want_len = {"video": 9, "audio": n_audio, "audio_video": n_audio + 9}[media]
        assert got.vision_embeds.shape[1] == want_len
        fused = jmodel.apply(params, out.text_embeds, mask, out.vision_embeds, method="fusion")
        got_fused = model.fusion(got.text_embeds, t["mask"], got.vision_embeds)
        _close(got_fused.pooled, fused.pooled, f"{tower} {media} fusion")
        _close(model.itm_logits(got_fused.pooled),
               jmodel.apply(params, fused.pooled, method="itm_logits"), f"{tower} {media} itm")
        mm = jmodel.apply(params, ids, mask, out.vision_embeds, method="text_multimodal")
        _close(model.text_multimodal(t["ids"], t["mask"], got.vision_embeds).mlm_logits,
               mm.mlm_logits, f"{tower} {media} mlm logits")
    with pytest.raises(ValueError, match="media_type"):
        model.encode_media("smell", t["video"], t["audio"])
    with pytest.raises(ValueError, match="audio_tower"):
        VideoCLIPAV(dataclasses.replace(tcfg, audio_tower="wav2vec"), device="cpu",
                    generator=torch.Generator())
