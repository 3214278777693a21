"""The audio data layer (data/audio.py) and the jsonl dataset's audio rows in
the PyTorch port vs the JAX package, on the CPU.

Wavs written with scipy (int16 mono at 22.05 kHz, int16 stereo, unsigned
8-bit, float32 stereo), read by both packages: `read_wav` (downmix, PCM
scaling), `resample_audio`, `read_audio` and `load_fbank` (zero-pad with the
mask, a random 10 s crop from the same numpy Generator, start 0 without
one, frames cropped to `target_frames`) give identical arrays. With
neither PyAV nor an ffmpeg binary (both hidden from the test), demuxing a
video raises the same RuntimeError naming both. JsonlVideoTextDataset's
"audio" and "audio_video" batches over written wavs and seeded `.npy`
clips are identical to JAX's, in train and eval mode.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

from internvideo_tpu.data import audio as jaudio
from internvideo_tpu.data import datasets as jds
from internvideo_tpu.data.tokenizer import ToyTokenizer as JToyTokenizer
from internvideo_tpu_torch.data import audio as taudio
from internvideo_tpu_torch.data import datasets as tds
from internvideo_tpu_torch.data.tokenizer import ToyTokenizer


def _write_wav(path, seconds, sr=16_000, freq=440.0, channels=1, dtype=np.int16):
    """A tone (a second one an octave up on the right channel), written as
    `dtype` PCM (uint8: offset by 128) or float samples."""
    from scipy.io import wavfile

    t = np.arange(int(seconds * sr)) / sr
    wav = 0.5 * np.sin(2 * np.pi * freq * t)
    if channels == 2:
        wav = np.stack([wav, 0.25 * np.sin(2 * np.pi * 2 * freq * t)], 1)
    if dtype == np.int16:
        data = (wav * 32767).astype(np.int16)
    elif dtype == np.uint8:
        data = (wav * 127 + 128).astype(np.uint8)
    else:
        data = wav.astype(dtype)
    wavfile.write(path, sr, data)
    return path


def _equal(got, want, what=""):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("sr,channels,dtype", [
    (22_050, 1, np.int16), (16_000, 2, np.int16), (16_000, 1, np.uint8),
    (44_100, 2, np.float32)], ids=["int16_22k", "int16_stereo", "uint8", "float32_stereo_44k"])
def test_read_wav_resample_and_read_audio_match_jax(tmp_path, sr, channels, dtype):
    p = _write_wav(str(tmp_path / "a.wav"), 0.5, sr=sr, channels=channels, dtype=dtype)
    got, want = taudio.read_wav(p), jaudio.read_wav(p)
    assert got[1] == want[1] == sr and got[0].ndim == 1
    _equal(got[:1], want[:1], "read_wav")
    _equal([taudio.resample_audio(got[0], sr, 16_000)],
           [jaudio.resample_audio(want[0], sr, 16_000)], "resample_audio")
    _equal([taudio.read_audio(p)], [jaudio.read_audio(p)], "read_audio")
    assert abs(len(taudio.read_audio(p)) - 8000) <= 2


@pytest.mark.parametrize("seconds,kw", [
    (0.7, {}), (12.0, {"seed": 0}), (12.0, {}), (12.0, {"target_frames": 64}),
    (3.0, {"max_audio_length": 1, "seed": 2})], ids=["pad", "crop_rng", "crop_start_0",
                                                     "frames_cropped", "one_second"])
def test_load_fbank_matches_jax(tmp_path, seconds, kw):
    p = _write_wav(str(tmp_path / "a.wav"), seconds, sr=22_050, channels=2)
    seed = kw.pop("seed", None)
    rngs = [None if seed is None else np.random.default_rng(seed) for _ in range(2)]
    got = taudio.load_fbank(p, rng=rngs[0], **kw)
    want = jaudio.load_fbank(p, rng=rngs[1], **kw)
    _equal(got, want, "load_fbank")
    frames = kw.get("target_frames", 998)
    assert got[0].shape == (frames, 64) and got[1].shape == (frames,)
    n_real = int((~got[1]).sum())
    if seconds < 1:
        assert 60 < n_real < 75 and not got[0][n_real:].any()
    elif "max_audio_length" not in kw:
        assert n_real == frames  # a full 10 s window: no pad


@pytest.fixture
def no_demux_backend(monkeypatch):
    """Neither PyAV nor an ffmpeg binary, whatever this machine has."""
    monkeypatch.setitem(sys.modules, "av", None)  # `import av` raises ImportError
    monkeypatch.setattr(shutil, "which", lambda name: None)


def test_demux_without_backends_raises_as_jax(no_demux_backend, tmp_path):
    mp4 = str(tmp_path / "clip.mp4")
    for mod in (taudio, jaudio):
        for fn in (mod.read_audio_from_video, mod.read_audio, mod.load_fbank):
            with pytest.raises(RuntimeError, match="PyAV.*ffmpeg"):
                fn(mp4)


@pytest.fixture
def av_files(tmp_path):
    """Six wavs (0.4-12 s; 16, 22.05 and 44.1 kHz; mono and stereo) and
    three seeded uint8 `.npy` clips."""
    rng = np.random.default_rng(0)
    wavs = [_write_wav(str(tmp_path / f"a{i}.wav"), seconds, sr=sr, channels=ch,
                       freq=300 + 100 * i)
            for i, (seconds, sr, ch) in enumerate([(0.4, 16_000, 1), (12.0, 22_050, 2),
                                                   (3.0, 44_100, 1), (10.5, 16_000, 2),
                                                   (1.0, 22_050, 1), (0.9, 16_000, 2)])]
    clips = []
    for i, shape in enumerate([(16, 40, 56, 3), (9, 64, 48, 3), (24, 36, 36, 3)]):
        p = str(tmp_path / f"c{i}.npy")
        np.save(p, rng.integers(0, 256, shape, dtype=np.uint8))
        clips.append(p)
    return tmp_path, wavs, clips


@pytest.mark.parametrize("media", ["audio", "audio_video"])
def test_jsonl_audio_batches_match_jax(av_files, media):
    root, wavs, clips = av_files
    anno = root / f"{media}.jsonl"
    rows = [{"audio": os.path.basename(w), "caption": f"tone number {i}"} for i, w in
            enumerate(wavs)]
    if media == "audio_video":
        rows = [dict(r, video=os.path.basename(clips[i % 3])) for i, r in enumerate(rows)]
    anno.write_text("".join(json.dumps(r) + "\n" for r in rows))
    kw = dict(num_frames=3, img_size=24, max_length=8, seed=1, media_root=str(root),
              media_type=media)
    for train in (True, False):
        got_ds = tds.JsonlVideoTextDataset(str(anno), ToyTokenizer(), **kw)
        want_ds = jds.JsonlVideoTextDataset(str(anno), JToyTokenizer(), **kw)
        assert got_ds.items == want_ds.items
        got, want = got_ds.batches(4, train=train), want_ds.batches(4, train=train)
        for _ in range(2):
            g, w = next(got), next(want)
            assert g.keys() == w.keys() and ("video" in g) == (media == "audio_video")
            assert g["audio"].shape == (4, 998, 64) and g["audio_padding_mask"].dtype == bool
            for k in g:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
