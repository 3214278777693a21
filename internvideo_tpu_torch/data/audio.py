"""Audio file ingestion: wav reading, resampling, demuxing audio from a
video, and the BEATs fbank clip loader.

Port of internvideo_tpu/data/audio.py, a copy (numpy and scipy on the
host; the port imports nothing of the JAX package). The reference's audio
data path (av_utils.py load_audio_av): decode the audio stream, downmix to
mono, resample to 16 kHz, crop a random `max_audio_length` window, and
make the Kaldi fbank BEATs consumes (x 2^15, (x - 15.41663) / (2 *
6.55582)), zero-padded to 998 frames with a padding mask.

Readers, best first:

  wav files      scipy.io.wavfile
  video demux    PyAV when importable, else the ffmpeg binary, else a
                 RuntimeError naming both missing backends

PyAV and ffmpeg are optional: only demuxing needs one of them. The fbank
math is models/audio.py's (`kaldi_fbank`, `beats_preprocess`).
"""

from __future__ import annotations

import math
import shutil
import subprocess
from typing import Optional

import numpy as np

from internvideo_tpu_torch.models.audio import beats_preprocess

DEFAULT_SR = 16_000
# reference fbank geometry: 10 s at 16 kHz with 25 ms / 10 ms Kaldi framing
# -> 998 frames of 64 mels
DEFAULT_MAX_SECONDS = 10
DEFAULT_TARGET_FRAMES = 998

_WAV_EXT = (".wav", ".wave")


def _to_float_mono(data: np.ndarray) -> np.ndarray:
    """PCM int / float samples of shape (n,) or (n, ch) -> float32 mono in
    [-1, 1] (stereo downmix by mean)."""
    if data.ndim == 2:
        data = data.mean(axis=1)
    if np.issubdtype(data.dtype, np.integer):
        info = np.iinfo(data.dtype)
        if data.dtype == np.uint8:  # 8-bit wav is unsigned, midpoint 128
            data = (data.astype(np.float32) - 128.0) / 128.0
        else:
            data = data.astype(np.float32) / max(abs(info.min), info.max)
    return np.asarray(data, np.float32)


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """-> (float32 mono waveform in [-1, 1], native sample rate)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    return _to_float_mono(data), int(sr)


def resample_audio(wav: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample (scipy `resample_poly`), the reference's
    torchaudio Resample role."""
    if sr == target_sr:
        return wav
    from scipy.signal import resample_poly

    g = math.gcd(sr, target_sr)
    return resample_poly(wav, target_sr // g, sr // g).astype(np.float32)


def read_audio_from_video(
    path: str, target_sr: int = DEFAULT_SR
) -> tuple[np.ndarray, int]:
    """Demux + decode a video file's audio track -> (float32 mono, sr).

    PyAV first, the ffmpeg binary next (decodes straight to mono s16le at
    target_sr); raises RuntimeError when neither backend exists or the file
    has no audio.
    """
    try:
        import av  # noqa: F401

        return _read_audio_av(path)
    except ImportError:
        pass
    if shutil.which("ffmpeg"):
        return _read_audio_ffmpeg(path, target_sr), target_sr
    raise RuntimeError(
        f"cannot demux audio from {path!r}: PyAV is not installed and no "
        "ffmpeg binary is on PATH"
    )


def _read_audio_av(path: str) -> tuple[np.ndarray, int]:
    import av

    with av.open(path) as container:
        if not container.streams.audio:
            raise RuntimeError(f"{path!r} has no audio stream")
        stream = container.streams.audio[0]
        sr = int(stream.sample_rate)
        frames = [f.to_ndarray() for f in container.decode(audio=0)]
    if not frames:
        raise RuntimeError(f"{path!r}: audio stream decoded to 0 frames")
    raw = np.concatenate(frames, axis=1)  # (ch, n)
    return _to_float_mono(raw.T), sr


def _read_audio_ffmpeg(path: str, target_sr: int) -> np.ndarray:
    proc = subprocess.run(
        [
            "ffmpeg", "-v", "error", "-i", path, "-vn",
            "-f", "s16le", "-acodec", "pcm_s16le",
            "-ac", "1", "-ar", str(target_sr), "-",
        ],
        capture_output=True,
    )
    if proc.returncode != 0 or not proc.stdout:
        raise RuntimeError(
            f"ffmpeg failed to extract audio from {path!r}: "
            f"{proc.stderr.decode(errors='replace')[-500:]}"
        )
    return _to_float_mono(np.frombuffer(proc.stdout, np.int16).copy())


def read_audio(
    path: str, target_sr: int = DEFAULT_SR
) -> np.ndarray:
    """Any supported audio source -> float32 mono waveform at target_sr."""
    if path.lower().endswith(_WAV_EXT):
        wav, sr = read_wav(path)
    else:
        wav, sr = read_audio_from_video(path, target_sr)
    return resample_audio(wav, sr, target_sr)


def load_fbank(
    path: str,
    *,
    sr: int = DEFAULT_SR,
    max_audio_length: int = DEFAULT_MAX_SECONDS,
    target_frames: int = DEFAULT_TARGET_FRAMES,
    n_mels: int = 64,
    rng: Optional[np.random.Generator] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """File -> (fbank (target_frames, n_mels) f32, padding_mask (target_frames,)
    bool, True at padded rows).

    Crops a random max_audio_length-second window when longer (start 0 when
    rng is None: deterministic eval), applies BEATs' preprocess, and
    zero-pads or crops the frame axis to target_frames.
    """
    wav = read_audio(path, sr)
    max_samples = max_audio_length * sr
    if wav.shape[0] > max_samples:
        start = (
            int(rng.integers(0, wav.shape[0] - max_samples + 1))
            if rng is not None else 0
        )
        wav = wav[start:start + max_samples]
    fb = np.asarray(
        beats_preprocess(wav, n_mels=n_mels), np.float32
    )  # (frames, n_mels)
    n = fb.shape[0]
    if n > target_frames:
        fb, n = fb[:target_frames], target_frames
    out = np.zeros((target_frames, fb.shape[1]), np.float32)
    out[:n] = fb
    mask = np.ones((target_frames,), bool)
    mask[:n] = False
    return out, mask
