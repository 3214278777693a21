"""Audio frontends and the simple audio tower: PyTorch port.

Port of internvideo_tpu/models/audio.py. The host frontends are numpy and
copied as they are (the port imports nothing of the JAX package):

  * `mel_filterbank` / `log_mel_spectrogram`: the HTK-style log-mel
    features of the from-scratch tower;
  * `kaldi_fbank` / `beats_preprocess`: the Kaldi fbank BEATs consumes
    (torchaudio.compliance.kaldi defaults: snip-edges framing, DC removal,
    0.97 pre-emphasis, povey window, 512-point power spectrum, Kaldi mel
    banks from 20 Hz, natural log), then x 2^15 scaling in and
    (fbank - 15.41663) / (2 * 6.55582) out.

`AudioEncoder` is the from-scratch tower of the audio-visual stage-2 model
(`audio_tower="simple"`): 16 x 16 spectrogram patches through one Dense
GEMM (the JAX reshape, time-major), a learned pos embed sliced to the patch
count, pre-norm LayerNorm `Block`s without QK norm or LayerScale, a final
LayerNorm and a mean pool. Its attention goes through
`dot_product_attention` (K2 / K4b on the card at S <= 1024). The
checkpoint-faithful BEATs tower is models/beats.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from internvideo_tpu_torch.nn.dense import Dense
from internvideo_tpu_torch.nn.norms import LayerNorm
from internvideo_tpu_torch.nn.transformer import Block

# ---------------------------------------------------------------------------
# host-side fbank frontends (numpy, as the JAX module)
# ---------------------------------------------------------------------------


def mel_filterbank(n_mels=128, n_fft=400, sr=16000, fmin=0.0, fmax=8000.0):
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * freqs / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        l, c, r = bins[i], bins[i + 1], bins[i + 2]
        if c > l:
            fb[i, l:c] = (np.arange(l, c) - l) / (c - l)
        if r > c:
            fb[i, c:r] = (r - np.arange(c, r)) / (r - c)
    return fb.astype(np.float32)


def log_mel_spectrogram(
    wav: np.ndarray, *, sr=16000, n_fft=400, hop=160, n_mels=128
) -> np.ndarray:
    """(num_samples,) -> (frames, n_mels) log-mel features (host)."""
    window = np.hanning(n_fft).astype(np.float32)
    n = 1 + max(len(wav) - n_fft, 0) // hop
    frames = np.stack([
        wav[i * hop:i * hop + n_fft] * window for i in range(n)
    ])
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
    mel = spec @ mel_filterbank(n_mels, n_fft, sr).T
    return np.log(mel + 1e-6).astype(np.float32)


def _povey_window(n: int) -> np.ndarray:
    # kaldi "povey" window = hann^0.85
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))) ** 0.85


def _kaldi_mel_banks(n_mels, n_fft, sr, low_freq=20.0, high_freq=0.0):
    """Kaldi mel filterbank (triangular in mel domain, bins over FFT freqs;
    differs from the HTK/librosa variant used by mel_filterbank above)."""
    if high_freq <= 0.0:
        high_freq = sr / 2 + high_freq
    mel = lambda f: 1127.0 * np.log(1.0 + f / 700.0)  # noqa: E731
    mel_lo, mel_hi = mel(low_freq), mel(high_freq)
    mel_delta = (mel_hi - mel_lo) / (n_mels + 1)
    fft_freqs = np.arange(n_fft // 2 + 1) * (sr / n_fft)
    fft_mel = mel(fft_freqs)
    banks = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for i in range(n_mels):
        left = mel_lo + i * mel_delta
        center = left + mel_delta
        right = center + mel_delta
        up = (fft_mel - left) / (center - left)
        down = (right - fft_mel) / (right - center)
        banks[i] = np.maximum(0.0, np.minimum(up, down))
    return banks


def kaldi_fbank(
    wav: np.ndarray,  # (num_samples,) float waveform
    *,
    sr: int = 16000,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    n_mels: int = 128,
    preemphasis: float = 0.97,
    remove_dc: bool = True,
) -> np.ndarray:
    """Kaldi-style log-mel fbank as BEATs' preprocess invokes
    torchaudio.compliance.kaldi (128 mels, 25 / 10 ms frames): snip-edges
    framing, DC removal, pre-emphasis, povey window, power spectrum over the
    frame length rounded up to a power of two, Kaldi mel banks (low 20 Hz),
    natural log floored at 1.1921e-07. -> (frames, n_mels)."""
    frame_len = int(sr * frame_length_ms / 1000)  # 400
    shift = int(sr * frame_shift_ms / 1000)  # 160
    n_fft = 1 << (frame_len - 1).bit_length()  # 512
    if len(wav) < frame_len:
        return np.zeros((0, n_mels), np.float32)
    n = 1 + (len(wav) - frame_len) // shift
    idx = np.arange(frame_len)[None, :] + shift * np.arange(n)[:, None]
    frames = wav[idx].astype(np.float64)
    if remove_dc:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if preemphasis:
        pre = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - preemphasis * pre
    frames = frames * _povey_window(frame_len)
    spec = np.abs(np.fft.rfft(frames, n=n_fft, axis=1)) ** 2
    mel = spec @ _kaldi_mel_banks(n_mels, n_fft, sr).T
    return np.log(np.maximum(mel, 1.1921e-07)).astype(np.float32)


def beats_preprocess(
    wav: np.ndarray, *, fbank_mean: float = 15.41663,
    fbank_std: float = 6.55582, n_mels: int = 128,
) -> np.ndarray:
    """Waveform -> normalized fbank as BEATs.preprocess: x 2^15, then
    (fbank - mean) / (2 * std). 128 mels is the BEATs encoder's geometry;
    the stage-2 audio-visual data path uses the same recipe at 64 mels."""
    fb = kaldi_fbank(np.asarray(wav, np.float64) * 2 ** 15, n_mels=n_mels)
    return (fb - fbank_mean) / (2 * fbank_std)


# ---------------------------------------------------------------------------
# the simple tower
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AudioEncoderConfig:
    """Same fields and defaults as internvideo_tpu's AudioEncoderConfig."""

    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    patch_size: int = 16
    n_mels: int = 128
    max_frames: int = 1024  # spectrogram frames (time patches come from this)
    dtype: str = "float32"
    param_dtype: str = "float32"
    attn_impl: str = "auto"


class AudioEncoder(nn.Module):
    """fbank (B, frames, n_mels) -> (tokens (B, N, D), pooled (B, D)).

    Flax names: `patch_embed`, `pos_embed` ((max_frames / p) * (n_mels / p),
    D), `blocks.{i}`, `norm`. The blocks keep fp32 weights whatever
    `param_dtype` is, as the JAX Blocks (which are not given it) do."""

    def __init__(self, config: AudioEncoderConfig, *, device, generator: torch.Generator):
        super().__init__()
        self.config = cfg = config
        dtype = getattr(torch, cfg.dtype)
        param_dtype = getattr(torch, cfg.param_dtype)
        self.dtype = dtype
        p, d = cfg.patch_size, cfg.embed_dim
        self.patch_embed = Dense(p * p, d, dtype=dtype, param_dtype=param_dtype, device=device)
        n = (cfg.max_frames // p) * (cfg.n_mels // p)
        self.pos_embed = nn.Parameter(torch.empty(n, d, dtype=param_dtype, device=device))
        self.blocks = nn.ModuleList(
            Block(d, cfg.num_heads, mlp_ratio=cfg.mlp_ratio, qk_normalization=False,
                  init_values=None, attn_impl=cfg.attn_impl, norm_type="layernorm",
                  dtype=dtype, device=device)
            for _ in range(cfg.depth))
        self.norm = LayerNorm(d, dtype=dtype, device=device)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init in module order: normal(0.02) pos embed, then
        truncated-normal(0.02) Dense weights and zero biases."""
        self.pos_embed.copy_(torch.randn(self.pos_embed.shape, generator=generator,
                                         device=self.pos_embed.device) * 0.02)
        for m in self.modules():
            if isinstance(m, Dense):
                m.init_weights(generator)

    def forward(self, fbank: torch.Tensor, deterministic: bool = True):
        cfg = self.config
        p = cfg.patch_size
        b, t, m = fbank.shape
        if t % p or m % p:
            raise ValueError(f"fbank {tuple(fbank.shape)} does not tile by {p} x {p}")
        x = fbank.reshape(b, t // p, p, m // p, p)
        x = x.permute(0, 1, 3, 2, 4).reshape(b, (t // p) * (m // p), p * p)
        x = self.patch_embed(x.to(self.dtype))
        x = x + self.pos_embed[: x.shape[1]].to(self.dtype)[None]
        for blk in self.blocks:
            x = blk(x, deterministic)
        x = self.norm(x)
        return x, x.mean(dim=1)

