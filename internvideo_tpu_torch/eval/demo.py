"""Demo-grade inference helpers (multi_modality/demo/utils.py parity).

Port of internvideo_tpu/eval/demo.py. The encoders may return torch
tensors (on any device) or numpy arrays. `preprocess_clip` resizes with
cv2 (data/transforms.py imports it there).

`retrieve_text` — rank a list of candidate captions for one clip with a
dual-encoder model (demo/utils.py:53): decode+preprocess frames, encode
both sides, return the top-k texts with softmax probabilities.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from internvideo_tpu_torch.data import transforms
from internvideo_tpu_torch.eval.classification import _to_numpy


def preprocess_clip(
    frames: np.ndarray,  # (T, H, W, 3) uint8
    size: int = 224,
) -> np.ndarray:
    clip = transforms.resize_short_side(frames, size)
    clip = transforms.center_crop(clip, size)
    return transforms.normalize(clip)[None]  # (1, T, size, size, 3)


def retrieve_text(
    frames: np.ndarray,  # (T, H, W, 3) uint8
    texts: Sequence[str],
    *,
    encode_video: Callable,  # (1, T, H, W, 3) -> (1, E)
    encode_text: Callable,  # tokenized batch -> (N, E)
    tokenize: Callable,  # list[str] -> model-ready batch
    topk: int = 5,
    temperature: float = 100.0,
    img_size: int = 224,
):
    clip = preprocess_clip(frames, img_size)
    v = _to_numpy(encode_video(clip))[0]
    t = _to_numpy(encode_text(tokenize(list(texts))))
    v = v / np.linalg.norm(v)
    t = t / np.linalg.norm(t, axis=-1, keepdims=True)
    scores = temperature * t @ v
    probs = np.exp(scores - scores.max())
    probs /= probs.sum()
    order = np.argsort(-probs)[:topk]
    return [texts[i] for i in order], probs[order]
