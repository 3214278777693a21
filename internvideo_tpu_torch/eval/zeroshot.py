"""Zero-shot action classification via prompt-ensemble class embeddings.

Port of internvideo_tpu/eval/zeroshot.py. The encoders may return torch
tensors (on any device, any float dtype) or numpy arrays; scoring is numpy
in fp32 (the JAX module's numpy on fp32 device_get results; a bf16
model's projections are widened to fp32 here). JAX's padding of a ragged
last video batch only kept the TPU compile to one program, so it is
dropped: each clip's embedding does not depend on the rest of its batch.

The reference evaluates UCF101/K400/K600 zero-shot by embedding each
class name under a bank of prompt templates, averaging the normalized
text embeddings into one classifier vector per class, and ranking video
embeddings against them (multi_modality/dataset/text_prompt.py templates;
tasks_clip zero-shot configs, e.g. evaluation/clip/zero_shot/1B/
config_ucf101.py). Templates are the public ActionCLIP/CLIP prompt sets
the reference ships.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np

from internvideo_tpu_torch.eval.classification import _to_numpy

# text_prompt.py:1-18 (ActionCLIP prompt set)
KINETICS_TEMPLATES_ACTION_CLIP = (
    "a photo of action {}",
    "a picture of action {}",
    "Human action of {}",
    "{}, an action",
    "{} this is an action",
    "{}, a video of action",
    "Playing action of {}",
    "{}",
    "Playing a kind of action, {}",
    "Doing a kind of action, {}",
    "Look, the human is {}",
    "Can you recognize the action of {}?",
    "Video classification of {}",
    "A video of {}",
    "The man is {}",
    "The woman is {}",
)

# text_prompt.py:20-49 (CLIP-style action prompt set)
KINETICS_TEMPLATES = (
    "A photo of action {}.",
    "A video of action {}.",
    "He or she is {}.",
    "A person is doing {}.",
    "Look, the human is {}.",
    "Human action of {}.",
    "Playing action of {}.",
    "Video classification of {}.",
    "Doing a kind of action, {}.",
    "Playing a kind of action, {}.",
    "Can you recognize the action of {}?",
    "{}, an action.",
    "{} this is an action.",
    "{}, a video of action.",
    "An action of {} is in the video.",
    "There is a person doing {} in the video.",
    "A photo of a person doing {}.",
    "A photo of a person performing {}.",
    "A photo of a person practicing {}.",
    "A video of a person doing {}.",
    "A video of a person performing {}.",
    "A video of a person practicing {}.",
    "A example of a person doing {}.",
    "A example of a person performing {}.",
    "A example of a person practicing {}.",
    "A demonstration of a person doing {}.",
    "A demonstration of a person performing {}.",
    "A demonstration of a person practicing {}.",
)


def build_zero_shot_classifier(
    encode_texts: Callable[[list[str]], np.ndarray],  # texts -> (N, E)
    class_names: Sequence[str],
    templates: Sequence[str] = KINETICS_TEMPLATES,
) -> np.ndarray:
    """-> (C, E) L2-normalized classifier: per class, the normalized mean
    of its normalized per-template embeddings (standard CLIP ensembling)."""
    weights = []
    for name in class_names:
        emb = _to_numpy(encode_texts([t.format(name) for t in templates]))
        emb = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
        mean = emb.mean(axis=0)
        weights.append(mean / np.linalg.norm(mean))
    return np.stack(weights)


def zero_shot_eval(
    encode_video: Callable,  # video batch -> (B, E) embeddings
    classifier: np.ndarray,  # (C, E)
    data: Iterable[dict],  # {"video", "label"} batches
) -> dict:
    correct1 = correct5 = total = 0
    for batch in data:
        v = _to_numpy(encode_video(np.asarray(batch["video"])))
        v = v / np.linalg.norm(v, axis=-1, keepdims=True)
        scores = v @ classifier.T  # (B, C)
        labels = np.asarray(batch["label"])
        top5 = np.argsort(-scores, axis=-1)[:, :5]
        correct1 += int((top5[:, 0] == labels).sum())
        correct5 += int((top5 == labels[:, None]).any(-1).sum())
        total += len(labels)
    return {
        "top1": 100.0 * correct1 / max(total, 1),
        "top5": 100.0 * correct5 / max(total, 1),
        "n": total,
    }
