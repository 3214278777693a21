"""Action-recognition evaluation: top-k validation + multi-view final test.

Port of internvideo_tpu/eval/classification.py:22-120. Each video is
sampled as several views; per-view softmax probabilities are summed per
video id, then top-1/5 is computed on the ensemble. `forward` may return a
torch tensor (on any device) or a numpy array. Merging views across hosts
(`merge_hosts=True`) is not ported yet (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable

import numpy as np
import torch


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def topk_accuracy(logits: np.ndarray, labels: np.ndarray, ks=(1, 5)):
    order = np.argsort(-logits, axis=-1)
    out = {}
    for k in ks:
        hit = (order[:, :k] == labels[:, None]).any(axis=1)
        out[f"top{k}"] = 100.0 * float(hit.mean())
    return out


def validate(
    forward: Callable,  # batch["video"] -> logits
    data: Iterable[dict],
) -> dict:
    all_logits, all_labels = [], []
    for batch in data:
        all_logits.append(_to_numpy(forward(batch["video"])))
        all_labels.append(np.asarray(batch["label"]))
    return topk_accuracy(
        np.concatenate(all_logits), np.concatenate(all_labels)
    )


class MultiViewAccumulator:
    """Softmax-ensemble across views of the same video (merge stage)."""

    def __init__(self):
        self.probs: dict = collections.defaultdict(float)
        self.labels: dict = {}

    def add(self, video_ids, logits: np.ndarray, labels: np.ndarray):
        logits = logits - logits.max(-1, keepdims=True)
        probs = np.exp(logits)
        probs /= probs.sum(-1, keepdims=True)
        for vid, p, y in zip(video_ids, probs, labels):
            self.probs[vid] = self.probs[vid] + p
            self.labels[vid] = int(y)

    def merge(self, other_probs: dict, other_labels: dict):
        """Fold another host's accumulated views in."""
        for vid, p in other_probs.items():
            self.probs[vid] = self.probs[vid] + p
        self.labels.update(other_labels)

    def result(self, ks=(1, 5)) -> dict:
        vids = sorted(self.probs)
        logits = np.stack([self.probs[v] for v in vids])
        labels = np.array([self.labels[v] for v in vids])
        out = topk_accuracy(logits, labels, ks)
        out["num_videos"] = len(vids)
        return out


def final_test(
    forward: Callable,  # video -> logits
    view_iter: Iterable[dict],  # {"video", "label", "video_id"} per view-batch
    *,
    merge_hosts: bool = False,
) -> dict:
    """Multi-view softmax ensemble over the views in `view_iter`."""
    if merge_hosts:
        raise NotImplementedError(
            "merge_hosts is not ported yet (ROADMAP queue 1, item 8)")
    acc = MultiViewAccumulator()
    for batch in view_iter:
        logits = _to_numpy(forward(batch["video"]))
        acc.add(batch["video_id"], logits, np.asarray(batch["label"]))
    return acc.result()
