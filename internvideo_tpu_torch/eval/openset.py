"""Open-set action recognition: OpenMax calibration + open-set metrics.

Port of internvideo_tpu/eval/openset.py, host numpy as there, the
counterpart of the InternVideo1 open-set suite (InternVideo1/Downstream/
Open-Set-Action-Recognition, libMR Weibull meta-recognition): per-class
extreme-value models are fit on the distances between correctly-classified
training activations and their class mean; at test time each logit is
recalibrated by its Weibull tail probability, mass is shifted to an
"unknown" bucket, and open-set accuracy / OSCR-style metrics are reported.
Fitting rides the C++ libMR port (ops/native.py:MetaRecognition).
"""

from __future__ import annotations

import numpy as np

from internvideo_tpu_torch.ops.native import MetaRecognition


class OpenMax:
    def __init__(self, tail_size: int = 20, alpha: int = 3):
        self.tail_size = tail_size
        self.alpha = alpha
        self.means: np.ndarray | None = None  # (C, D)
        self.models: list[MetaRecognition] = []

    def fit(self, feats: np.ndarray, labels: np.ndarray, logits: np.ndarray):
        """Fit per-class Weibulls on distances of CORRECT train samples to
        their class activation mean (the OpenMax recipe libMR serves)."""
        c = int(labels.max()) + 1
        d = feats.shape[1]
        self.means = np.zeros((c, d))
        self.models = []
        correct = np.argmax(logits, 1) == labels
        for k in range(c):
            m = (labels == k) & correct
            if m.sum() == 0:
                m = labels == k
            self.means[k] = feats[m].mean(0)
            dist = np.linalg.norm(feats[m] - self.means[k], axis=1)
            mr = MetaRecognition()
            mr.fit_high(dist, tail_size=min(self.tail_size, max(len(dist), 2)))
            self.models.append(mr)
        return self

    def recalibrate(self, feats: np.ndarray, logits: np.ndarray):
        """-> (C+1,) probabilities per row; last bucket = unknown."""
        n, c = logits.shape
        out = np.zeros((n, c + 1))
        ranks = np.argsort(-logits, axis=1)
        for i in range(n):
            dist = np.linalg.norm(feats[i][None] - self.means, axis=1)
            w = np.asarray(
                [self.models[k].w_score(np.asarray([dist[k]]))[0]
                 for k in range(c)]
            )
            # only the top-alpha classes get attenuated (OpenMax)
            scale = np.ones(c)
            for r, k in enumerate(ranks[i, : self.alpha]):
                scale[k] = 1.0 - w[k] * (self.alpha - r) / self.alpha
            v = logits[i] * scale
            v_unknown = np.sum(logits[i] * (1.0 - scale))
            e = np.exp(np.concatenate([v, [v_unknown]])
                       - max(v.max(), v_unknown))
            out[i] = e / e.sum()
        return out


def openset_metrics(
    probs: np.ndarray,  # (N, C+1) recalibrated (last = unknown)
    labels: np.ndarray,  # (N,) with -1 for unknown-class samples
) -> dict:
    """Closed accuracy, unknown detection rate, and open-set accuracy."""
    c = probs.shape[1] - 1
    pred = np.argmax(probs, 1)
    known = labels >= 0
    closed_acc = float(np.mean(pred[known] == labels[known])) if known.any() else 0.0
    unk_rate = float(np.mean(pred[~known] == c)) if (~known).any() else 0.0
    open_correct = np.where(known, pred == labels, pred == c)
    return {
        "closed_acc": closed_acc,
        "unknown_detection_rate": unk_rate,
        "open_acc": float(np.mean(open_correct)),
    }
