"""Multiple-choice QA evaluation (MSRVTT-MC etc.).

Port of internvideo_tpu/eval/mcqa.py. The encoders and the rerank scorer
may return torch tensors (on any device) or numpy arrays; scoring is numpy
in fp32, as in JAX.

Counterpart of tasks_clip/retrieval_mc.py: for each video, score its K
candidate answers with the dual encoders (cosine similarity of projections),
predict the argmax, report accuracy. Optionally a cross-encoder rerank
scorer refines the dual-encoder scores, as the fusion tower does for
retrieval.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np

from internvideo_tpu_torch.eval.classification import _to_numpy


def mcqa_accuracy(
    encode_video: Callable,  # video batch -> (B, E) projections
    encode_choices: Callable,  # ids (B*K, L) -> (B*K, E) projections
    data: Iterable[dict],  # {"video", "choice_ids", "answer"} per batch;
    # choice_ids: (B, K, L); answer: (B,) index of the correct choice
    rerank: Optional[Callable] = None,  # (video_batch, ids (B,K,L)) -> (B,K)
) -> dict:
    correct, total = 0, 0
    all_scores, all_answers = [], []
    for batch in data:
        v = _to_numpy(encode_video(batch["video"]))
        b, k, l = batch["choice_ids"].shape
        t = _to_numpy(
            encode_choices(batch["choice_ids"].reshape(b * k, l))
        ).reshape(b, k, -1)
        v = v / np.linalg.norm(v, axis=-1, keepdims=True)
        t = t / np.linalg.norm(t, axis=-1, keepdims=True)
        scores = np.einsum("be,bke->bk", v, t)
        if rerank is not None:
            scores = scores + _to_numpy(
                rerank(batch["video"], batch["choice_ids"])
            )
        pred = scores.argmax(-1)
        correct += int((pred == np.asarray(batch["answer"])).sum())
        total += b
        all_scores.append(scores)
        all_answers.append(np.asarray(batch["answer"]))
    out = {"accuracy": 100.0 * correct / max(total, 1), "num": total}
    if all_scores and all(
        s.shape[1] == all_scores[0].shape[1] for s in all_scores
    ):
        out["mAP"] = float(multiple_choice_map(
            np.concatenate(all_scores), np.concatenate(all_answers)
        ))
    return out


def multiple_choice_map(scores: np.ndarray, answers: np.ndarray) -> float:
    """Mean average precision over option slots — the reference's
    torchnet mAPMeter in retrieval_mc2.py: per option position k, rank
    all questions by score[:, k] and average precision-at-positive over
    questions whose answer is k; mean over positions (skipping positions
    that are never the answer)."""
    n, k = scores.shape
    onehot = np.zeros((n, k), bool)
    onehot[np.arange(n), answers] = True
    aps = []
    for j in range(k):
        pos = onehot[:, j]
        if not pos.any():
            continue
        order = np.argsort(-scores[:, j], kind="stable")
        hits = pos[order]
        cum = np.cumsum(hits)
        ranks = np.arange(1, n + 1)
        aps.append(float((cum[hits] / ranks[hits]).mean()))
    return 100.0 * float(np.mean(aps)) if aps else 0.0
