"""Temporal action localization: proposal decoding + NMS + mAP.

Port of internvideo_tpu/eval/temporal_detection.py (the InternVideo1 TAL
suite's inference path: actionformer-style per-timestep decoding,
nms_cpu.cpp suppression, the ANETdetection tIoU-threshold mAP). Decoding,
NMS and the metric are host numpy, as in JAX, over the port's C++ NMS
(ops/native.py). One departure: `nms_proposals(soft=True)` returns the
kept segments capped at `max_keep`, where the JAX function passes
`max_keep` to `soft_temporal_nms`, which takes none, and raises
(ROADMAP queue 3).
"""

from __future__ import annotations

import numpy as np

from internvideo_tpu_torch.ops.native import soft_temporal_nms, temporal_nms


def decode_proposals(
    scores: np.ndarray,  # (T, C) per-timestep class probabilities
    left: np.ndarray,  # (T,) predicted distance to segment start
    right: np.ndarray,  # (T,) predicted distance to segment end
    *,
    stride: float = 1.0,
    score_threshold: float = 0.05,
    max_per_class: int = 200,
):
    """Anchor-free decoding (actionformer recipe): every timestep t whose
    class score passes the threshold proposes [t - left_t, t + right_t].
    Returns (segments (N, 2), seg_scores (N,), labels (N,))."""
    t_idx = np.arange(scores.shape[0], dtype=np.float32) * stride
    segs, scs, labs = [], [], []
    for c in range(scores.shape[1]):
        sc = scores[:, c]
        keep = np.nonzero(sc >= score_threshold)[0]
        if keep.size == 0:
            continue
        order = keep[np.argsort(-sc[keep])][:max_per_class]
        start = t_idx[order] - left[order] * stride
        end = t_idx[order] + right[order] * stride
        segs.append(np.stack([start, end], axis=1))
        scs.append(sc[order])
        labs.append(np.full(order.shape, c, np.int32))
    if not segs:
        return (
            np.zeros((0, 2), np.float32),
            np.zeros((0,), np.float32),
            np.zeros((0,), np.int32),
        )
    return (
        np.concatenate(segs).astype(np.float32),
        np.concatenate(scs).astype(np.float32),
        np.concatenate(labs),
    )


def nms_proposals(
    segments: np.ndarray,
    scores: np.ndarray,
    labels: np.ndarray,
    *,
    iou_threshold: float = 0.5,
    soft: bool = False,
    sigma: float = 0.5,
    max_keep: int = 100,
):
    """Per-class (soft-)NMS over decoded proposals."""
    out_s, out_sc, out_l = [], [], []
    for c in np.unique(labels):
        m = labels == c
        if soft:
            idx, ksc = soft_temporal_nms(segments[m], scores[m], sigma=sigma)
            kept, ksc = segments[m][idx[:max_keep]], ksc[:max_keep]
        else:
            keep = temporal_nms(
                segments[m], scores[m], iou_threshold=iou_threshold,
                max_keep=max_keep,
            )
            kept, ksc = segments[m][keep], scores[m][keep]
        out_s.append(kept)
        out_sc.append(ksc)
        out_l.append(np.full(len(ksc), c, np.int32))
    if not out_s:
        return segments[:0], scores[:0], labels[:0]
    return (
        np.concatenate(out_s),
        np.concatenate(out_sc),
        np.concatenate(out_l),
    )


def _tiou(seg: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(N, 2) × (M, 2) -> (N, M) temporal IoU."""
    inter = np.maximum(
        0.0,
        np.minimum(seg[:, None, 1], gt[None, :, 1])
        - np.maximum(seg[:, None, 0], gt[None, :, 0]),
    )
    union = (
        (seg[:, 1] - seg[:, 0])[:, None]
        + (gt[:, 1] - gt[:, 0])[None, :]
        - inter
    )
    return inter / np.maximum(union, 1e-8)


def detection_map(
    predictions: dict,  # video_id -> (segments, scores, labels)
    ground_truth: dict,  # video_id -> (segments, labels)
    *,
    tiou_thresholds=(0.3, 0.4, 0.5, 0.6, 0.7),
    num_classes: int = None,
) -> dict:
    """Interpolated average precision per class per tIoU (ANETdetection
    protocol), averaged to mAP@tIoU and the headline average mAP."""
    if num_classes is None:
        num_classes = 1 + max(
            (int(l.max()) for _, l in ground_truth.values() if len(l)),
            default=0,
        )
    results = {}
    for thr in tiou_thresholds:
        aps = []
        for c in range(num_classes):
            rows = []  # (score, matched)
            npos = 0
            for vid, (gt_segs, gt_labels) in ground_truth.items():
                gmask = gt_labels == c
                gt_c = gt_segs[gmask]
                npos += len(gt_c)
                if vid not in predictions:
                    continue
                segs, scores, labels = predictions[vid]
                pmask = labels == c
                segs_c, sc_c = segs[pmask], scores[pmask]
                if len(segs_c) == 0:
                    continue
                order = np.argsort(-sc_c)
                taken = np.zeros(len(gt_c), bool)
                iou = _tiou(segs_c, gt_c) if len(gt_c) else np.zeros(
                    (len(segs_c), 0)
                )
                for i in order:
                    j = int(np.argmax(iou[i])) if iou.shape[1] else -1
                    if j >= 0 and iou[i, j] >= thr and not taken[j]:
                        taken[j] = True
                        rows.append((sc_c[i], 1))
                    else:
                        rows.append((sc_c[i], 0))
            if npos == 0:
                continue
            if not rows:
                aps.append(0.0)
                continue
            rows.sort(key=lambda r: -r[0])
            matched = np.asarray([r[1] for r in rows], np.float64)
            tp = np.cumsum(matched)
            fp = np.cumsum(1 - matched)
            recall = tp / npos
            precision = tp / np.maximum(tp + fp, 1e-8)
            # interpolated AP (precision envelope)
            for i in range(len(precision) - 2, -1, -1):
                precision[i] = max(precision[i], precision[i + 1])
            idx = np.nonzero(np.diff(np.concatenate([[0.0], recall])))[0]
            aps.append(float(np.sum(precision[idx] * np.diff(
                np.concatenate([[0.0], recall])
            )[idx])))
        results[f"mAP@{thr}"] = float(np.mean(aps)) if aps else 0.0
    results["average_mAP"] = float(
        np.mean([results[f"mAP@{t}"] for t in tiou_thresholds])
    )
    return results
