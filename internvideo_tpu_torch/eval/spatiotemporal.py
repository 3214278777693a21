"""Spatio-temporal action localization: ROI action head + frame-level mAP.

Port of internvideo_tpu/eval/spatiotemporal.py, the counterpart of the
InternVideo1 alphaction suite (InternVideo1/Downstream/
Spatial-Temporal-Action-Localization): per-person-box action
classification over video backbone features (the AVA protocol) --
ROIAlign3D features, temporal average, a classifier head, and
frame-mAP@IoU evaluation. The feature map and the ROIs go to the caller's
device and ride ops/roi_align3d.py; box matching and AP are host numpy, as
in JAX.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from internvideo_tpu_torch.ops.roi_align3d import roi_align_3d


def roi_action_features(
    features: torch.Tensor,  # (B, T, H, W, C) backbone feature map
    boxes: torch.Tensor,  # (N, 5): (batch_idx, x1, y1, x2, y2) in feature coords
    *,
    output_size=(7, 7),
    spatial_scale: float = 1.0,
) -> torch.Tensor:
    """-> (N, C) per-box descriptors: ROIAlign3D, then average over time and
    the spatial grid (alphaction's head input)."""
    roi = roi_align_3d(
        features, boxes, output_size=output_size,
        spatial_scale=spatial_scale,
    )  # (N, T, oh, ow, C)
    return roi.mean(dim=(1, 2, 3))


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) × (M, 4) xyxy -> (N, M) IoU."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-8)


def frame_map(
    predictions: dict,  # frame_id -> (boxes (N,4), scores (N,C))
    ground_truth: dict,  # frame_id -> (boxes (M,4), labels (M,) int)
    *,
    iou_threshold: float = 0.5,
    num_classes: int = None,
) -> dict:
    """AVA-style frame-level mean AP: per class, rank all box predictions
    across frames by score, match greedily at IoU>=thr, interpolated AP."""
    if num_classes is None:
        num_classes = 1 + max(
            (int(l.max()) for _, l in ground_truth.values() if len(l)),
            default=0,
        )
    aps = []
    for c in range(num_classes):
        rows = []
        npos = 0
        for fid, (gt_boxes, gt_labels) in ground_truth.items():
            gmask = gt_labels == c
            gt_c = gt_boxes[gmask]
            npos += len(gt_c)
            if fid not in predictions:
                continue
            boxes, scores = predictions[fid]
            if len(boxes) == 0:
                continue
            sc = scores[:, c]
            order = np.argsort(-sc)
            taken = np.zeros(len(gt_c), bool)
            iou = box_iou(boxes, gt_c) if len(gt_c) else np.zeros(
                (len(boxes), 0)
            )
            for i in order:
                j = int(np.argmax(iou[i])) if iou.shape[1] else -1
                if j >= 0 and iou[i, j] >= iou_threshold and not taken[j]:
                    taken[j] = True
                    rows.append((sc[i], 1))
                else:
                    rows.append((sc[i], 0))
        if npos == 0:
            continue
        if not rows:
            aps.append(0.0)
            continue
        rows.sort(key=lambda r: -r[0])
        matched = np.asarray([r[1] for r in rows], np.float64)
        tp, fp = np.cumsum(matched), np.cumsum(1 - matched)
        recall = tp / npos
        precision = tp / np.maximum(tp + fp, 1e-8)
        for i in range(len(precision) - 2, -1, -1):
            precision[i] = max(precision[i], precision[i + 1])
        dr = np.diff(np.concatenate([[0.0], recall]))
        aps.append(float(np.sum(precision * dr)))
    return {
        f"frame_mAP@{iou_threshold}": float(np.mean(aps)) if aps else 0.0,
        "per_class_ap": aps,
    }


def evaluate_action_detector(
    apply_head: Callable,  # (roi_feats (N,C) on `device`) -> (N, num_classes) scores
    features_by_frame: dict,  # frame_id -> (B=1,T,H,W,C) feature map
    boxes_by_frame: dict,  # frame_id -> (N, 4) person boxes (feature coords)
    ground_truth: dict,
    *,
    iou_threshold: float = 0.5,
    spatial_scale: float = 1.0,
    device: torch.device | str = "cuda",
) -> dict:
    """End-to-end: ROI features on `device` -> head scores -> frame mAP on
    the host. `apply_head` may return a tensor or an array."""
    preds = {}
    for fid, boxes in boxes_by_frame.items():
        if len(boxes) == 0:
            continue
        boxes_t = torch.as_tensor(np.asarray(boxes, np.float32), device=device)
        rois = torch.cat([boxes_t.new_zeros((len(boxes), 1)), boxes_t], dim=1)
        feats = roi_action_features(
            torch.as_tensor(np.asarray(features_by_frame[fid]), device=device), rois,
            spatial_scale=spatial_scale,
        )
        scores = apply_head(feats)
        if isinstance(scores, torch.Tensor):
            scores = scores.detach().cpu().numpy()
        preds[fid] = (np.asarray(boxes), np.asarray(scores))
    return frame_map(
        preds, ground_truth, iou_threshold=iou_threshold
    )
