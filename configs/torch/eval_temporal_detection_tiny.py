"""Tiny CPU-runnable TAL eval (synthetic anchor-free head outputs).

The PyTorch port's copy of configs/eval_temporal_detection_tiny.py: the same
seeded data and options; nothing here imports the JAX package.

    python -m internvideo_tpu_torch.cli.eval \
        --config configs/torch/eval_temporal_detection_tiny.py --device cpu
"""

import numpy as np

from internvideo_tpu_torch.cli.eval import EvalRunConfig

_T, _C = 64, 2


def _video(rng, events):
    """Head outputs that peak at each event center (perfect regression)."""
    scores = rng.uniform(0.0, 0.03, (_T, _C)).astype(np.float32)
    left = np.zeros(_T, np.float32)
    right = np.zeros(_T, np.float32)
    gt_segs, gt_labels = [], []
    for (s, e, c) in events:
        center = int((s + e) / 2)
        scores[center, c] = 0.9
        left[center] = center - s
        right[center] = e - center
        gt_segs.append([s, e])
        gt_labels.append(c)
    return (
        (scores, left, right),
        (np.asarray(gt_segs, np.float32), np.asarray(gt_labels, np.int32)),
    )


def _synthetic():
    rng = np.random.default_rng(0)
    raw, gt = {}, {}
    layout = {
        "v0": [(4, 12, 0), (30, 44, 1)],
        "v1": [(10, 20, 1)],
        "v2": [(2, 8, 0), (40, 52, 0)],
    }
    for vid, events in layout.items():
        raw[vid], gt[vid] = _video(rng, events)
    return raw, gt


config = EvalRunConfig(
    task="temporal_detection",
    data=_synthetic,
    options={"score_threshold": 0.1, "iou_threshold": 0.5},
)
