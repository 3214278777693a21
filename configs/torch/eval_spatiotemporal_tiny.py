"""Tiny CPU-runnable STAL eval (ROI head -> AVA frame mAP smoke).

The PyTorch port's copy of configs/eval_spatiotemporal_tiny.py: the same
seeded data and options; nothing here imports the JAX package.

Feature maps carry the class signature inside each person box; the
"head" reads it back out, so matched boxes score their gt class highest.

    python -m internvideo_tpu_torch.cli.eval \
        --config configs/torch/eval_spatiotemporal_tiny.py --device cpu
"""

import numpy as np

from internvideo_tpu_torch.cli.eval import EvalRunConfig

_CLS = 3


def _synthetic():
    rng = np.random.default_rng(0)
    feats, boxes, gt = {}, {}, {}
    for fid, items in {
        "f0": [((1, 1, 5, 5), 0), ((8, 8, 13, 13), 1)],
        "f1": [((2, 3, 7, 9), 2)],
    }.items():
        fmap = rng.normal(size=(1, 2, 16, 16, _CLS)).astype(np.float32) * 0.05
        bx, labels = [], []
        for (x0, y0, x1, y1), c in items:
            fmap[0, :, y0:y1, x0:x1, c] += 2.0
            bx.append([x0, y0, x1, y1])
            labels.append(c)
        feats[fid] = fmap
        boxes[fid] = np.asarray(bx, np.float32)
        gt[fid] = (np.asarray(bx, np.float32), np.asarray(labels, np.int32))

    def apply_head(roi_feats):  # (N, C) pooled channels ARE the scores (a tensor on the device)
        return roi_feats

    return apply_head, feats, boxes, gt


config = EvalRunConfig(
    task="spatiotemporal",
    data=_synthetic,
    options={"iou_threshold": 0.5},
)
