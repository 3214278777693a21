"""Tiny CPU-runnable multi-view classification eval for the PyTorch port
(synthetic smoke); counterpart of configs/eval_classification_tiny.py.

    python -m internvideo_tpu_torch.cli.eval \
        --config configs/torch/eval_classification_tiny.py --device cpu
"""

import numpy as np

from internvideo_tpu_torch.cli.eval import EvalRunConfig
from internvideo_tpu_torch.models.internvideo2 import InternVideo2Config


def _views():
    rng = np.random.default_rng(0)
    n_videos, n_views = 4, 3
    base = rng.normal(size=(n_videos, 2, 28, 28, 3)).astype(np.float32)
    labels = (np.arange(n_videos) % 5).astype(np.int32)
    for v in range(n_views):
        yield {
            "video": base + 0.05 * rng.normal(size=base.shape).astype(
                np.float32
            ),
            "label": labels,
            "video_id": np.arange(n_videos, dtype=np.int32),
        }


config = EvalRunConfig(
    task="classification",
    model=InternVideo2Config(
        embed_dim=32, depth=1, num_heads=2, mlp_ratio=2.0,
        patch_size=14, img_size=28, num_frames=2, tubelet_size=1,
        clip_embed_dim=16, num_classes=5, attn_impl="xla",
    ),
    data=lambda: list(_views()),
)
