"""InternVideo2-1B multi-view classification eval on one GPU (PyTorch port).

    python -m internvideo_tpu_torch.cli.eval \
        --config configs/torch/eval_classification_1b.py --device cuda

The repo's headline encoder: 16 frames x 224 px, bf16 weights and
activations, 400 classes (Kinetics-400), gelu_tanh MLP. Weights are the
seeded init and the views are synthetic: two view-batches of B = 16 clips
(16 video ids, two views each), made lazily from a fixed seed.
"""

import numpy as np

from internvideo_tpu_torch.cli.eval import EvalRunConfig
from internvideo_tpu_torch.models.internvideo2 import make_config

BATCH = 16
N_VIEWS = 2


def _views():
    rng = np.random.default_rng(0)
    labels = (np.arange(BATCH) % 400).astype(np.int32)
    for _ in range(N_VIEWS):
        yield {
            "video": rng.standard_normal((BATCH, 16, 224, 224, 3), np.float32),
            "label": labels,
            "video_id": np.arange(BATCH, dtype=np.int32),
        }


config = EvalRunConfig(
    task="classification",
    model=make_config(
        "1B", num_frames=16, img_size=224, num_classes=400,
        dtype="bfloat16", param_dtype="bfloat16", mlp_act="gelu_tanh",
    ),
    data=_views,
)
