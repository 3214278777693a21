"""Tiny CPU-runnable MC-QA eval for the PyTorch port (synthetic
smoke); counterpart of configs/eval_mcqa_tiny.py, with its widths and
data.

    python -m internvideo_tpu_torch.cli.eval \
        --config configs/torch/eval_mcqa_tiny.py --device cpu
"""

import numpy as np

from internvideo_tpu_torch.cli.eval import EvalRunConfig
from internvideo_tpu_torch.models.bert import BertConfig
from internvideo_tpu_torch.models.internvideo2 import InternVideo2Config
from internvideo_tpu_torch.models.videoclip import VideoCLIPConfig


def _batches():
    rng = np.random.default_rng(0)
    for _ in range(2):
        yield {
            "video": rng.normal(size=(3, 1, 28, 28, 3)).astype(np.float32),
            "choice_ids": rng.integers(1, 60, (3, 4, 8)).astype(np.int32),
            "answer": rng.integers(0, 4, (3,)).astype(np.int32),
        }


config = EvalRunConfig(
    task="mcqa",
    model=VideoCLIPConfig(
        vision=InternVideo2Config(
            embed_dim=32, depth=1, num_heads=2, mlp_ratio=2.0,
            patch_size=14, img_size=28, num_frames=1, tubelet_size=1,
            clip_embed_dim=16, num_classes=0, attn_impl="xla",
        ),
        text=BertConfig(
            vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, fusion_layer=1, dropout=0.0,
            attn_impl="xla",
        ),
        embed_dim=16,
    ),
    data=lambda: list(_batches()),
)
