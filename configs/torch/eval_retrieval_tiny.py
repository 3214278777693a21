"""Tiny CPU-runnable retrieval eval for the PyTorch port (synthetic corpus
smoke); counterpart of configs/eval_retrieval_tiny.py, with its widths, data
and options.

    python -m internvideo_tpu_torch.cli.eval \
        --config configs/torch/eval_retrieval_tiny.py --device cpu
"""

import numpy as np

from internvideo_tpu_torch.cli.eval import EvalRunConfig
from internvideo_tpu_torch.models.bert import BertConfig
from internvideo_tpu_torch.models.internvideo2 import InternVideo2Config
from internvideo_tpu_torch.models.videoclip import VideoCLIPConfig


def _synthetic():
    rng = np.random.default_rng(0)
    n = 6
    videos = {"video": rng.normal(size=(n, 1, 28, 28, 3)).astype(np.float32)}
    texts = {
        "input_ids": rng.integers(1, 60, (n, 8)).astype(np.int32),
        "attention_mask": np.ones((n, 8), np.int32),
    }
    gt = np.arange(n)
    return videos, texts, gt, gt


config = EvalRunConfig(
    task="retrieval",
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
    data=_synthetic,
    options={"batch_size": 3, "k_test": 3, "rerank_batch": 2},
)
