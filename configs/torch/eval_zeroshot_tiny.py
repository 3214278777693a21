"""Tiny CPU-runnable zero-shot classification eval for the PyTorch port
(synthetic smoke); counterpart of configs/eval_zeroshot_tiny.py, with its
widths and data. Its toy tokenizer hashes with Python's `hash`, which
changes between processes: compare the two CLIs in one process.

    python -m internvideo_tpu_torch.cli.eval \
        --config configs/torch/eval_zeroshot_tiny.py --device cpu
"""

import numpy as np

from internvideo_tpu_torch.cli.eval import EvalRunConfig
from internvideo_tpu_torch.models.bert import BertConfig
from internvideo_tpu_torch.models.internvideo2 import InternVideo2Config
from internvideo_tpu_torch.models.videoclip import VideoCLIPConfig


def _synthetic():
    rng = np.random.default_rng(0)
    class_names = ["running", "swimming", "cooking"]

    def tokenize(texts):
        # toy hash tokenizer: deterministic ids per text
        ids = np.zeros((len(texts), 8), np.int32)
        for i, t in enumerate(texts):
            h = abs(hash(t))
            for j in range(8):
                ids[i, j] = 1 + (h >> (j * 4)) % 60
        return {"input_ids": ids,
                "attention_mask": np.ones_like(ids)}

    def batches():
        for _ in range(2):
            yield {
                "video": rng.normal(size=(3, 1, 28, 28, 3)).astype(
                    np.float32),
                "label": rng.integers(0, 3, (3,)),
            }

    return class_names, tokenize, batches()


config = EvalRunConfig(
    task="zeroshot",
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
    options={},
)
