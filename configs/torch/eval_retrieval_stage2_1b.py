"""VideoCLIP stage-2 retrieval on one GPU (PyTorch port):
`internvideo2_stage2_1b` with nothing cut.

    python -m internvideo_tpu_torch.cli.eval \
        --config configs/torch/eval_retrieval_stage2_1b.py --device cuda

The 1B vision tower at 4 x 224 (S = 1025, bf16, fp32 params) and the
bert-large fusion tower (24 layers, fusion from layer 19). Weights are the
seeded init and the corpus is synthetic, made from a fixed seed: 64 clips
of 4 x 224 x 224 x 3 and 64 texts of 32 tokens with ragged padding masks
(lengths 8-32), ground truth text i <-> clip i. Options are the JAX
defaults: towers in batches of 32, top-16 rerank in batches of 32 pairs.
"""

import numpy as np

from internvideo_tpu_torch.cli.eval import EvalRunConfig
from internvideo_tpu_torch.models.presets import internvideo2_stage2_1b

N_CLIPS, N_TEXTS, TEXT_LEN = 64, 64, 32


def _synthetic():
    rng = np.random.default_rng(0)
    videos = {"video": rng.standard_normal((N_CLIPS, 4, 224, 224, 3), np.float32)}
    lengths = rng.integers(8, TEXT_LEN + 1, N_TEXTS)
    mask = (np.arange(TEXT_LEN)[None] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(1000, 30522, (N_TEXTS, TEXT_LEN)).astype(np.int32)
    ids[:, 0] = 101  # [CLS]
    texts = {"input_ids": ids * mask, "attention_mask": mask}
    gt = np.arange(N_CLIPS)
    return videos, texts, gt, gt


config = EvalRunConfig(
    task="retrieval",
    model=internvideo2_stage2_1b(),
    data=_synthetic,
    options={"batch_size": 32, "k_test": 16, "rerank_batch": 32},
)
