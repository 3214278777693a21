"""Zero-shot action classification with the stage-2 VideoCLIP on one GPU
(PyTorch port): `internvideo2_stage2_1b` with nothing cut.

    python -m internvideo_tpu_torch.cli.eval \
        --config configs/torch/eval_zeroshot_stage2_1b.py --device cuda

The 1B tower at 4 x 224 (S = 1025, bf16, fp32 params) and the bert-large
text layers. Weights are the seeded init and the data synthetic, from a
fixed seed: 8 class names under the 28 CLIP-style action templates
(eval/zeroshot.py KINETICS_TEMPLATES), each text tokenized by a stand-in
for the BERT tokenizer ([CLS], one id a word from its CRC-32, [SEP],
padded to 16 and masked), and 2 batches of 8 clips with labels in [0, 8).
The text tower's masked attention is the plain einsum (as in JAX), so the
run launches K1 40 times a clip batch and nothing else.
"""

import zlib

import numpy as np

from internvideo_tpu_torch.cli.eval import EvalRunConfig
from internvideo_tpu_torch.models.presets import internvideo2_stage2_1b

CLASSES = ("running", "swimming", "cooking", "riding a bike", "playing guitar",
           "juggling balls", "climbing a rope", "washing dishes")
N_BATCHES, BATCH, TEXT_LEN = 2, 8, 16


def _tokenize(texts):
    ids = np.zeros((len(texts), TEXT_LEN), np.int32)
    for i, t in enumerate(texts):
        words = [1000 + zlib.crc32(w.encode()) % 29000 for w in t.lower().split()]
        row = [101] + words[:TEXT_LEN - 2] + [102]
        ids[i, :len(row)] = row
    return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int32)}


def _synthetic():
    rng = np.random.default_rng(0)

    def batches():
        for _ in range(N_BATCHES):
            yield {"video": rng.standard_normal((BATCH, 4, 224, 224, 3), np.float32),
                   "label": rng.integers(0, len(CLASSES), BATCH)}

    return list(CLASSES), _tokenize, batches()


config = EvalRunConfig(task="zeroshot", model=internvideo2_stage2_1b(), data=_synthetic)
