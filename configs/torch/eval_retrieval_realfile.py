"""Retrieval eval over a REAL video file, end to end.

Drives the full production path on the reference repo's actual asset
(`Data/InternVid/example1.mp4`, 40 frames @ 5 fps, 640x480): jsonl
annotation -> JsonlVideoTextDataset -> container decode
(data/video.py reader chain) -> eval transforms -> VideoCLIP ITC +
cross-encoder rerank. Captions are real search words from InternVid's
`queries.jsonl`. Weights are random, so the metrics are chance-level —
the point is an executed real-file pipeline (the reference's
tasks_clip/retrieval.py flow on real media), not accuracy.

    python -m internvideo_tpu_torch.cli.eval \
        --config configs/torch/eval_retrieval_realfile.py --device cpu

PyTorch port: mirrors configs/eval_retrieval_realfile.py field for field, its data
made by the port's data modules. The asset is read from the reference
checkout that IVT_REFERENCE_ROOT names; without it the config writes its
own seeded `.npy` clip, as the JAX config does.
"""

import json
import os
import tempfile

import numpy as np

from internvideo_tpu_torch.cli.eval import EvalRunConfig
from internvideo_tpu_torch.models.bert import BertConfig
from internvideo_tpu_torch.models.internvideo2 import InternVideo2Config
from internvideo_tpu_torch.models.videoclip import VideoCLIPConfig

# the reference repository's checkout, if one is named
REFERENCE_ROOT = os.environ.get("IVT_REFERENCE_ROOT", "")
REAL_MP4 = os.path.join(REFERENCE_ROOT, "Data/InternVid/example1.mp4")
REAL_QUERIES = os.path.join(REFERENCE_ROOT, "Data/InternVid/queries.jsonl")
_N = 6


def _captions():
    if os.path.exists(REAL_QUERIES):
        caps = []
        with open(REAL_QUERIES) as f:
            for line in f:
                line = line.strip()
                if line:
                    caps.append(json.loads(line)["search_word_id"])
                if len(caps) == _N:
                    return caps
    return [f"clip number {i}" for i in range(_N)]  # offline fallback


def _real_file_batch():
    from internvideo_tpu_torch.data.datasets import JsonlVideoTextDataset
    from internvideo_tpu_torch.data.tokenizer import ToyTokenizer

    tmp = tempfile.mkdtemp(prefix="ivt_realfile_")
    media = REAL_MP4
    if not os.path.exists(media):  # keep the config runnable without the asset
        media = os.path.join(tmp, "clip.npy")
        np.save(media, (np.random.default_rng(0).random(
            (40, 64, 80, 3)) * 255).astype(np.uint8))
    anno = os.path.join(tmp, "anno.jsonl")
    with open(anno, "w") as f:
        for cap in _captions():
            f.write(json.dumps({"video": media, "caption": cap}) + "\n")

    ds = JsonlVideoTextDataset(
        anno, ToyTokenizer(), num_frames=4, img_size=56, max_length=8,
    )
    batch = next(ds.batches(_N, train=False))  # all items, in order
    videos = {"video": batch["video"]}
    texts = {
        "input_ids": batch["input_ids"].astype(np.int32),
        "attention_mask": batch["attention_mask"].astype(np.int32),
    }
    gt = np.arange(_N)
    return videos, texts, gt, gt


config = EvalRunConfig(
    task="retrieval",
    model=VideoCLIPConfig(
        vision=InternVideo2Config(
            embed_dim=32, depth=1, num_heads=2, mlp_ratio=2.0,
            patch_size=14, img_size=56, num_frames=4, tubelet_size=1,
            clip_embed_dim=16, num_classes=0, attn_impl="xla",
        ),
        text=BertConfig(
            vocab_size=4096, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, fusion_layer=1, dropout=0.0,
            attn_impl="xla",
        ),
        embed_dim=16,
    ),
    data=_real_file_batch,
    options={"batch_size": 3, "k_test": 3, "rerank_batch": 2},
)
