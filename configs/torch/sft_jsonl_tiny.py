"""Tiny CPU-runnable MLLM SFT on the real data path: a jsonl of
conversations and their video files -> tokenize -> pack -> SFT steps
(PyTorch port).

    python -m internvideo_tpu_torch.cli.train \
        --config configs/torch/sft_jsonl_tiny.py --device cpu

The widths, special ids and tokenize config of the JAX package's
tests/test_mllm_tokenize.py:test_pack_and_sft_step: a 2-layer tower (32
wide, patch 8, temporal 2, merge 2) and a 2-layer M2LA text model (48 wide,
vocabulary 260); the fixed grid (2, 4, 4), so 4 frames at 32 px a row,
packs of 96 tokens. Loading the config writes its data into a fresh
temporary directory: three rows of that test's conversation ("what happens
<VIDEO_CONTEXT> here?" / "a cat jumps"), each on one seeded uint8 clip of
(20, 64, 48, 3) stored as `.npy`, which `load_media` resizes to 32 x 32.
Text is encoded at the character level (1 + ord(c) % 200), as the JAX CLI
does without a tokenizer.
"""

import json
import os
import tempfile

import numpy as np

from internvideo_tpu_torch.cli.train import RunConfig
from internvideo_tpu_torch.core.mesh import MeshConfig
from internvideo_tpu_torch.data.mllm_tokenize import VIDEO_MARKER, MLLMTokenizeConfig
from internvideo_tpu_torch.models.llm import LLMConfig
from internvideo_tpu_torch.models.mllm import MLLMConfig
from internvideo_tpu_torch.models.vision_tower import VisionTowerConfig
from internvideo_tpu_torch.nn.mla import MLAConfig
from internvideo_tpu_torch.train.engines.sft import SFTConfig
from internvideo_tpu_torch.train.optim import OptimizerConfig
from internvideo_tpu_torch.train.trainer import TrainerConfig

IDS = dict(image_token_id=250, video_token_id=251, vision_start_token_id=247,
           vision_end_token_id=248)
TOKENIZE = MLLMTokenizeConfig(
    patch_size=8, temporal_patch_size=2, spatial_merge_size=2,
    fps=2.0, min_frames=4, max_frames=16,
    video_min_total_pixels=4 * 32 * 32, video_max_total_pixels=16 * 32 * 32,
    im_start_token_id=245, im_end_token_id=246, pad_token_id=0,
    fixed_grid=(2, 4, 4), **IDS,
)


def write_data(root: str, rows: int = 3) -> str:
    """The jsonl and its clip under `root`; returns the jsonl's path."""
    clip = os.path.join(root, "clip.npy")
    np.save(clip, np.random.default_rng(0).integers(0, 255, (20, 64, 48, 3), dtype=np.uint8))
    sample = {
        "messages": [{"role": "user", "content": f"what happens {VIDEO_MARKER} here?"},
                     {"role": "assistant", "content": "a cat jumps"}],
        "videos": [{"path": clip, "width": 48, "height": 64, "origin_fps": 10.0,
                    "origin_video_length": 20}],
    }
    path = os.path.join(root, "data.jsonl")
    with open(path, "w") as f:
        for _ in range(rows):
            f.write(json.dumps(sample) + "\n")
    return path


config = RunConfig(
    task="sft",
    trainer=TrainerConfig(
        total_steps=3, log_every=1,
        mesh=MeshConfig(replica=1, fsdp=-1, seq=1, tensor=1),
        optimizer=OptimizerConfig(lr=1e-4, total_steps=3),
    ),
    model=MLLMConfig(
        vision=VisionTowerConfig(
            hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            patch_size=8, temporal_patch_size=2, spatial_merge_size=2,
            pos_embed_grid=6, deepstack_indexes=(1,), text_hidden_size=48,
            attn_impl="auto",
        ),
        text=LLMConfig(
            vocab_size=260, hidden_size=48, num_layers=2, intermediate_size=96,
            mrope_section=(2, 1, 1),
            mla=MLAConfig(hidden_size=48, num_heads=2, kv_lora_rank=24,
                          qk_rope_head_dim=8, qk_nope_head_dim=8, v_head_dim=8),
            attn_impl="auto",
        ),
        **IDS,
    ),
    data={
        "jsonl": write_data(tempfile.mkdtemp(prefix="ivt_sft_jsonl_")),
        "batch_size": 2,
        "pack_max_length": 96,
        "tokenize": TOKENIZE,
    },
    engine=SFTConfig(ce_chunk_size=32),
)
