"""Tiny CPU-runnable MLLM SFT config (synthetic data), PyTorch port.

    python -m internvideo_tpu_torch.cli.train \
        --config configs/torch/sft_tiny.py --device cpu

Mirrors configs/sft_tiny.py field for field.
"""

from internvideo_tpu_torch.cli.train import RunConfig
from internvideo_tpu_torch.core.mesh import MeshConfig
from internvideo_tpu_torch.models.llm import LLMConfig
from internvideo_tpu_torch.models.mllm import MLLMConfig
from internvideo_tpu_torch.models.vision_tower import VisionTowerConfig
from internvideo_tpu_torch.nn.mla import MLAConfig
from internvideo_tpu_torch.train.engines.sft import SFTConfig
from internvideo_tpu_torch.train.optim import OptimizerConfig
from internvideo_tpu_torch.train.trainer import TrainerConfig

config = RunConfig(
    task="sft",
    trainer=TrainerConfig(
        total_steps=4, log_every=2,
        mesh=MeshConfig(replica=1, fsdp=-1, seq=1, tensor=1),
        optimizer=OptimizerConfig(lr=1e-4, total_steps=4),
    ),
    model=MLLMConfig(
        vision=VisionTowerConfig(
            hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
            patch_size=8, temporal_patch_size=2, spatial_merge_size=2,
            pos_embed_grid=6, deepstack_indexes=(0, 1), text_hidden_size=48,
            attn_impl="auto",
        ),
        text=LLMConfig(
            vocab_size=256, hidden_size=48, num_layers=2,
            intermediate_size=96, mrope_section=(2, 1, 1),
            mla=MLAConfig(
                hidden_size=48, num_heads=2, kv_lora_rank=24,
                qk_rope_head_dim=8, qk_nope_head_dim=8, v_head_dim=8,
            ),
            attn_impl="auto",
        ),
        image_token_id=250, video_token_id=251,
    ),
    data={"batch_size": 4, "seq_len": 32, "num_frames": 2, "stream": None},
    engine=SFTConfig(ce_chunk_size=16),
)
