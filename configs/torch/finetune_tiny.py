"""Tiny CPU-runnable finetune config (synthetic data smoke run), PyTorch port.

    python -m internvideo_tpu_torch.cli.train \
        --config configs/torch/finetune_tiny.py --device cpu

Mirrors configs/finetune_tiny.py field for field.
"""

from internvideo_tpu_torch.cli.train import RunConfig
from internvideo_tpu_torch.core.mesh import MeshConfig
from internvideo_tpu_torch.data.mixup import MixupConfig
from internvideo_tpu_torch.models.internvideo2 import InternVideo2Config
from internvideo_tpu_torch.train.engines.finetune import FinetuneConfig
from internvideo_tpu_torch.train.optim import OptimizerConfig
from internvideo_tpu_torch.train.trainer import TrainerConfig

NUM_CLASSES = 8

config = RunConfig(
    task="finetune",
    trainer=TrainerConfig(
        total_steps=6,
        log_every=2,
        mesh=MeshConfig(replica=1, fsdp=-1, seq=1, tensor=1),
        optimizer=OptimizerConfig(
            lr=1e-3, warmup_steps=2, total_steps=6,
            layer_decay=0.9, num_layers=2,
        ),
    ),
    model=InternVideo2Config(
        embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0,
        patch_size=14, img_size=28, num_frames=2, tubelet_size=1,
        clip_embed_dim=16, num_classes=NUM_CLASSES, attn_impl="auto",
    ),
    data={"batch_size": 8, "stream": None},
    engine=FinetuneConfig(
        mixup=MixupConfig(num_classes=NUM_CLASSES), num_classes=NUM_CLASSES
    ),
)
