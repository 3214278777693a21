"""Tiny CPU-runnable distillation config (synthetic smoke run), PyTorch port.

    python -m internvideo_tpu_torch.cli.train \
        --config configs/torch/distill_tiny.py --device cpu

Mirrors configs/distill_tiny.py field for field.
"""

from internvideo_tpu_torch.cli.train import RunConfig
from internvideo_tpu_torch.core.mesh import MeshConfig
from internvideo_tpu_torch.models.internvideo2 import InternVideo2Config
from internvideo_tpu_torch.models.pretrain import PretrainConfig
from internvideo_tpu_torch.train.engines.distill import DistillConfig
from internvideo_tpu_torch.train.optim import OptimizerConfig
from internvideo_tpu_torch.train.trainer import TrainerConfig

STUDENT = InternVideo2Config(
    embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0,
    patch_size=14, img_size=28, num_frames=2, tubelet_size=1,
    clip_embed_dim=16, num_classes=0, attn_impl="auto",
)
TEACHER = InternVideo2Config(
    embed_dim=48, depth=3, num_heads=2, mlp_ratio=2.0,
    patch_size=14, img_size=28, num_frames=2, tubelet_size=1,
    clip_embed_dim=16, num_classes=0, attn_impl="auto",
)

config = RunConfig(
    task="distill",
    trainer=TrainerConfig(
        total_steps=6, log_every=2,
        mesh=MeshConfig(replica=1, fsdp=-1, seq=1, tensor=1),
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=6),
    ),
    model=PretrainConfig(
        encoder=STUDENT,
        clip_output_dim=48,  # teacher hidden width
        clip_final_output_dim=16,  # teacher pooled width
        clip_return_layers=2, mae_return_layers=0,
    ),
    teacher=TEACHER,
    data={"batch_size": 4, "stream": None},
    engine=DistillConfig(
        teacher_layer_indices=(2, 1), mask_type="tube", mask_ratio=0.5
    ),
)
