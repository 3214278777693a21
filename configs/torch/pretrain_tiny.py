"""Tiny CPU-runnable UMT dual-teacher pretrain config (synthetic smoke run),
PyTorch port.

    python -m internvideo_tpu_torch.cli.train \
        --config configs/torch/pretrain_tiny.py --device cpu

Mirrors configs/pretrain_tiny.py field for field.
"""

from internvideo_tpu_torch.cli.train import RunConfig
from internvideo_tpu_torch.core.mesh import MeshConfig
from internvideo_tpu_torch.models.internvideo2 import InternVideo2Config
from internvideo_tpu_torch.models.pretrain import PretrainConfig
from internvideo_tpu_torch.models.teachers import TeacherConfig
from internvideo_tpu_torch.train.engines.pretrain import UMTPretrainConfig
from internvideo_tpu_torch.train.optim import OptimizerConfig
from internvideo_tpu_torch.train.trainer import TrainerConfig

ENC = InternVideo2Config(
    embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0,
    patch_size=14, img_size=28, num_frames=2, tubelet_size=1,
    clip_embed_dim=16, num_classes=0, attn_impl="auto",
)

config = RunConfig(
    task="pretrain",
    trainer=TrainerConfig(
        total_steps=6, log_every=2,
        mesh=MeshConfig(replica=1, fsdp=-1, seq=1, tensor=1),
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=6),
    ),
    model=PretrainConfig(
        encoder=ENC,
        clip_output_dim=32, clip_final_output_dim=16,
        clip_return_layers=2, mae_output_dim=32, mae_return_layers=1,
    ),
    teacher=TeacherConfig(
        embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0,
        patch_size=14, img_size=28, clip_embed_dim=16,
        return_layers=2, tubelet_size=1,
    ),
    mae_teacher=TeacherConfig(
        embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0,
        patch_size=14, img_size=28, clip_embed_dim=16,
        return_layers=1, tubelet_size=2, norm_type="layernorm",
    ),
    data={"batch_size": 4, "stream": None},
    engine=UMTPretrainConfig(mask_type="attention", mask_ratio=0.5, td_ratio=2),
)
