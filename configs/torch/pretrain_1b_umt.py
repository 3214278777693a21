"""InternVideo2-1B UMT masked pretrain on one GPU (PyTorch port).

    python -m internvideo_tpu_torch.cli.train \
        --config configs/torch/pretrain_1b_umt.py --device cuda

Mirrors configs/pretrain_1b_umt.py field for field (the reference's
flagship stage-1 recipe, single_modality/scripts/pretraining/1B_pt.sh):
student 1B at 16 frames x 224 px, tubelet 1, bf16 compute with fp32
params, remat, drop-path 0.25; attention-guided masking at ratio 0.8, so
S = 16 * 52 + 1 = 833 visible tokens; frozen InternVL-CLIP-6B teacher
(3200 wide, 48 blocks, 25 heads of 128, 6 return layers, bf16) on the
16-frame clip and VideoMAE-g14 teacher (1408 wide, 40 LayerNorm blocks,
tubelet 2, 4 return layers, bf16) on the full 32-frame clip; AdamW lr
1.5e-4 betas (0.9, 0.98) eps 1e-6 wd 0.05 clip 3.0; B = 32. The student
and both teachers start from seeded random weights (no checkpoint is in
the repository); plug a masked-video loader into data["stream"] for real
clips.
"""

from internvideo_tpu_torch.cli.train import RunConfig
from internvideo_tpu_torch.core.mesh import MeshConfig
from internvideo_tpu_torch.models.internvideo2 import make_config
from internvideo_tpu_torch.models.pretrain import PretrainConfig
from internvideo_tpu_torch.models.teachers import TeacherConfig
from internvideo_tpu_torch.train.engines.pretrain import UMTPretrainConfig
from internvideo_tpu_torch.train.optim import OptimizerConfig
from internvideo_tpu_torch.train.trainer import TrainerConfig

TOTAL_STEPS = 100_000

config = RunConfig(
    task="pretrain",
    trainer=TrainerConfig(
        total_steps=TOTAL_STEPS,
        log_every=100,
        checkpoint_dir="checkpoints/1b_umt_pt",
        checkpoint_every=5_000,
        mesh=MeshConfig(replica=1, fsdp=-1, seq=1, tensor=1),
        optimizer=OptimizerConfig(
            lr=1.5e-4, min_lr=1e-5,
            warmup_steps=TOTAL_STEPS // 8,
            total_steps=TOTAL_STEPS,
            b1=0.9, b2=0.98, eps=1e-6,
            weight_decay=0.05, clip_grad_norm=3.0,
        ),
    ),
    model=PretrainConfig(
        encoder=make_config(
            "1B",
            num_frames=16, img_size=224, tubelet_size=1,
            num_classes=0, drop_path_rate=0.25,
            dtype="bfloat16", param_dtype="float32",
            attn_impl="auto", remat=True,
        ),
        clip_output_dim=3200,
        clip_final_output_dim=768,
        clip_return_layers=6,
        mae_output_dim=1408,
        mae_return_layers=4,
    ),
    teacher=TeacherConfig(
        embed_dim=3200, depth=48, num_heads=25, mlp_ratio=4.0,
        patch_size=14, img_size=224, clip_embed_dim=768,
        return_layers=6, tubelet_size=1,
        dtype="bfloat16", param_dtype="bfloat16",
    ),
    mae_teacher=TeacherConfig(
        embed_dim=1408, depth=40, num_heads=16, mlp_ratio=48 / 11,
        patch_size=14, img_size=224, clip_embed_dim=768,
        return_layers=4, tubelet_size=2, norm_type="layernorm",
        qk_normalization=False,
        dtype="bfloat16", param_dtype="bfloat16",
    ),
    data={"batch_size": 32, "stream": None},
    engine=UMTPretrainConfig(
        mask_type="attention", mask_ratio=0.8, td_ratio=2,
        clip_loss_ratio=(1.0, 1.0), mae_loss_ratio=1.0,
    ),
)
