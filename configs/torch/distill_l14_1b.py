"""InternVideo2-L/14 distilled from a frozen InternVideo2-1B, on one GPU
(PyTorch port).

    python -m internvideo_tpu_torch.cli.train \
        --config configs/torch/distill_l14_1b.py --device cuda \
        trainer.total_steps=3 trainer.log_every=1 trainer.checkpoint_dir=None

The published InternVideo2-S / B / L encoders were distilled from the 1B
(the reference's single_modality/run_distill.py); that script's flags are
not in this repository, so this recipe is assembled from the repository's
own pieces, and these choices are this config's, not the reference's:

  * student: `make_config("L")` (1024 wide, 24 blocks, 16 heads of 64,
    QK-RMSNorm) at 8 frames x 224 px, tubelet 1, bf16 compute with fp32
    params, remat; 6 CLIP-align decoders to the teacher's 1408 (student
    layers 23..18) and a final one to its pooled 768; no MAE decoders;
  * teacher: `make_config("1B")` (1408 wide, 40 blocks, 16 heads of 88) at
    the same 8 x 224, frozen, bf16 weights and compute, seeded random
    (no checkpoint is in the repository), S = 1 + 8 * 256 = 2049;
  * alignment: teacher layers (39, 38, 37, 36, 35, 34), the depth - i - 1
    convention of the student's clip indices and TeacherConfig's return
    indices. As in the JAX engine, the teacher's layers stack in this order
    and the student's decoders in ascending order (18..23), so student
    layer 18 aligns to teacher layer 39;
  * masking: tube at 0.8 (the JAX DistillConfig's default type at the UMT
    recipe's ratio), so the student runs S = 8 * (256 - 204) + 1 = 417;
  * B 32 and configs/pretrain_1b_umt.py's AdamW (lr 1.5e-4 -> 1e-5 cosine,
    warmup 1/8, betas (0.9, 0.98), eps 1e-6, weight decay 0.05, clip 3.0).
"""

from internvideo_tpu_torch.cli.train import RunConfig
from internvideo_tpu_torch.core.mesh import MeshConfig
from internvideo_tpu_torch.models.internvideo2 import make_config
from internvideo_tpu_torch.models.pretrain import PretrainConfig
from internvideo_tpu_torch.train.engines.distill import DistillConfig
from internvideo_tpu_torch.train.optim import OptimizerConfig
from internvideo_tpu_torch.train.trainer import TrainerConfig

TOTAL_STEPS = 100_000
FRAMES, IMG = 8, 224

config = RunConfig(
    task="distill",
    trainer=TrainerConfig(
        total_steps=TOTAL_STEPS,
        log_every=100,
        checkpoint_dir="checkpoints/distill_l14_1b",
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
            "L", num_frames=FRAMES, img_size=IMG, tubelet_size=1, num_classes=0,
            dtype="bfloat16", param_dtype="float32", attn_impl="auto", remat=True,
        ),
        clip_output_dim=1408,  # the teacher's width
        clip_final_output_dim=768,  # the teacher's pooled width
        clip_return_layers=6,
        mae_return_layers=0,
    ),
    teacher=make_config(
        "1B", num_frames=FRAMES, img_size=IMG, tubelet_size=1, num_classes=0,
        dtype="bfloat16", param_dtype="bfloat16", attn_impl="auto",
    ),
    data={"batch_size": 32, "stream": None},
    engine=DistillConfig(
        teacher_layer_indices=(39, 38, 37, 36, 35, 34), mask_type="tube", mask_ratio=0.8,
    ),
)
