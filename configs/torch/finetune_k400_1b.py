"""InternVideo2-1B K400 finetune on one GPU (PyTorch port).

    python -m internvideo_tpu_torch.cli.train \
        --config configs/torch/finetune_k400_1b.py --device cuda

Mirrors configs/finetune_k400_1b.py field for field: 8 frames x 224 px
(S = 2049), B = 32, bf16 compute with fp32 params, per-block remat,
drop-path 0.25, mixup + cutmix with label smoothing 0.1, AdamW lr 2e-5 with
1000 warmup steps, clip 3.0, layer decay 0.9, and `mlp_act` left at its
default `gelu` (the eval config uses `gelu_tanh`). The model starts from
the seeded init; plug a loader into data["stream"] for real clips.
"""

from internvideo_tpu_torch.cli.train import RunConfig
from internvideo_tpu_torch.core.mesh import MeshConfig
from internvideo_tpu_torch.data.mixup import MixupConfig
from internvideo_tpu_torch.models.internvideo2 import make_config
from internvideo_tpu_torch.train.engines.finetune import FinetuneConfig
from internvideo_tpu_torch.train.optim import OptimizerConfig
from internvideo_tpu_torch.train.trainer import TrainerConfig

NUM_CLASSES = 400

config = RunConfig(
    task="finetune",
    trainer=TrainerConfig(
        total_steps=20_000,
        log_every=50,
        checkpoint_dir="checkpoints/k400_1b",
        checkpoint_every=1_000,
        mesh=MeshConfig(replica=1, fsdp=-1, seq=1, tensor=1),
        optimizer=OptimizerConfig(
            lr=2e-5, min_lr=1e-6, warmup_steps=1_000, total_steps=20_000,
            weight_decay=0.05, clip_grad_norm=3.0,
            layer_decay=0.9, num_layers=40,
        ),
    ),
    model=make_config(
        "1B",
        num_frames=8, img_size=224,
        num_classes=NUM_CLASSES,
        drop_path_rate=0.25,
        dtype="bfloat16", param_dtype="float32",
        attn_impl="auto", remat=True,
    ),
    data={"batch_size": 32, "stream": None},
    engine=FinetuneConfig(
        mixup=MixupConfig(
            mixup_alpha=0.8, cutmix_alpha=1.0, label_smoothing=0.1,
            num_classes=NUM_CLASSES,
        ),
        num_classes=NUM_CLASSES,
    ),
)
