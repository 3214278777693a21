"""InternVideo2 stage-2 VideoCLIP-1B on one GPU (PyTorch port):
`internvideo2_stage2_1b` with nothing cut.

    python -m internvideo_tpu_torch.cli.train \
        --config configs/torch/clip_stage2_1b.py --device cuda \
        trainer.total_steps=3 trainer.log_every=1 trainer.checkpoint_dir=None

Mirrors configs/clip_stage2_1b.py field for field (the reference's
stage-2 1B recipe, multi_modality/scripts/pretraining/stage2/1B/config.py):
the 1B tower at 4 x 224 px, tubelet 1, bf16 compute with fp32 params,
remat, wrapped as the pretrain student (6 CLIP-align decoders to 3200, a
final one to 768); bert-large text / fusion tower (1024 wide, 24 layers,
fusion from layer 19, dropout 0.1); embed 512; VTC + VTM + MLM at weight 1
with hard negatives and MLM probability 0.5; AdamW lr 5e-5 betas
(0.9, 0.98) wd 0.05 clip 3.0, cosine over 40k steps with 4k of warmup;
B = 64, 32 tokens. The recipe sets `uta=0.0`, so the step draws no keep
indices: the tower runs unmasked at S = 1 + 4 * 256 = 1025 and its
CLIP-align decoders get no gradient (they still decay). Set
`engine.uta=1.0` and a `teacher=` TeacherConfig for the UTA variant. The
model starts from seeded random weights (no stage-1 checkpoint is in the
repository); plug a (video, caption) loader into data["stream"].
"""

from internvideo_tpu_torch.cli.train import RunConfig
from internvideo_tpu_torch.core.mesh import MeshConfig
from internvideo_tpu_torch.models.bert import BertConfig
from internvideo_tpu_torch.models.internvideo2 import make_config
from internvideo_tpu_torch.models.pretrain import PretrainConfig
from internvideo_tpu_torch.models.videoclip import VideoCLIPConfig
from internvideo_tpu_torch.train.engines.clip import CLIPLossConfig
from internvideo_tpu_torch.train.optim import OptimizerConfig
from internvideo_tpu_torch.train.trainer import TrainerConfig

TOTAL_STEPS = 40_000  # ~10 epochs of a 25M-pair mix at global batch 4096
VIS = make_config(
    "1B",
    num_frames=4, img_size=224, tubelet_size=1, num_classes=0,
    dtype="bfloat16", param_dtype="float32",
    attn_impl="auto", remat=True,
)

config = RunConfig(
    task="clip",
    trainer=TrainerConfig(
        total_steps=TOTAL_STEPS,
        log_every=100,
        checkpoint_dir="checkpoints/stage2_1b",
        checkpoint_every=2_000,
        mesh=MeshConfig(replica=1, fsdp=-1, seq=1, tensor=1),
        optimizer=OptimizerConfig(
            lr=5e-5, min_lr=5e-7,  # min_lr_multi 0.01
            warmup_steps=TOTAL_STEPS // 10,
            total_steps=TOTAL_STEPS,
            b1=0.9, b2=0.98,
            weight_decay=0.05, clip_grad_norm=3.0,
        ),
    ),
    model=VideoCLIPConfig(
        vision=VIS,
        text=BertConfig(
            vocab_size=30522, hidden_size=1024, num_layers=24, num_heads=16,
            intermediate_size=4096, fusion_layer=19,
            dtype="bfloat16", param_dtype="float32",
        ),
        embed_dim=512,
        temp_init=0.07,
        pretrain=PretrainConfig(
            encoder=VIS,
            clip_output_dim=3200, clip_final_output_dim=768,
            clip_return_layers=6, mae_return_layers=0,
        ),
    ),
    data={"batch_size": 64, "text_len": 32, "stream": None},
    engine=CLIPLossConfig(
        vtc=1.0, vtm=1.0, mlm=1.0,
        vtm_hard_neg=True, mlm_probability=0.5,
        vocab_size=30522,
        uta=0.0,  # the published recipe: no teacher branch
        mask_type="random", mask_ratio=0.8,
        clip_loss_ratio=(1.0, 1.0),
    ),
)
