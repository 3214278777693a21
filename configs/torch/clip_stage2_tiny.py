"""Tiny CPU-runnable stage-2 VideoCLIP pretrain with the UTA teacher branch,
PyTorch port.

    python -m internvideo_tpu_torch.cli.train \
        --config configs/torch/clip_stage2_tiny.py --device cpu

Mirrors configs/clip_stage2_tiny.py field for field: frozen CLIP teacher,
attention-guided shared masking at 0.5, masked student forward,
UTA + VTC + VTM + MLM losses.
"""

from internvideo_tpu_torch.cli.train import RunConfig
from internvideo_tpu_torch.core.mesh import MeshConfig
from internvideo_tpu_torch.models.bert import BertConfig
from internvideo_tpu_torch.models.internvideo2 import InternVideo2Config
from internvideo_tpu_torch.models.pretrain import PretrainConfig
from internvideo_tpu_torch.models.teachers import TeacherConfig
from internvideo_tpu_torch.models.videoclip import VideoCLIPConfig
from internvideo_tpu_torch.train.engines.clip import CLIPLossConfig
from internvideo_tpu_torch.train.optim import OptimizerConfig
from internvideo_tpu_torch.train.trainer import TrainerConfig

VIS = InternVideo2Config(
    embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0,
    patch_size=14, img_size=28, num_frames=2, tubelet_size=1,
    clip_embed_dim=16, attn_impl="auto",
)

config = RunConfig(
    task="clip",
    trainer=TrainerConfig(
        total_steps=4, log_every=2,
        mesh=MeshConfig(replica=1, fsdp=-1, seq=1, tensor=1),
        optimizer=OptimizerConfig(lr=1e-4, total_steps=4),
    ),
    model=VideoCLIPConfig(
        vision=VIS,
        text=BertConfig(
            vocab_size=1024, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, fusion_layer=1, dropout=0.0,
            attn_impl="auto",
        ),
        embed_dim=24,
        pretrain=PretrainConfig(
            encoder=VIS,
            clip_output_dim=32,  # teacher hidden width
            clip_final_output_dim=16,  # teacher pooled width
            clip_return_layers=2, mae_return_layers=0,
        ),
    ),
    teacher=TeacherConfig(
        embed_dim=32, depth=2, num_heads=2, mlp_ratio=2.0,
        patch_size=14, img_size=28, clip_embed_dim=16,
        return_layers=2, tubelet_size=1,
    ),
    data={"batch_size": 8, "text_len": 16, "stream": None},
    engine=CLIPLossConfig(
        vocab_size=1024, mlm_probability=0.3,
        uta=1.0, mask_type="attention", mask_ratio=0.5,
    ),
)
