"""Tiny CPU-runnable audio-visual stage-2 config (synthetic data smoke run),
PyTorch port.

    python -m internvideo_tpu_torch.cli.train \
        --config configs/torch/clip_av_tiny.py --device cpu [data.media_type=audio]

Mirrors configs/clip_av_tiny.py field for field: the simple audio tower,
media type audio_video (override `data.media_type` with audio or video).
"""

from internvideo_tpu_torch.cli.train import RunConfig
from internvideo_tpu_torch.core.mesh import MeshConfig
from internvideo_tpu_torch.models.audio import AudioEncoderConfig
from internvideo_tpu_torch.models.bert import BertConfig
from internvideo_tpu_torch.models.internvideo2 import InternVideo2Config
from internvideo_tpu_torch.models.videoclip_av import VideoCLIPAVConfig
from internvideo_tpu_torch.train.engines.clip import CLIPLossConfig
from internvideo_tpu_torch.train.optim import OptimizerConfig
from internvideo_tpu_torch.train.trainer import TrainerConfig

config = RunConfig(
    task="clip_av",
    trainer=TrainerConfig(
        total_steps=4, log_every=2,
        mesh=MeshConfig(replica=1, fsdp=-1, seq=1, tensor=1),
        optimizer=OptimizerConfig(lr=1e-4, total_steps=4),
    ),
    model=VideoCLIPAVConfig(
        vision=InternVideo2Config(
            embed_dim=32, depth=1, num_heads=2, mlp_ratio=2.0,
            patch_size=14, img_size=28, num_frames=2, tubelet_size=1,
            clip_embed_dim=16, num_classes=0, attn_impl="auto",
        ),
        audio=AudioEncoderConfig(
            embed_dim=32, depth=1, num_heads=2, patch_size=16,
            n_mels=32, max_frames=32, attn_impl="auto",
        ),
        text=BertConfig(
            vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, fusion_layer=1, dropout=0.0,
            attn_impl="auto",
        ),
        embed_dim=24,
    ),
    data={"batch_size": 8, "text_len": 16, "media_type": "audio_video",
          "stream": None},
    engine=CLIPLossConfig(
        vocab_size=64, mask_token_id=1, cls_token_id=2, mlm_probability=0.3,
    ),
)
