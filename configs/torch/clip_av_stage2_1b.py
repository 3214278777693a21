"""Audio-visual InternVideo2 stage 2 at full width on one GPU (PyTorch
port): the 1B tower, the BEATs audio tower and bert-large, nothing cut.

    python -m internvideo_tpu_torch.cli.train \
        --config configs/torch/clip_av_stage2_1b.py --device cuda \
        trainer.total_steps=3 trainer.log_every=1 trainer.checkpoint_dir=None \
        [data.media_type=audio | data.media_type=video]

The JAX package has no full-width audio-visual config, and the reference's
audio-visual script is not in the repository. What this config takes from
where:

  * from configs/clip_stage2_1b.py (the reference's stage-2 1B recipe):
    the vision tower (`VIS`: InternVideo2-1B at 4 x 224 px, tubelet 1, bf16
    compute with fp32 params, remat; here the plain encoder, as JAX's
    VideoCLIPAV has it, not the pretrain wrapper), the bert-large text /
    fusion tower (1024 wide, 24 layers, fusion from layer 19, dropout 0.1),
    `embed_dim` 512, the AdamW schedule, the CLIPLossConfig (VTC + VTM + MLM
    at weight 1, hard negatives, MLM probability 0.5; `uta` does not apply)
    and B 64 with 32 tokens;
  * from the reference's audio-visual model: `audio_tower="beats"`, the
    BEATs_iter3 geometry of `BEATsConfig()` (512 -> 768, 12 layers of 12
    heads, FFN 3072, 320 buckets over 800), which the audio-visual recipe
    initialises from a released checkpoint (none is in the repository, so
    the weights are seeded random); the stage-2 audio-visual fbank of
    data/audio.py, 998 frames x 64 mels (`AudioEncoderConfig(max_frames=998,
    n_mels=64)` only sets the batch's audio shape: with BEATs no
    AudioEncoder is built); BEATs' SAME padding makes that 63 x 4 = 252
    audio tokens;
  * this repository's choices: BEATs computes in bf16 with fp32 params, as
    the towers beside it (`BEATsConfig`'s own default is fp32), and
    `media_type` "audio_video" (Sk 252 + 1025 = 1277 in the fusion
    cross-attention).

On the card: per audio_video step 90 K1 (80 tower with remat, 5 MLM + 5
VTM cross-attention at Sk 1277) and 50 + 50 K4a; BEATs' attention is plain
torch (JAX computes it in XLA). The model starts from seeded random weights;
plug an audio-video-text loader into data["stream"].
"""

from internvideo_tpu_torch.cli.train import RunConfig
from internvideo_tpu_torch.core.mesh import MeshConfig
from internvideo_tpu_torch.models.audio import AudioEncoderConfig
from internvideo_tpu_torch.models.beats import BEATsConfig
from internvideo_tpu_torch.models.bert import BertConfig
from internvideo_tpu_torch.models.internvideo2 import make_config
from internvideo_tpu_torch.models.videoclip_av import VideoCLIPAVConfig
from internvideo_tpu_torch.train.engines.clip import CLIPLossConfig
from internvideo_tpu_torch.train.optim import OptimizerConfig
from internvideo_tpu_torch.train.trainer import TrainerConfig

TOTAL_STEPS = 40_000
VIS = make_config(
    "1B",
    num_frames=4, img_size=224, tubelet_size=1, num_classes=0,
    dtype="bfloat16", param_dtype="float32",
    attn_impl="auto", remat=True,
)

config = RunConfig(
    task="clip_av",
    trainer=TrainerConfig(
        total_steps=TOTAL_STEPS,
        log_every=100,
        checkpoint_dir="checkpoints/stage2_av_1b",
        checkpoint_every=2_000,
        mesh=MeshConfig(replica=1, fsdp=-1, seq=1, tensor=1),
        optimizer=OptimizerConfig(
            lr=5e-5, min_lr=5e-7,
            warmup_steps=TOTAL_STEPS // 10,
            total_steps=TOTAL_STEPS,
            b1=0.9, b2=0.98,
            weight_decay=0.05, clip_grad_norm=3.0,
        ),
    ),
    model=VideoCLIPAVConfig(
        vision=VIS,
        audio=AudioEncoderConfig(max_frames=998, n_mels=64),
        audio_tower="beats",
        beats=BEATsConfig(dtype="bfloat16", param_dtype="float32"),
        text=BertConfig(
            vocab_size=30522, hidden_size=1024, num_layers=24, num_heads=16,
            intermediate_size=4096, fusion_layer=19,
            dtype="bfloat16", param_dtype="float32",
        ),
        embed_dim=512,
        temp_init=0.07,
    ),
    data={"batch_size": 64, "text_len": 32, "media_type": "audio_video", "stream": None},
    engine=CLIPLossConfig(
        vtc=1.0, vtm=1.0, mlm=1.0,
        vtm_hard_neg=True, mlm_probability=0.5,
        vocab_size=30522,
    ),
)
