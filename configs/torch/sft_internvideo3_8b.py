"""InternVideo3-8B packed multimodal SFT on one H100 (PyTorch port).

    python -m internvideo_tpu_torch.cli.train \
        --config configs/torch/sft_internvideo3_8b.py --device cuda \
        trainer.total_steps=3 trainer.log_every=1

The JAX recipe configs/sft_internvideo3_long.py (the reference's
internvideo3_sft_long.py) on one card. Widths are internvideo3_8b's, uncut:
the tower 1152 wide, 27 layers, 16 heads of 72, MLP 4304, deepstack after
blocks 8 / 16 / 24; 4 patch mergers to 4096; the qwen3_8b_mla text model
(4096 wide, 32 heads, kv_lora 896, d_qk 256 / d_v 128, SwiGLU 12288, vocab
151,936, mRoPE (24, 20, 20)); bf16 params, remat. Optimizer as the recipe:
AdamW lr 1e-5 -> 1e-6 cosine, warmup 3 %, weight decay 0.01, clip 1.0.

Cuts, each forced by one 80 GB card:
  1. text depth 36 -> 32 layers: all 36 hold 9.49 B params, 76 GB at 8 bytes
     a param (bf16 params, grads, Adam m and v) before activations; 32
     layers are 8.63 B params (the fixed 1.82 B of embedding, head, tower
     and mergers + 32 x 0.213 B), 69 GB, the largest multiple of 4 whose
     measured step peak stays under 72 GB on an H100 (71.77 GB; 28 layers
     64.97 GB, 24 layers 58.14 GB; PERF.md section 4);
  2. pack 262,144 tokens over sequence parallel 4 -> pack_max_length 8192,
     batch 1 (no sequence parallelism on one card);
  3. ce_chunk_size 8192 -> 2048 (the engine's default; one chunk's fp32
     logits are 2048 x 151,936);
  4. no HF export (hf_export_every 2,000 -> 0: like JAX's, the train CLI
     passes the Trainer no export function, so the setting would do
     nothing; a caller that wants the export builds the Trainer with
     `train/trainer.py:hf_export_fn`) and no checkpoints.

Data: seeded synthetic packed rows (data/mllm_tokenize.py
`synthetic_sft_stream`): each row holds one video sample (16 frames at
224 px, grid 8 x 14 x 14, so 8 vision runs of 49 placeholders between
vision_start / vision_end, about 512 text tokens, 3D mRoPE positions) and
text-only samples of 256-2048 tokens that fill the row, labels -100 on
prompts and pads, pad segment -1. The weights are seeded random: no
InternVideo3 checkpoint, tokenizer or video corpus is in the repository.
With `data.jsonl=<path>` the rows come from a jsonl of conversations and
their video files instead (`cli.train._mllm_jsonl_stream`: characters as
token ids, one 16 x 224 clip a row, the fixed grid 8 x 14 x 14).
"""

from internvideo_tpu_torch.cli.train import RunConfig
from internvideo_tpu_torch.core.mesh import MeshConfig
from internvideo_tpu_torch.data.mllm_tokenize import (
    MLLMTokenizeConfig,
    SyntheticSFTConfig,
    synthetic_sft_stream,
)
from internvideo_tpu_torch.models.presets import internvideo3_8b, qwen3_8b_mla
from internvideo_tpu_torch.train.engines.sft import SFTConfig
from internvideo_tpu_torch.train.optim import OptimizerConfig
from internvideo_tpu_torch.train.trainer import TrainerConfig

TEXT_LAYERS = 32
PACK_LEN = 8192
TOTAL_STEPS = 4_000

config = RunConfig(
    task="sft",
    trainer=TrainerConfig(
        total_steps=TOTAL_STEPS,
        log_every=10,
        checkpoint_dir=None,
        hf_export_every=0,
        mesh=MeshConfig(replica=1, fsdp=-1, seq=1, tensor=1),
        optimizer=OptimizerConfig(
            lr=1e-5, min_lr=1e-6,
            warmup_steps=TOTAL_STEPS // 30,  # warmup_ratio 0.03
            total_steps=TOTAL_STEPS,
            weight_decay=0.01, clip_grad_norm=1.0,
        ),
    ),
    model=internvideo3_8b(text=qwen3_8b_mla(num_layers=TEXT_LAYERS)),
    data={
        "batch_size": 1,
        "pack_max_length": PACK_LEN,
        "stream": synthetic_sft_stream(SyntheticSFTConfig(), batch_size=1,
                                       pack_max_length=PACK_LEN, seed=0),
        # the real data path (`data.jsonl=<path>`): one 16 x 224 clip a row
        "tokenize": MLLMTokenizeConfig(fixed_grid=(8, 14, 14)),
    },
    engine=SFTConfig(ce_chunk_size=2048),
)
