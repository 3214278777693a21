"""InternVideo2-Chat video QA on one GPU (PyTorch port): `VideoChatConfig()`'s
own defaults, nothing cut, in bf16.

    python -m internvideo_tpu_torch.cli.eval \
        --config configs/torch/chat_videoqa_8b.py --device cuda

BASELINE config #4: the 1B ViT (40 blocks, D 1408, 16 heads) at 8 x 224
(S = 2049), the QFormer (32 queries, BERT-base: 12 layers, 12 heads,
cross-attention in every layer) and the Qwen3-8B M2LA LLM (36 layers, 4096
wide, vocab 151,936, (d_qk, d_v) = (256, 128)). Weights and activations are
bf16 (~19 GB), except what JAX keeps fp32 whatever the dtype: the norm
weights, the LayerScale gammas and the bridge's query tokens, `vision_in`
and `llm_proj`. Weights are the seeded init; the repository holds no
tokenizer, so the data (eval/chat_videoqa.py) are seeded 8 x 224 clips, a
fixed 64-id prompt and a fixed id -> word table: 8 clips in batches of 4,
32 greedy tokens each through `models/generation.generate` (dense latent
cache) on the card. Random weights answer at random: the accuracy is a
smoke value (the JAX default matcher, substring: a 32-word answer from the
32-word table holds a given gold word about 64 % of the time by chance).
"""

import dataclasses

import torch

from internvideo_tpu_torch.cli.eval import EvalRunConfig
from internvideo_tpu_torch.eval.chat_videoqa import chat_videoqa_data
from internvideo_tpu_torch.models.chat import VideoChat, VideoChatConfig

CLIPS, BATCH, PROMPT_LEN, NEW_TOKENS = 8, 4, 64, 32


def _bf16(cfg):
    return dataclasses.replace(cfg, dtype="bfloat16", param_dtype="bfloat16")


_base = VideoChatConfig()
MODEL = dataclasses.replace(
    _base, vision=_bf16(_base.vision),
    qformer=dataclasses.replace(_base.qformer, bert=_bf16(_base.qformer.bert)),
    llm=_bf16(_base.llm))


def _data(model, device):
    chat = VideoChat(model, device=device,
                     generator=torch.Generator(device=device).manual_seed(0)).eval()
    return chat_videoqa_data(chat, clips=CLIPS, batch_size=BATCH, prompt_len=PROMPT_LEN,
                             new_tokens=NEW_TOKENS)


config = EvalRunConfig(task="videoqa", model=MODEL, data=_data, options={"matcher": "substring"})
