"""Tiny CPU-runnable InternVideo2-Chat video QA for the PyTorch port
(synthetic smoke): configs/torch/chat_videoqa_8b.py's path at
tests/test_chat_demo.py's widths (ViT 32 wide, 1 block, 2 x 28 px; QFormer
of 4 queries, 2 layers; M2LA LLM 48 wide, 2 layers, vocab 120), fp32.

    python -m internvideo_tpu_torch.cli.eval \
        --config configs/torch/chat_videoqa_tiny.py --device cpu
"""

import torch

from internvideo_tpu_torch.cli.eval import EvalRunConfig
from internvideo_tpu_torch.eval.chat_videoqa import chat_videoqa_data
from internvideo_tpu_torch.models.bert import BertConfig
from internvideo_tpu_torch.models.chat import QFormerConfig, VideoChat, VideoChatConfig
from internvideo_tpu_torch.models.internvideo2 import InternVideo2Config
from internvideo_tpu_torch.models.llm import LLMConfig
from internvideo_tpu_torch.nn.mla import MLAConfig

MODEL = VideoChatConfig(
    vision=InternVideo2Config(embed_dim=32, depth=1, num_heads=2, mlp_ratio=2.0, patch_size=14,
                              img_size=28, num_frames=2, tubelet_size=1, clip_embed_dim=16),
    qformer=QFormerConfig(
        num_queries=4,
        bert=BertConfig(vocab_size=16, hidden_size=32, num_layers=2, num_heads=2,
                        intermediate_size=64, fusion_layer=0, dropout=0.0)),
    llm=LLMConfig(vocab_size=120, hidden_size=48, num_layers=2, intermediate_size=96,
                  mrope_section=None,
                  mla=MLAConfig(hidden_size=48, num_heads=2, kv_lora_rank=24,
                                qk_rope_head_dim=8, qk_nope_head_dim=8, v_head_dim=8)),
)


def _data(model, device):
    chat = VideoChat(model, device=device,
                     generator=torch.Generator(device=device).manual_seed(0)).eval()
    return chat_videoqa_data(chat, clips=4, batch_size=2, prompt_len=5, new_tokens=4)


config = EvalRunConfig(task="videoqa", model=MODEL, data=_data, options={"matcher": "substring"})
