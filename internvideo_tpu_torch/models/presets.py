"""Model config presets of the ported families.

Port of the stage-2 VideoCLIP-1B, the M2LA LLM presets, the InternVideo3-8B
and InternVideo2.5-HiCo MLLM presets and the dense-GQA Qwen3-8B of
internvideo_tpu/models/presets.py (:26-42, :45-131, :256-268), field for
field; the other presets wait with their families (ROADMAP queue 1, items
8 and 10). `qwen3_mla_tiny` and `qwen3_dense_tiny` are the port's own:
each architecture at test widths, so that `cli.generate` runs on a CPU in
seconds.
"""

from __future__ import annotations

import dataclasses

from internvideo_tpu_torch.models.bert import BertConfig
from internvideo_tpu_torch.models.internvideo2 import make_config
from internvideo_tpu_torch.models.llm import LLMConfig
from internvideo_tpu_torch.models.llm_gqa import GQAConfig
from internvideo_tpu_torch.models.mllm import MLLMConfig
from internvideo_tpu_torch.models.videoclip import VideoCLIPConfig
from internvideo_tpu_torch.models.vision_tower import VisionTowerConfig
from internvideo_tpu_torch.nn.mla import MLAConfig


def internvideo2_stage2_1b(**overrides) -> VideoCLIPConfig:
    """Stage-2 VideoCLIP-1B: the 1B vision tower at 4 x 224 (bf16, fp32
    params; S = 1025) + the bert-large fusion tower (d 1024, 24 layers, 16
    heads, intermediate 4096, fusion_layer 19; bf16, fp32 params),
    embed_dim 512."""
    cfg = VideoCLIPConfig(
        vision=make_config(
            "1B", num_frames=4, img_size=224,
            dtype="bfloat16", param_dtype="float32",
        ),
        text=BertConfig(
            vocab_size=30522, hidden_size=1024, num_layers=24, num_heads=16,
            intermediate_size=4096, fusion_layer=19,
            dtype="bfloat16", param_dtype="float32",
        ),
        embed_dim=512,
    )
    return dataclasses.replace(cfg, **overrides)


def qwen3_8b_mla(**overrides) -> LLMConfig:
    """Qwen3-8B-MLA text model (xtuner qwen3.py:377-407), the text tower of
    InternVideo3-8B: 36 layers, hidden 4096, SwiGLU 12288, MLA kv_lora 896
    / 128 rope / 128 nope / 128 v, rope_theta 5e6, mRoPE [24, 20, 20]."""
    cfg = LLMConfig(
        vocab_size=151936, hidden_size=4096, num_layers=36,
        intermediate_size=12288, rope_theta=5_000_000.0,
        mrope_section=(24, 20, 20),
        mla=MLAConfig(
            hidden_size=4096, num_heads=32, kv_lora_rank=896,
            qk_rope_head_dim=128, qk_nope_head_dim=128, v_head_dim=128,
            qkv_bias=True,
        ),
        dtype="bfloat16", param_dtype="bfloat16", remat=True,
    )
    return dataclasses.replace(cfg, **overrides)


def qwen3_2b_mla(**overrides) -> LLMConfig:
    """2B-class M2LA text model: the qwen3_8b_mla architecture at hidden
    2560, 24 layers, SwiGLU 8192, 20 heads, MLA latent 512 + 64 rope;
    mrope_section rescaled to sum to qk_rope_head_dim // 2 = 32."""
    cfg = qwen3_8b_mla(
        hidden_size=2560, num_layers=24, intermediate_size=8192,
        remat=False, mrope_section=(12, 10, 10),
    )
    cfg = dataclasses.replace(
        cfg,
        mla=dataclasses.replace(
            cfg.mla, hidden_size=2560, num_heads=20,
            kv_lora_rank=512, qk_rope_head_dim=64,
        ),
    )
    return dataclasses.replace(cfg, **overrides)


def qwen3_mla_tiny(**overrides) -> LLMConfig:
    """The qwen3_8b_mla architecture at the JAX serving tests' widths
    (tests/test_serving_engine.py:24-41): 2 layers, hidden 32, vocab 97,
    MLA 2 heads, latent 16 + 8 rope, fp32. A smoke-test preset, not a
    published model."""
    cfg = LLMConfig(
        vocab_size=97, hidden_size=32, num_layers=2, intermediate_size=64,
        mrope_section=None,
        mla=MLAConfig(hidden_size=32, num_heads=2, kv_lora_rank=16,
                      qk_rope_head_dim=8, qk_nope_head_dim=8, v_head_dim=8),
    )
    return dataclasses.replace(cfg, **overrides)


def internvideo3_8b(**overrides) -> MLLMConfig:
    """InternVideo3-8B (internvideo3_config.py:19-120): SigLIP-style tower
    1152d / 27 layers, deepstack after blocks [8, 16, 24], and the
    Qwen3-8B-MLA text model."""
    cfg = MLLMConfig(
        vision=VisionTowerConfig(
            hidden_size=1152, num_layers=27, num_heads=16,
            intermediate_size=4304, patch_size=16, temporal_patch_size=2,
            spatial_merge_size=2, pos_embed_grid=48,
            deepstack_indexes=(8, 16, 24), text_hidden_size=4096,
            dtype="bfloat16", param_dtype="bfloat16",
        ),
        text=qwen3_8b_mla(),
        image_token_id=151655,
        video_token_id=151656,
        vision_start_token_id=151652,
        vision_end_token_id=151653,
    )
    return dataclasses.replace(cfg, **overrides)


def internvideo25_hico_2b(**overrides) -> MLLMConfig:
    """Long-video serving compose (the InternVideo2.5 HiCo recipe on a
    2B-class text model): the InternVideo3-8B vision tower + HiCo-R16
    per-frame token compression (16 tokens per merged frame) + the
    qwen3_2b_mla text model. The deepstack taps are off under HiCo
    (models/mllm.py encode_video). 128 input frames -> 64 merged frames x 16
    tokens = 1024 visual tokens."""
    text = qwen3_2b_mla()
    cfg = MLLMConfig(
        vision=VisionTowerConfig(
            hidden_size=1152, num_layers=27, num_heads=16,
            intermediate_size=4304, patch_size=16, temporal_patch_size=2,
            spatial_merge_size=2, pos_embed_grid=48,
            deepstack_indexes=(8, 16, 24),
            text_hidden_size=text.hidden_size,
            dtype="bfloat16", param_dtype="bfloat16",
        ),
        text=text,
        hico_tokens_per_frame=16,
        image_token_id=151655,
        video_token_id=151656,
        vision_start_token_id=151652,
        vision_end_token_id=151653,
    )
    return dataclasses.replace(cfg, **overrides)


def qwen3_8b_dense(**overrides) -> GQAConfig:
    """Stock dense-GQA Qwen3-8B (HF config: 36 layers, hidden 4096, 32 q /
    8 kv heads, head_dim 128, SwiGLU 12288, qk-norm, rope 1e6)."""
    cfg = GQAConfig(
        vocab_size=151936, hidden_size=4096, num_layers=36,
        num_heads=32, num_kv_heads=8, head_dim=128,
        intermediate_size=12288, rope_theta=1_000_000.0, qk_norm=True,
        dtype="bfloat16", param_dtype="bfloat16", remat=True,
    )
    return dataclasses.replace(cfg, **overrides)


def qwen3_dense_tiny(**overrides) -> GQAConfig:
    """The qwen3_8b_dense architecture at the JAX GQA tests' widths
    (tests/test_gqa_llm.py:11-15): 2 layers, hidden 64, 4 q / 2 kv heads of
    16, vocab 97, fp32, no remat. A smoke-test preset, not a published
    model."""
    cfg = qwen3_8b_dense(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
                         num_kv_heads=2, head_dim=None, intermediate_size=128,
                         dtype="float32", param_dtype="float32", remat=False)
    return dataclasses.replace(cfg, **overrides)
