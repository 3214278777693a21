"""Model config presets of the ported families.

Port of the stage-2 VideoCLIP-1B, the M2LA LLM presets, the InternVideo3-8B
and InternVideo2.5-HiCo MLLM presets, the MoE text models (Qwen3-MoE,
DeepSeek-V3, GPT-OSS), the InternVL composes (Intern-S1, Intern-S1-mini)
and the dense-GQA Qwen3-8B of internvideo_tpu/models/presets.py (:26-268),
field for field. `qwen3_mla_tiny`,
`qwen3_moe_tiny` and `qwen3_dense_tiny` are the port's own: each
architecture at test widths, so that `cli.generate` runs on a CPU in
seconds.
"""

from __future__ import annotations

import dataclasses

from internvideo_tpu_torch.models.bert import BertConfig
from internvideo_tpu_torch.models.internvideo2 import InternVideo2Config, make_config
from internvideo_tpu_torch.models.internvl import InternVLConfig
from internvideo_tpu_torch.models.llm import LLMConfig
from internvideo_tpu_torch.models.llm_gqa import GQAConfig
from internvideo_tpu_torch.models.mllm import MLLMConfig
from internvideo_tpu_torch.models.videoclip import VideoCLIPConfig
from internvideo_tpu_torch.models.vision_tower import VisionTowerConfig
from internvideo_tpu_torch.nn.mla import MLAConfig
from internvideo_tpu_torch.nn.moe import MoEConfig
from internvideo_tpu_torch.nn.rope import YarnConfig


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


def qwen3_moe_text(**overrides) -> LLMConfig:
    """Qwen3-MoE-class text model (xtuner model/moe/qwen3.py): 48 layers,
    hidden 2048, 128 routed experts top-8, moe_intermediate 768, with M2LA
    attention (32 heads, latent 512 + 64 rope, 64 nope, 64 v)."""
    cfg = LLMConfig(
        vocab_size=151936, hidden_size=2048, num_layers=48,
        intermediate_size=6144, rope_theta=1_000_000.0, mrope_section=None,
        mla=MLAConfig(
            hidden_size=2048, num_heads=32, kv_lora_rank=512,
            qk_rope_head_dim=64, qk_nope_head_dim=64, v_head_dim=64,
            qkv_bias=False,
        ),
        moe=MoEConfig(
            num_experts=128, top_k=8, intermediate_size=768,
            router_bias_balancing=True, dispatch="dropless",
        ),
        dtype="bfloat16", param_dtype="bfloat16", remat=True,
    )
    return dataclasses.replace(cfg, **overrides)


def qwen3_moe_tiny(**overrides) -> LLMConfig:
    """The JAX MoE LLM test's model (tests/test_mla_llm.py:177-187): 2
    layers, hidden 32, vocab 64, MLA 2 heads, latent 16 + 8 rope, 4 experts
    top 2 of intermediate 24, dropless, fp32. A smoke-test preset, not a
    published model."""
    cfg = LLMConfig(
        vocab_size=64, hidden_size=32, num_layers=2, intermediate_size=48,
        mrope_section=None,
        mla=MLAConfig(hidden_size=32, num_heads=2, kv_lora_rank=16,
                      qk_rope_head_dim=8, qk_nope_head_dim=8, v_head_dim=8),
        moe=MoEConfig(num_experts=4, top_k=2, intermediate_size=24, dispatch="dropless"),
    )
    return dataclasses.replace(cfg, **overrides)


def deepseek_v3(**overrides) -> LLMConfig:
    """DeepSeek-V3 671B (xtuner model/moe/deepseek_v3.py:53-100): 61 layers
    (the first 3 dense, SwiGLU 18432), hidden 7168, MLA kv_lora 512 /
    q_lora 1536 / 128 nope / 64 rope / 128 v over 128 heads, YaRN x40 rope,
    256 routed experts top-8 (sigmoid NoAux router, 8 groups top 4, scaling
    2.5) + 1 shared expert, moe_intermediate 2048."""
    cfg = LLMConfig(
        vocab_size=129280, hidden_size=7168, num_layers=61,
        intermediate_size=18432, rope_theta=10_000.0, mrope_section=None,
        rope_scaling=YarnConfig(
            factor=40.0, original_max_position_embeddings=4096,
            beta_fast=32.0, beta_slow=1.0, mscale=1.0, mscale_all_dim=1.0,
        ),
        mla=MLAConfig(
            hidden_size=7168, num_heads=128, kv_lora_rank=512,
            q_lora_rank=1536, qk_rope_head_dim=64, qk_nope_head_dim=128,
            v_head_dim=128, qkv_bias=False,
        ),
        moe=MoEConfig(
            num_experts=256, top_k=8, intermediate_size=2048,
            scoring_func="sigmoid", router_scaling_factor=2.5,
            norm_topk_prob=True, n_group=8, topk_group=4,
            num_shared_experts=1, router_bias_balancing=True,
            dispatch="dropless",
        ),
        moe_first_k_dense=3,
        dtype="bfloat16", param_dtype="bfloat16", remat=True,
    )
    return dataclasses.replace(cfg, **overrides)


def gpt_oss_moe_text(**overrides) -> LLMConfig:
    """GPT-OSS-class MoE text config (xtuner model/moe/gpt_oss.py:120-170):
    greedy softmax router, clipped-SwiGLU experts (alpha 1.702, limit 7)
    with per-expert biases, no shared experts; M2LA attention with no nope
    part (64 heads, latent 512 + 64 rope, 64 v, q / kv biases)."""
    cfg = LLMConfig(
        vocab_size=201088, hidden_size=2880, num_layers=24,
        intermediate_size=2880, rope_theta=150_000.0, mrope_section=None,
        mla=MLAConfig(
            hidden_size=2880, num_heads=64, kv_lora_rank=512,
            qk_rope_head_dim=64, qk_nope_head_dim=0, v_head_dim=64,
            qkv_bias=True,
        ),
        moe=MoEConfig(
            num_experts=32, top_k=4, intermediate_size=2880,
            scoring_func="softmax", norm_topk_prob=True,
            act_fn="clipped_swiglu", clip_alpha=1.702, clip_limit=7.0,
            expert_bias=True, dispatch="dropless",
        ),
        dtype="bfloat16", param_dtype="bfloat16", remat=True,
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


def intern_s1_mini(**overrides) -> InternVLConfig:
    """Intern-S1-mini compose (intern_s1_config.py:144): InternViT 1024 /
    24 layers (LayerNorm, no QK-norm) at 448 px + the pixel-shuffle
    projector + the dense qwen3_8b_mla text model at vocab 153216."""
    cfg = InternVLConfig(
        vision=InternVideo2Config(
            embed_dim=1024, depth=24, num_heads=16, mlp_ratio=4.0,
            patch_size=14, img_size=448, num_frames=1, tubelet_size=1,
            qk_normalization=False, norm_type="layernorm",
            init_values=0.1, num_classes=0,
            dtype="bfloat16", param_dtype="bfloat16",
        ),
        text=qwen3_8b_mla(vocab_size=153216, mrope_section=None),
        image_token_id=152957,
    )
    return dataclasses.replace(cfg, **overrides)


def intern_s1(**overrides) -> InternVLConfig:
    """Intern-S1 compose (intern_s1_config.py:130): InternViT 3200 / 45
    layers (RMSNorm + whole-dim QK-RMSNorm) at 448 px + the pixel-shuffle
    projector + the qwen3_moe_text MoE text model at vocab 153216."""
    cfg = InternVLConfig(
        vision=InternVideo2Config(
            embed_dim=3200, depth=45, num_heads=25, mlp_ratio=4.0,
            patch_size=14, img_size=448, num_frames=1, tubelet_size=1,
            qk_normalization=True, norm_type="rmsnorm",
            init_values=0.1, num_classes=0,
            dtype="bfloat16", param_dtype="bfloat16",
        ),
        text=qwen3_moe_text(vocab_size=153216),
        image_token_id=152957,
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
