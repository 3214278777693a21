"""The JAX VideoMLLM and the port's on the same weights, and packed SFT rows,
for test_torch_mllm.py and test_torch_sft.py: the configs/sft_tiny.py
widths with special token ids inside the 256-token vocabulary, so that the
packed rows carry vision runs. The JAX model runs its XLA attention route;
the port's the kernel route (on the CPU: the kernels' plain versions)."""

import jax
import numpy as np
import torch
from flax import linen as fnn

from internvideo_tpu.models.llm import LLMConfig as JLLMConfig
from internvideo_tpu.models.mllm import MLLMConfig as JMLLMConfig
from internvideo_tpu.models.mllm import VideoMLLM as JVideoMLLM
from internvideo_tpu.models.vision_tower import VisionTowerConfig as JVisionTowerConfig
from internvideo_tpu.nn.mla import MLAConfig as JMLAConfig
from internvideo_tpu_torch.data.mllm_tokenize import SyntheticSFTConfig, synthetic_sft_stream
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.models.llm import LLMConfig
from internvideo_tpu_torch.models.mllm import MLLMConfig, VideoMLLM
from internvideo_tpu_torch.models.vision_tower import VisionTowerConfig
from internvideo_tpu_torch.nn.mla import MLAConfig

VISION = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64, patch_size=8,
              temporal_patch_size=2, spatial_merge_size=2, pos_embed_grid=6,
              deepstack_indexes=(0, 1), text_hidden_size=48)
TEXT = dict(vocab_size=256, hidden_size=48, num_layers=2, intermediate_size=96,
            mrope_section=(2, 1, 1))
MLA = dict(hidden_size=48, num_heads=2, kv_lora_rank=24, qk_rope_head_dim=8,
           qk_nope_head_dim=8, v_head_dim=8)
IDS = dict(image_token_id=250, video_token_id=251, vision_start_token_id=252,
           vision_end_token_id=253)
# 4 frames at 32 px: grid 2 x 4 x 4, two vision runs of 4 placeholders
DATA = SyntheticSFTConfig(vocab_size=256, im_start_token_id=254, im_end_token_id=255,
                          vision_start_token_id=252, vision_end_token_id=253,
                          video_token_id=251, num_frames=4, img_size=32, patch_size=8,
                          video_text_tokens=(6, 5, 8), text_lengths=(8, 20))
PACK = 64


def configs(remat=False):
    jcfg = JMLLMConfig(
        vision=JVisionTowerConfig(**VISION, attn_impl="xla"),
        text=JLLMConfig(**TEXT, mla=JMLAConfig(**MLA), attn_impl="xla", remat=remat), **IDS)
    tcfg = MLLMConfig(
        vision=VisionTowerConfig(**VISION, attn_impl="kernel"),
        text=LLMConfig(**TEXT, mla=MLAConfig(**MLA), attn_impl="kernel", remat=remat), **IDS)
    return jcfg, tcfg


def packed_batches(batch_size=2, seed=0):
    return synthetic_sft_stream(DATA, batch_size=batch_size, pack_max_length=PACK, seed=seed)


def _visible(params):
    """The lm_head at std ~0.5 instead of 0.02, so that the logits (and so
    the loss and its gradients) move well above the tolerances."""
    params = jax.tree.map(np.asarray, params)
    lm = params["language_model"]
    lm["lm_head"]["kernel"] = lm["lm_head"]["kernel"] * 25
    return params


def mllm_pair(remat=False):
    """(JAX config, JAX model, visible JAX params as numpy, port config,
    port model on them)."""
    jcfg, tcfg = configs(remat)
    jm = JVideoMLLM(jcfg)
    batch = next(packed_batches(1))
    params = fnn.unbox(jm.init(jax.random.key(0), batch["input_ids"], batch["video"],
                               position_ids=batch["position_ids"],
                               segment_ids=batch["segment_ids"]))["params"]
    params = _visible(params)
    tm = VideoMLLM(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(params_from_jax(params, tcfg), strict=True)
    return jcfg, jm, params, tcfg, tm


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
