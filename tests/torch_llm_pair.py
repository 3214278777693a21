"""The JAX MLATransformer and the port's on the same weights, for the
serving tests (test_torch_llm_serving.py, test_torch_serving_engine.py):
the JAX model's init loaded through models/convert.py:params_from_jax with
strict=True; the port's model on the kernel route (on the CPU: the
kernels' plain versions), JAX's on its XLA route."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as fnn

from internvideo_tpu.models.llm import LLMConfig as JLLMConfig
from internvideo_tpu.models.llm import MLATransformer as JMLATransformer
from internvideo_tpu.nn.mla import MLAConfig as JMLAConfig
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.models.generation import generate
from internvideo_tpu_torch.models.llm import LLMConfig, MLATransformer
from internvideo_tpu_torch.nn.mla import MLAConfig

# tests/test_serving_engine.py:24-41 and tests/test_mla_llm.py:74 (mRoPE sections)
CONFIGS = {
    "tiny_llm": dict(vocab_size=97, hidden_size=32, num_layers=2, intermediate_size=64,
                     mrope_section=None,
                     mla=dict(hidden_size=32, num_heads=2, kv_lora_rank=16,
                              qk_rope_head_dim=8, qk_nope_head_dim=8, v_head_dim=8)),
    "llm_tiny_mrope": dict(vocab_size=97, hidden_size=64, num_layers=2, intermediate_size=128,
                           rope_theta=10000.0, mrope_section=(3, 3, 2),
                           mla=dict(hidden_size=64, num_heads=4, kv_lora_rank=32,
                                    qk_rope_head_dim=16, qk_nope_head_dim=16,
                                    v_head_dim=16)),
}
_CACHE = {}


def llm_pair(name="tiny_llm"):
    """(JAX model, JAX params, port model) on the same weights."""
    if name not in _CACHE:
        spec = dict(CONFIGS[name])
        mla = spec.pop("mla")
        jcfg = JLLMConfig(**spec, mla=JMLAConfig(**mla), dtype="float32",
                          param_dtype="float32", attn_impl="xla")
        tcfg = LLMConfig(**spec, mla=MLAConfig(**mla), dtype="float32",
                         param_dtype="float32", attn_impl="kernel")
        jm = JMLATransformer(jcfg)
        params = fnn.unbox(jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32)))
        tm = MLATransformer(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
        tm.load_state_dict(params_from_jax(jax.device_get(params), tcfg), strict=True)
        _CACHE[name] = (jm, params, tm.eval())
    return _CACHE[name]


def reference_tokens(tm, prompt, n):
    """The port's greedy `generate` of `n` tokens for one prompt."""
    return generate(tm, torch.from_numpy(np.asarray(prompt)).long()[None],
                    max_new_tokens=n)[0].numpy()
