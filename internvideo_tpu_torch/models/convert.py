"""Weight bridge: the JAX package's param trees -> this port's state_dicts.

Input is the nested dict a JAX module's `init` gives (InternVideo2,
PretrainInternVideo2, CLIPTeacher, MAETeacher, MLATransformer,
GQATransformer, VideoMLLM with either text model), unboxed
(`flax.linen.unbox`) and turned into numpy arrays; a top-level
`{"params": ...}` wrapper is accepted. Translations:

  * flax Dense `kernel` (in, out)     -> torch `weight` (out, in) [transpose]
  * flax Conv `kernel`: 2-D (kh, kw, in, out) -> (out, in, kh, kw); 1-D
    grouped (k, in / groups, out) -> (out, in / groups, k) (BEATs)
  * `blocks_{i}`, `layers_{i}`, `layer_{i}` (BERT) -> `blocks.{i}`,
    `layers.{i}`, `layer.{i}`
  * flax Embed `embedding` (vocab, D) -> `weight`
  * `clip_decoder_{j}`, `mae_decoder_{j}` -> `clip_decoder.{j}`, `mae_decoder.{j}`
  * `deepstack_merger_{j}` (VideoMLLM)  -> `deepstack_merger.{j}`
  * the MLP decoder's `head_0` / `head_2` -> `head.0` / `head.2`
  * LayerNorm `scale` / `bias`        -> `weight` / `bias`
  * int8 serving layers (Int8Dense, Int8WoDense): `kernel_q` (in, out)
    int8 -> `weight_q` (out, in) [transpose], `scale` (1, out) ->
    `scale` (out,)
  * RMSNorm `weight`, LayerScale `gamma`, `cls_token`, the pos embeds and
    biases go across as they are; the `encoder` prefix of the pretrain
    student and the CLIP teacher stays.

For the MLA LLM the names are the reference's HF / xtuner layout:
`embed_tokens.weight`, `layers.{i}.{input,post_attention}_layernorm.weight`,
`layers.{i}.self_attn.{q_proj,kv_a_proj_with_mqa,o_proj}.{weight,bias}`,
`layers.{i}.self_attn.kv_b_proj_kernel` (kept (R, H, nope + v), the JAX raw
param), `layers.{i}.mlp.{gate,up,down}_proj.weight`, `norm.weight`,
`lm_head.weight`. The dense-GQA LLM keeps the same names with
`layers.{i}.self_attn.{q,k,v,o}_proj.{weight,bias}` and the per-head
`layers.{i}.self_attn.{q,k}_norm.weight` (HF checkpoints through
`convert_hf_gqa_llm` wait for checkpoint I/O, ROADMAP queue 1, item 9). The
VideoMLLM tree keeps its JAX top level:
`vision_tower.{patch_embed, pos_embed, blocks.{i}.{norm1, qkv, proj, norm2,
fc1, fc2}}`, `merger.{norm, linear_fc1, linear_fc2}`,
`deepstack_merger.{j}.*` and `language_model.*` (the LLM names above).
VideoCLIP keeps its flax names too: `vision_encoder.*` (the InternVideo2 or
pretrain-student names above), `text_encoder.{word,position,token_type}_
embeddings.weight`, `text_encoder.layer.{i}.{attention,crossattention}.
{query,key,value,proj}`, `..._norm`, `intermediate`, `output`,
`mlm_{transform,norm,decoder}`, `vision_proj`, `text_proj`, `itm_head` and
the scalar `temp`; VideoCLIPAV adds `audio_encoder.*` (the simple tower's
`patch_embed`, `pos_embed`, `blocks.{i}.*`, `norm`; or BEATs'
`patch_embedding`, `layer_norm`, `post_extract_proj`, `pos_conv`,
`encoder_layer_norm`, `layers.{i}.self_attn.{q,k,v,out}_proj`,
`grep_linear`, `grep_a` (1, H, 1, 1) and layer 0's
`relative_attention_bias` (num_buckets, H), `self_attn_layer_norm`,
`fc1`, `fc2`, `final_layer_norm`), `audio_proj`, `av_proj` and
`audio_to_fusion`. VideoChat (models/chat.py) likewise: `vision_encoder.*`
(the InternVideo2 names), `qformer.query_tokens` (a parameter on the module,
as it is), `qformer.vision_in`, `qformer.bert.layer.{i}.*` (a fusion-only
BERT: no embeddings, no MLM head, cross-attention from layer 0), `llm_proj`
and `language_model.*` (the LLM names above).

ActionFormer (models/actionformer.py) goes through
`actionformer_params_from_jax`: flax 1-D Conv kernels (3, in, out) become
`Conv1d` weights (out, in, 3), `stem{i}` / `level{l}` become `stem.{i}` /
`levels.{l - 1}`, the blocks' `LayerNorm_0` / `LayerNorm_1` become `norm1` /
`norm2`, the heads' `conv{i}` / `ln{i}` become `conv.{i}` / `ln.{i}`, and
each scalar `scale_{l}` becomes `scales.{l}`. The STAL `ROIActionHead`
(models/stal.py: `fc1`, `fc2`, `cls_score`) maps with `params_from_jax`
as it is.

numpy bfloat16 arrays (ml_dtypes) are reinterpreted bit for bit, so bf16
weights load exactly. The module's `load_state_dict(sd, strict=True)` then
accepts the result.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from internvideo_tpu_torch.models.beats import BEATsConfig

_BLOCK = re.compile(r"^(?:blocks|layers|layer)_(\d+)$")
# flax module names with an index -> torch ModuleList / Sequential entries
_INDEXED = re.compile(
    r"^(blocks|layers|layer|clip_decoder|mae_decoder|head|deepstack_merger)_(\d+)$")


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _check_depth(tree: Mapping, depth: int) -> None:
    blocks = sorted(int(m.group(1)) for k in tree if (m := _BLOCK.match(k)))
    if blocks != list(range(depth)):
        raise ValueError(f"param tree has blocks {blocks}, config depth {depth}")


def params_from_jax(params: Mapping, cfg=None) -> dict[str, torch.Tensor]:
    """JAX params -> state_dict of the matching port module. With `cfg` (an
    InternVideo2 or teacher config with `depth`, an LLMConfig, GQAConfig,
    VisionTowerConfig or BertConfig with `num_layers`, an MLLMConfig, a
    VideoCLIPConfig, a VideoCLIPAVConfig or a VideoChatConfig) the
    `blocks_{i}` / `layers_{i}` / `layer_{i}` of each tower must be exactly
    range(depth)."""
    if "params" in params:
        params = params["params"]
    if cfg is not None:
        if hasattr(cfg, "embed_dim") and hasattr(cfg, "text"):  # VideoCLIP(AV)Config
            vision = params["vision_encoder"]
            _check_depth(vision["encoder"] if "encoder" in vision else vision, cfg.vision.depth)
            _check_depth(params["text_encoder"], cfg.text.num_layers)
            if hasattr(cfg, "audio_tower"):  # VideoCLIPAVConfig
                _check_depth(params["audio_encoder"], cfg.audio.depth
                             if cfg.audio_tower == "simple" else
                             (cfg.beats or BEATsConfig()).encoder_layers)
        elif hasattr(cfg, "qformer"):  # VideoChatConfig
            _check_depth(params["vision_encoder"], cfg.vision.depth)
            _check_depth(params["qformer"]["bert"], cfg.qformer.bert.num_layers)
            _check_depth(params["language_model"], cfg.llm.num_layers)
        elif hasattr(cfg, "vision") and hasattr(cfg, "text"):
            _check_depth(params["vision_tower"], cfg.vision.num_layers)
            _check_depth(params["language_model"], cfg.text.num_layers)
        else:
            _check_depth(params, cfg.num_layers if hasattr(cfg, "num_layers") else cfg.depth)
    sd: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        int8 = "kernel_q" in node
        for name, child in node.items():
            m = _INDEXED.match(name)
            key = f"{m.group(1)}.{m.group(2)}" if m else name
            path = f"{prefix}{key}"
            if isinstance(child, Mapping):
                walk(child, path + ".")
                continue
            t = _to_tensor(child)
            if name == "kernel":
                # Dense (in, out); Conv (*kernel, in / groups, out) -> (out, in / groups, *kernel)
                perm = (1, 0) if t.dim() == 2 else (t.dim() - 1, t.dim() - 2,
                                                    *range(t.dim() - 2))
                sd[f"{prefix}weight"] = t.permute(perm).contiguous()
            elif int8 and name == "kernel_q":
                sd[f"{prefix}weight_q"] = t.t().contiguous()
            elif int8 and name == "scale":
                sd[f"{prefix}scale"] = t.reshape(-1)
            elif name in ("scale", "embedding"):
                sd[f"{prefix}weight"] = t
            else:
                sd[path] = t

    walk(params, "")
    return sd


_ACTIONFORMER_RENAMES = (
    (re.compile(r"^stem(\d+)\."), lambda m: f"stem.{m.group(1)}."),
    (re.compile(r"^level(\d+)\."), lambda m: f"levels.{int(m.group(1)) - 1}."),
    (re.compile(r"\.LayerNorm_([01])\."), lambda m: f".norm{int(m.group(1)) + 1}."),
    (re.compile(r"\.(conv|ln)(\d+)\."), lambda m: f".{m.group(1)}.{m.group(2)}."),
    (re.compile(r"^scale_(\d+)$"), lambda m: f"scales.{m.group(1)}"),
)


def actionformer_params_from_jax(params: Mapping, cfg=None) -> dict[str, torch.Tensor]:
    """JAX ActionFormer params -> the port ActionFormer's state_dict. With
    `cfg` (an ActionFormerConfig) the stem blocks must be exactly
    range(num_blocks) and the level blocks range(1, num_levels)."""
    if "params" in params:
        params = params["params"]
    if cfg is not None:
        stem = sorted(int(k[4:]) for k in params if re.fullmatch(r"stem\d+", k))
        levels = sorted(int(k[5:]) for k in params if re.fullmatch(r"level\d+", k))
        if stem != list(range(cfg.num_blocks)) or levels != list(range(1, cfg.num_levels)):
            raise ValueError(f"param tree has stem {stem} / levels {levels}, config "
                             f"num_blocks {cfg.num_blocks} / num_levels {cfg.num_levels}")
    sd = {}
    for key, t in params_from_jax(params).items():
        for pattern, repl in _ACTIONFORMER_RENAMES:
            key = pattern.sub(repl, key)
        sd[key] = t
    return sd
