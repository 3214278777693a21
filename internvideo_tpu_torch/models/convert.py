"""Weight bridges: reference checkpoints -> the JAX package's param trees,
and those trees <-> this port's state_dicts.

Two layers, as in the JAX package:

  * the reference converters (`convert_*`, `export_*`): a copy of
    internvideo_tpu/models/convert.py on torch CPU tensors (numpy cannot
    hold bf16 without ml_dtypes). Each returns the same nested tree as its
    JAX counterpart, key for key and bit for bit: a reference or HF state
    dict (torch tensors or numpy arrays) in, `{"params": tree}` out, and
    the HF exports back. Ported: the InternVideo2 encoder (fused qkv; the
    Conv3d patchify as a Dense in (kt, kh, kw, C) order), the UMT pretrain
    student and its CLIP / VideoMAE teachers, stage 2 with HF BERT, BEATs,
    the HF / xtuner MLA LLM (its rope rows permuted to half-split), the HF
    GQA LLM, InternVideo3 (vision, projector, text), and InternViT /
    InternVL (the InternVL / Intern-S1 compose). The converters of models
    the port does not have yet (ViCLIP, MobileCLIP / CLIP text,
    UniFormerV2, the BEATs tokenizer) wait on ROADMAP queue 1, item 10.
    BEATs' weight-normed position conv is folded in numpy as JAX folds it;
    a bf16 checkpoint folds in fp32 and rounds once (JAX rounds each
    ml_dtypes op).
  * `params_from_jax` maps such a tree to a port module's state_dict, and
    `params_to_jax(state_dict, model)` maps it back (its exact inverse), so
    the exports and the trainer's HF export run on a port model's weights
    through the copies of JAX's export code.

`params_from_jax`'s input is the nested dict a JAX module's `init` gives (InternVideo2,
PretrainInternVideo2, CLIPTeacher, MAETeacher, MLATransformer,
GQATransformer, VideoMLLM with either text model, InternVLChat), unboxed
(`flax.linen.unbox`), as numpy arrays or torch tensors; a top-level
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
`lm_head.weight`; a MoE layer's `mlp` holds the JAX names (the router
`kernel` -> `mlp.router.weight` transposed, the stacks `mlp.w_gate` / `w_up`
(E, D, I) and `mlp.w_down` (E, I, D) and the biases `mlp.b_{gate,up,down}`
as they are, `mlp.shared_{gate,up,down}_proj.weight`). The dense-GQA LLM keeps the same names with
`layers.{i}.self_attn.{q,k,v,o}_proj.{weight,bias}` and the per-head
`layers.{i}.self_attn.{q,k}_norm.weight`. The
VideoMLLM tree keeps its JAX top level:
`vision_tower.{patch_embed, pos_embed, blocks.{i}.{norm1, qkv, proj, norm2,
fc1, fc2}}`, `merger.{norm, linear_fc1, linear_fc2}`,
`deepstack_merger.{j}.*` and `language_model.*` (the LLM names above). InternVLChat
(models/internvl.py): `vision_tower.*` (the InternVideo2 names),
`mlp1_norm`, `mlp1_fc1`, `mlp1_fc2` and `language_model.*`.
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
weights load exactly; torch tensors go across as they are. The module's
`load_state_dict(sd, strict=True)` then accepts the result.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from internvideo_tpu_torch.core.checkpoint import as_tensor
from internvideo_tpu_torch.models.beats import BEATsConfig

_BLOCK = re.compile(r"^(?:blocks|layers|layer)_(\d+)$")
# flax module names with an index -> torch ModuleList / Sequential entries
_INDEXED = re.compile(
    r"^(blocks|layers|layer|clip_decoder|mae_decoder|head|deepstack_merger)_(\d+)$")


def _check_depth(tree: Mapping, depth: int) -> None:
    blocks = sorted(int(m.group(1)) for k in tree if (m := _BLOCK.match(k)))
    if blocks != list(range(depth)):
        raise ValueError(f"param tree has blocks {blocks}, config depth {depth}")


def params_from_jax(params: Mapping, cfg=None) -> dict[str, torch.Tensor]:
    """JAX params -> state_dict of the matching port module. With `cfg` (an
    InternVideo2 or teacher config with `depth`, an LLMConfig, GQAConfig,
    VisionTowerConfig or BertConfig with `num_layers`, an MLLMConfig, a
    VideoCLIPConfig, a VideoCLIPAVConfig, a VideoChatConfig or an
    InternVLConfig) the
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
        elif hasattr(cfg, "downsample_ratio"):  # InternVLConfig
            _check_depth(params["vision_tower"], cfg.vision.depth)
            _check_depth(params["language_model"], cfg.text.num_layers)
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
            t = as_tensor(child)
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


# ---------------------------------------------------------------------------
# params_to_jax: a port module's state_dict -> the JAX param tree
# ---------------------------------------------------------------------------

_INDEXED_NAMES = frozenset(("blocks", "layers", "layer", "clip_decoder", "mae_decoder", "head",
                            "deepstack_merger"))


def _jax_path(key: str) -> list[str]:
    """`blocks.3.attn.qkv` -> ["blocks_3", "attn", "qkv"]: a numeric part
    joins the indexed name before it (params_from_jax's `_INDEXED`)."""
    out: list[str] = []
    for part in key.split("."):
        if part.isdigit() and out and out[-1] in _INDEXED_NAMES:
            out[-1] = f"{out[-1]}_{part}"
        else:
            out.append(part)
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor], model: torch.nn.Module) -> dict:
    """The exact inverse of `params_from_jax`: `model`'s state_dict (or one
    with its keys) -> `{"params": tree}` of the JAX module, CPU tensors.
    The module gives each weight's kind, which the names alone do not: an
    `Embedding`'s weight is the flax `embedding`, a LayerNorm's the flax
    `scale`, an RMSNorm's stays `weight`, any other 2-D weight is a Dense
    `kernel` (transposed back) and a weight of higher rank a Conv `kernel`
    (permuted back); an int8 layer's `weight_q` / `scale` are `kernel_q`
    (transposed back) / a (1, out) `scale`."""
    from internvideo_tpu_torch.ops.quant import _Int8Linear

    tree: dict = {}
    for key, t in state_dict.items():
        t = as_tensor(t).detach().cpu()
        prefix, _, leaf = key.rpartition(".")
        module = model.get_submodule(prefix) if prefix else model
        kind = type(module).__name__
        if isinstance(module, _Int8Linear) and leaf in ("weight_q", "scale"):
            leaf, t = (("kernel_q", t.t().contiguous()) if leaf == "weight_q"
                       else ("scale", t.reshape(1, -1)))
        elif leaf == "weight" and kind.endswith("Embedding"):
            leaf = "embedding"
        elif leaf == "weight" and kind.endswith("LayerNorm"):
            leaf = "scale"
        elif leaf == "weight" and kind != "RMSNorm" and t.dim() >= 2:
            # Dense (out, in) -> (in, out); Conv (out, in / groups, *kernel) -> (*kernel, in /
            # groups, out); a view, as `_T` is
            perm = (1, 0) if t.dim() == 2 else (*range(2, t.dim()), 1, 0)
            leaf, t = "kernel", t.permute(perm)
        path = _jax_path(prefix) if prefix else []
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return {"params": tree}


# ---------------------------------------------------------------------------
# Reference converters: a copy of internvideo_tpu/models/convert.py on torch
# tensors. `_T` is numpy's 2-D `.T` as a view: `params_from_jax` transposes
# it back to the source's own layout without a copy, and the writers
# (safetensors, npz) make what they write contiguous.
# ---------------------------------------------------------------------------


def _T(a) -> torch.Tensor:
    return as_tensor(a).t()


def _patchify_kernel(w) -> torch.Tensor:
    """Conv3d (D, C, kt, kh, kw) -> Dense ((kt kh kw C), D)."""
    w = as_tensor(w)
    return w.permute(2, 3, 4, 1, 0).reshape(-1, w.shape[0]).contiguous()


def _linear(sd, prefix):
    out = {"kernel": _T(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = as_tensor(sd[f"{prefix}.bias"])
    return out


def _layernorm(sd, prefix):
    return {"scale": as_tensor(sd[f"{prefix}.weight"]), "bias": as_tensor(sd[f"{prefix}.bias"])}


def _rmsnorm(sd, prefix):
    return {"weight": as_tensor(sd[f"{prefix}.weight"])}


def convert_internvideo2_encoder(sd: Mapping, *, depth: int, prefix: str = "") -> dict:
    """Reference InternVideo2 encoder state_dict -> InternVideo2 params
    (JAX convert.py:40-119)."""
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    p: dict = {"patch_embed": {"proj": {"kernel": _patchify_kernel(sd["patch_embed.proj.weight"])}}}
    if "patch_embed.proj.bias" in sd:
        p["patch_embed"]["proj"]["bias"] = as_tensor(sd["patch_embed.proj.bias"])
    p["cls_token"] = as_tensor(sd["cls_token"])
    if "pos_embed" in sd:
        p["pos_embed"] = as_tensor(sd["pos_embed"])[0]  # drop the leading broadcast dim
    for i in range(depth):
        b = f"blocks.{i}"
        blk = {
            "norm1": _rmsnorm(sd, f"{b}.norm1"),
            "norm2": _rmsnorm(sd, f"{b}.norm2"),
            "mlp": {"fc1": _linear(sd, f"{b}.mlp.fc1"), "fc2": _linear(sd, f"{b}.mlp.fc2")},
        }
        attn = {"qkv": {"kernel": _T(sd[f"{b}.attn.qkv.weight"])},  # (D, 3D) flat
                "proj": _linear(sd, f"{b}.attn.proj")}
        if f"{b}.attn.qkv.bias" in sd:
            attn["qkv"]["bias"] = as_tensor(sd[f"{b}.attn.qkv.bias"])
        if f"{b}.attn.q_norm.weight" in sd:
            attn["q_norm"] = _rmsnorm(sd, f"{b}.attn.q_norm")
            attn["k_norm"] = _rmsnorm(sd, f"{b}.attn.k_norm")
        blk["attn"] = attn
        if f"{b}.ls1.gamma" in sd:
            blk["ls1"] = {"gamma": as_tensor(sd[f"{b}.ls1.gamma"])}
            blk["ls2"] = {"gamma": as_tensor(sd[f"{b}.ls2.gamma"])}
        p[f"blocks_{i}"] = blk
    if "clip_projector.norm1_q.weight" in sd:
        cp = "clip_projector"
        cross = {name: _linear(sd, f"{cp}.cross_attn.{name}") for name in ("q", "k", "v", "proj")}
        # the reference keeps q / k / v biases as separate Parameters (q_bias, ...)
        for name in ("q", "k", "v"):
            if f"{cp}.cross_attn.{name}_bias" in sd:
                cross[name]["bias"] = as_tensor(sd[f"{cp}.cross_attn.{name}_bias"])
        p["clip_projector"] = {
            "norm1_q": _layernorm(sd, f"{cp}.norm1_q"),
            "norm1_k": _layernorm(sd, f"{cp}.norm1_k"),
            "norm1_v": _layernorm(sd, f"{cp}.norm1_v"),
            "cross_attn": cross,
        }
    if "fc_norm.weight" in sd:
        p["fc_norm"] = _layernorm(sd, "fc_norm")
    if "head.weight" in sd:
        p["head"] = _linear(sd, "head")
    return {"params": p}


def convert_internvl_clip_teacher(sd: Mapping, *, depth: int) -> dict:
    """InternVL_CLIP state_dict -> CLIPTeacher params: the encoder naming,
    nested under `encoder` (JAX convert.py:127-137)."""
    return {"params": {"encoder": convert_internvideo2_encoder(sd, depth=depth)["params"]}}


def convert_videomae_teacher(sd: Mapping, *, depth: int, num_patches: "int | None" = None) -> dict:
    """videomae.py VisionTransformer state_dict -> MAETeacher params (JAX
    convert.py:140-197): no cls token; the (q_bias, 0, v_bias) qkv bias;
    gamma_1 / gamma_2 as ls1 / ls2."""
    from internvideo_tpu_torch.models.teachers import sinusoid_table_1d

    w = as_tensor(sd["patch_embed.proj.weight"])  # (D, C, kt, kh, kw)
    d = w.shape[0]
    p: dict = {"patch_embed": {"proj": {"kernel": _patchify_kernel(w)}}}
    if "patch_embed.proj.bias" in sd:
        p["patch_embed"]["proj"]["bias"] = as_tensor(sd["patch_embed.proj.bias"])
    if "pos_embed" in sd:
        p["pos_embed"] = as_tensor(sd["pos_embed"])[0]
    elif num_patches is not None:
        # the reference keeps a plain tensor (no state-dict entry) equal to
        # the raw sinusoid when the grid matches the precomputed table
        p["pos_embed"] = torch.from_numpy(sinusoid_table_1d(num_patches, d))
    for i in range(depth):
        b = f"blocks.{i}"
        attn = {"qkv": {"kernel": _T(sd[f"{b}.attn.qkv.weight"])},
                "proj": _linear(sd, f"{b}.attn.proj")}
        if f"{b}.attn.q_bias" in sd:
            q_bias = as_tensor(sd[f"{b}.attn.q_bias"])
            attn["qkv"]["bias"] = torch.cat(
                [q_bias, torch.zeros_like(q_bias), as_tensor(sd[f"{b}.attn.v_bias"])])
        blk = {
            "norm1": _layernorm(sd, f"{b}.norm1"),
            "norm2": _layernorm(sd, f"{b}.norm2"),
            "attn": attn,
            "mlp": {"fc1": _linear(sd, f"{b}.mlp.fc1"), "fc2": _linear(sd, f"{b}.mlp.fc2")},
        }
        if f"{b}.gamma_1" in sd:
            blk["ls1"] = {"gamma": as_tensor(sd[f"{b}.gamma_1"])}
            blk["ls2"] = {"gamma": as_tensor(sd[f"{b}.gamma_2"])}
        p[f"blocks_{i}"] = blk
    p["norm"] = _layernorm(sd, "norm")
    return {"params": p}


def convert_internvideo2_stage2(sd: Mapping, *, depth: int, clip_return_layers: int,
                                text_layers: int) -> dict:
    """Full stage-2 checkpoint (vision_encoder.* masked pretrain tower,
    text_encoder.* HF-BERT fusion tower, vision_proj / text_proj / itm_head,
    the scalar temp) -> VideoCLIP params (JAX convert.py:205-237)."""
    vis_sd = {k[len("vision_encoder."):]: v for k, v in sd.items()
              if k.startswith("vision_encoder.")}
    txt_sd = {k[len("text_encoder."):]: v for k, v in sd.items()
              if k.startswith("text_encoder.")}
    p = {
        "vision_encoder": convert_internvideo2_pretrain(
            vis_sd, depth=depth, clip_return_layers=clip_return_layers,
            mae_return_layers=0)["params"],
        "text_encoder": convert_hf_bert(txt_sd, num_layers=text_layers, prefix="bert.")["params"],
        "vision_proj": _linear(sd, "vision_proj"),
        "text_proj": _linear(sd, "text_proj"),
        "itm_head": _linear(sd, "itm_head"),
        "temp": as_tensor(sd["temp"]),
    }
    return {"params": p}


def _linear_hf(g, key):
    out = {"kernel": _T(g(f"{key}.weight"))}
    try:
        out["bias"] = as_tensor(g(f"{key}.bias"))
    except KeyError:
        pass
    return out


def convert_hf_bert(sd: Mapping, *, num_layers: int, prefix: str = "bert.") -> dict:
    """HF bert-base-style state_dict (with the fusion layers'
    `crossattention`; the MLM head under `cls.predictions.*`) -> BertModel
    params (JAX convert.py:431-516)."""
    def g(key):
        for cand in (prefix + key, key):
            if cand in sd:
                return sd[cand]
        raise KeyError(prefix + key)

    def has(key):
        return (prefix + key) in sd or key in sd

    def norm(key):
        return {"scale": as_tensor(g(f"{key}.weight")), "bias": as_tensor(g(f"{key}.bias"))}

    p: dict = {
        "word_embeddings": {"embedding": as_tensor(g("embeddings.word_embeddings.weight"))},
        "position_embeddings": {
            "embedding": as_tensor(g("embeddings.position_embeddings.weight"))},
        "token_type_embeddings": {
            "embedding": as_tensor(g("embeddings.token_type_embeddings.weight"))},
        "embeddings_norm": norm("embeddings.LayerNorm"),
    }
    for i in range(num_layers):
        b = f"encoder.layer.{i}"
        layer = {
            "attention": {
                "query": _linear_hf(g, f"{b}.attention.self.query"),
                "key": _linear_hf(g, f"{b}.attention.self.key"),
                "value": _linear_hf(g, f"{b}.attention.self.value"),
                "proj": _linear_hf(g, f"{b}.attention.output.dense"),
            },
            "attention_norm": norm(f"{b}.attention.output.LayerNorm"),
            "intermediate": _linear_hf(g, f"{b}.intermediate.dense"),
            "output": _linear_hf(g, f"{b}.output.dense"),
            "output_norm": norm(f"{b}.output.LayerNorm"),
        }
        if has(f"{b}.crossattention.self.query.weight"):
            layer["crossattention"] = {
                "query": _linear_hf(g, f"{b}.crossattention.self.query"),
                "key": _linear_hf(g, f"{b}.crossattention.self.key"),
                "value": _linear_hf(g, f"{b}.crossattention.self.value"),
                "proj": _linear_hf(g, f"{b}.crossattention.output.dense"),
            }
            layer["crossattention_norm"] = norm(f"{b}.crossattention.output.LayerNorm")
        p[f"layer_{i}"] = layer
    if "cls.predictions.transform.dense.weight" in sd:
        p["mlm_transform"] = _linear_hf(lambda k: sd[k], "cls.predictions.transform.dense")
        p["mlm_norm"] = {"scale": as_tensor(sd["cls.predictions.transform.LayerNorm.weight"]),
                         "bias": as_tensor(sd["cls.predictions.transform.LayerNorm.bias"])}
        dec = {"kernel": _T(sd["cls.predictions.decoder.weight"])}
        if "cls.predictions.bias" in sd:
            dec["bias"] = as_tensor(sd["cls.predictions.bias"])
        elif "cls.predictions.decoder.bias" in sd:
            dec["bias"] = as_tensor(sd["cls.predictions.decoder.bias"])
        p["mlm_decoder"] = dec
    return {"params": p}


def export_bert_to_hf(params: Mapping, num_layers: int, prefix: str = "bert.") -> dict:
    """Inverse of `convert_hf_bert` (JAX convert.py:528-578)."""
    p = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}

    def put_linear(key, node):
        sd[key + ".weight"] = _T(node["kernel"])
        if "bias" in node:
            sd[key + ".bias"] = as_tensor(node["bias"])

    def put_norm(key, node):
        sd[key + ".weight"] = as_tensor(node["scale"])
        sd[key + ".bias"] = as_tensor(node["bias"])

    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"{prefix}embeddings.{name}.weight"] = as_tensor(p[name]["embedding"])
    put_norm(prefix + "embeddings.LayerNorm", p["embeddings_norm"])
    for i in range(num_layers):
        lp = p[f"layer_{i}"]
        b = f"{prefix}encoder.layer.{i}"
        for attn in ("attention", "crossattention"):
            if attn not in lp:
                continue
            for name in ("query", "key", "value"):
                put_linear(f"{b}.{attn}.self.{name}", lp[attn][name])
            put_linear(f"{b}.{attn}.output.dense", lp[attn]["proj"])
            put_norm(f"{b}.{attn}.output.LayerNorm", lp[f"{attn}_norm"])
        put_linear(f"{b}.intermediate.dense", lp["intermediate"])
        put_linear(f"{b}.output.dense", lp["output"])
        put_norm(f"{b}.output.LayerNorm", lp["output_norm"])
    return sd


def convert_internvideo2_pretrain(sd: Mapping, *, depth: int, clip_return_layers: int,
                                  mae_return_layers: int) -> dict:
    """Reference internvideo2_pretrain.py state_dict -> PretrainInternVideo2
    params (JAX convert.py:586-615)."""
    p: dict = {"encoder": convert_internvideo2_encoder(sd, depth=depth)["params"],
               "clip_pos_embed": as_tensor(sd["clip_pos_embed"])[0]}
    for j in range(clip_return_layers):
        p[f"clip_decoder_{j}"] = {"head": _linear(sd, f"clip_decoder.{j}.head"),
                                  "norm": _layernorm(sd, f"clip_decoder.{j}.norm")}
    if "final_clip_decoder.head.weight" in sd:
        p["final_clip_decoder"] = {"head": _linear(sd, "final_clip_decoder.head"),
                                   "norm": _layernorm(sd, "final_clip_decoder.norm")}
    if mae_return_layers:
        p["mae_pos_embed"] = as_tensor(sd["mae_pos_embed"])[0]
        for j in range(mae_return_layers):
            p[f"mae_decoder_{j}"] = {"head_0": _linear(sd, f"mae_decoder.{j}.head.0"),
                                     "head_2": _linear(sd, f"mae_decoder.{j}.head.2"),
                                     "norm": _layernorm(sd, f"mae_decoder.{j}.norm")}
    return {"params": p}


def convert_beats(sd: Mapping, num_layers: int = 12) -> dict:
    """BEATs state dict (backbones/beats/BEATs.py) -> BEATsEncoder params
    (JAX convert.py:623-672): the Conv2d patch embed OIHW -> HWIO, the
    weight-normed pos_conv folded into a plain kernel (the norm over (out,
    in) per tap, torch's dim=2 weight_norm), layer 0's relative-bias table,
    the GRU-gate parameters."""
    sd = {k: as_tensor(v) for k, v in sd.items()}
    p = {
        "patch_embedding": {"kernel": sd["patch_embedding.weight"].permute(2, 3, 1, 0)},
        "layer_norm": _layernorm(sd, "layer_norm"),
        "post_extract_proj": _linear(sd, "post_extract_proj"),
        "encoder_layer_norm": _layernorm(sd, "encoder.layer_norm"),
    }
    # weight_norm(dim=2): w[:, :, j] = g[0, 0, j] * v[:, :, j] / ||v[:, :, j]||,
    # in numpy as JAX computes it (a bf16 pair in fp32, rounded once)
    g, v = sd["encoder.pos_conv.0.weight_g"], sd["encoder.pos_conv.0.weight_v"]
    dtype = v.dtype
    g, v = ((g.float().numpy(), v.float().numpy()) if dtype == torch.bfloat16
            else (g.numpy(), v.numpy()))
    norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    w = g * v / np.maximum(norm, 1e-12)
    p["pos_conv"] = {
        # torch conv1d (Cout, Cin / g, k) -> flax (k, Cin / g, Cout)
        "kernel": torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0))).to(dtype),
        "bias": sd["encoder.pos_conv.0.bias"],
    }
    for i in range(num_layers):
        b = f"encoder.layers.{i}"
        attn = {name: _linear(sd, f"{b}.self_attn.{name}")
                for name in ("q_proj", "k_proj", "v_proj", "out_proj", "grep_linear")}
        attn["grep_a"] = sd[f"{b}.self_attn.grep_a"]
        if i == 0:
            attn["relative_attention_bias"] = sd[f"{b}.self_attn.relative_attention_bias.weight"]
        p[f"layers_{i}"] = {
            "self_attn": attn,
            "self_attn_layer_norm": _layernorm(sd, f"{b}.self_attn_layer_norm"),
            "fc1": _linear(sd, f"{b}.fc1"),
            "fc2": _linear(sd, f"{b}.fc2"),
            "final_layer_norm": _layernorm(sd, f"{b}.final_layer_norm"),
        }
    return {"params": p}


# --- LLMs: HF / xtuner MLA and stock HF GQA (JAX convert.py:802-1124) ------


def _strip_llm_prefix(sd: dict) -> dict:
    # model.language_model. is the Qwen3-VL-style composed-MLLM layout
    # (visual under model.visual., text under model.language_model.)
    for pref in ("language_model.model.", "model.language_model.", "model.", ""):
        if any(k.startswith(pref + "layers.0.") for k in sd):
            out = {k[len(pref):]: v for k, v in sd.items() if k.startswith(pref)}
            if "lm_head.weight" in sd:  # outside the model.* scope in HF layouts
                out["lm_head.weight"] = sd["lm_head.weight"]
            return out
    raise KeyError("no '<prefix>layers.0.' keys found in state dict")


def _mla_rope_input_permutation(p_dim: int) -> torch.Tensor:
    """Interleaved -> half-split rope rows: out[t] = raw[2 * (t % h) + t // h].
    The reference permutes pairs to halves inside its forward; the port's
    attention is half-split, so the bridge permutes the projection rows
    that produce rope dims instead."""
    half = p_dim // 2
    t = torch.arange(p_dim)
    return 2 * (t % half) + (t // half)


def _mla_permute_q_rows_with(w, num_heads: int, nope: int, rope: int, perm) -> torch.Tensor:
    w = as_tensor(w)
    qd = nope + rope
    w = w.reshape(num_heads, qd, *w.shape[1:]).clone()
    w[:, nope:] = w[:, nope:][:, perm]
    return w.reshape(num_heads * qd, *w.shape[2:])


def _mla_permute_q_rows(w, num_heads: int, nope: int, rope: int) -> torch.Tensor:
    """Permute each head's rope rows of a (H * (nope + rope), ...) q weight."""
    return _mla_permute_q_rows_with(w, num_heads, nope, rope, _mla_rope_input_permutation(rope))


def _mla_permute_kva_rows(w, kv_lora_rank: int, rope: int, perm=None) -> torch.Tensor:
    """Permute the trailing rope rows of kv_a_proj_with_mqa's weight (or
    bias) by `perm` (default: interleaved -> half-split)."""
    perm = _mla_rope_input_permutation(rope) if perm is None else perm
    w = as_tensor(w).clone()
    w[kv_lora_rank:] = w[kv_lora_rank:][perm]
    return w


def convert_xtuner_mla_attention(sd: Mapping, cfg, prefix: str = "") -> dict:
    """xtuner MLA module state dict -> MLAttention params, both variants
    (mla_raw.py with kv_a_layernorm, mla.py M2LA without; q-LoRA or full q),
    rope rows permuted to half-split (JAX convert.py:857-899)."""
    g = lambda k: as_tensor(sd[prefix + k])  # noqa: E731
    has = lambda k: (prefix + k) in sd  # noqa: E731
    heads, nope, rope = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim

    def lin(key, row_perm=None):
        w = g(f"{key}.weight")
        if row_perm is not None:
            w = row_perm(w)
        out = {"kernel": w.t().contiguous()}
        if has(f"{key}.bias"):
            b = g(f"{key}.bias")
            out["bias"] = row_perm(b) if row_perm is not None else b
        return out

    qperm = lambda w: _mla_permute_q_rows(w, heads, nope, rope)  # noqa: E731
    kperm = lambda w: _mla_permute_kva_rows(w, cfg.kv_lora_rank, rope)  # noqa: E731
    p = {
        "kv_a_proj_with_mqa": lin("kv_a_proj_with_mqa", kperm),
        "o_proj": lin("o_proj"),
        "kv_b_proj_kernel": _T(g("kv_b_proj.weight")).reshape(
            cfg.kv_lora_rank, heads, nope + cfg.v_head_dim),
    }
    if has("q_proj.weight"):
        p["q_proj"] = lin("q_proj", qperm)
    else:
        p["q_a_proj"] = lin("q_a_proj")
        p["q_a_layernorm"] = {"weight": g("q_a_layernorm.weight")}
        p["q_b_proj"] = lin("q_b_proj", qperm)
    if has("kv_a_layernorm.weight"):
        p["kv_a_layernorm"] = {"weight": g("kv_a_layernorm.weight")}
    return {"params": p}


def _swiglu(sd, b):
    return {name: _linear(sd, f"{b}.mlp.{name}") for name in ("gate_proj", "up_proj", "down_proj")}


def convert_hf_mla_llm(sd: Mapping, cfg) -> dict:
    """HF / xtuner MLA checkpoint (q_proj | q_a / q_b + q_a_layernorm,
    kv_a_proj_with_mqa, kv_b_proj, o_proj; SwiGLU gate / up / down, or the
    Qwen3-MoE expert layout) -> MLATransformer params (JAX
    convert.py:902-958). The first `moe_first_k_dense` layers of a MoE
    config read the SwiGLU names (JAX reads experts there and fails). No
    HF layout of expert biases or shared experts is known (JAX's converter
    has none either), so such a config raises instead of building a tree
    without those leaves."""
    _check_hf_moe(cfg)
    sd = _strip_llm_prefix({k: as_tensor(v) for k, v in sd.items()})
    p = {"embed_tokens": {"embedding": sd["embed_tokens.weight"]}, "norm": _rmsnorm(sd, "norm")}
    if not cfg.tie_word_embeddings:
        p["lm_head"] = {"kernel": _T(sd["lm_head.weight"])}
    for i in range(cfg.num_layers):
        b = f"layers.{i}"
        attn = convert_xtuner_mla_attention(sd, cfg.mla, prefix=f"{b}.self_attn.")["params"]
        if cfg.moe is not None and i >= cfg.moe_first_k_dense:
            # mlp.gate (router, (E, D)) + mlp.experts.{j}.{gate,up,down}_proj
            # -> stacked (E, D, I) / (E, I, D) grouped-GEMM weights
            experts = range(cfg.moe.num_experts)
            mlp = {"router": {"kernel": _T(sd[f"{b}.mlp.gate.weight"])}}
            for ours, hf in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                             ("w_down", "down_proj")):
                mlp[ours] = torch.stack([sd[f"{b}.mlp.experts.{j}.{hf}.weight"].t()
                                         for j in experts])
        else:
            mlp = _swiglu(sd, b)
        p[f"layers_{i}"] = {
            "input_layernorm": _rmsnorm(sd, f"{b}.input_layernorm"),
            "post_attention_layernorm": _rmsnorm(sd, f"{b}.post_attention_layernorm"),
            "self_attn": attn,
            "mlp": mlp,
        }
    return {"params": p}


def _check_hf_moe(cfg) -> None:
    moe = cfg.moe  # a MoEConfig, or any object with the fields the layout reads
    if moe is not None and (getattr(moe, "expert_bias", False)
                            or getattr(moe, "num_shared_experts", 0)):
        raise NotImplementedError(
            "the HF MLA layout here is Qwen3-MoE's (mlp.gate, mlp.experts.{j}.*); it has no "
            "names for expert biases (expert_bias) or shared experts (num_shared_experts)")


def _export_llm_common(p: Mapping) -> tuple[dict, callable]:
    sd = {"model.embed_tokens.weight": as_tensor(p["embed_tokens"]["embedding"]),
          "model.norm.weight": as_tensor(p["norm"]["weight"])}
    if "lm_head" in p:
        sd["lm_head.weight"] = _T(p["lm_head"]["kernel"])

    def put_linear(dst, node):
        sd[f"{dst}.weight"] = _T(node["kernel"])
        if "bias" in node:
            sd[f"{dst}.bias"] = as_tensor(node["bias"])

    return sd, put_linear


def export_mla_llm_hf(params: Mapping, cfg) -> dict:
    """MLATransformer params -> HF-layout state dict, the inverse of
    `convert_hf_mla_llm` (JAX convert.py:961-1043)."""
    _check_hf_moe(cfg)
    p = params.get("params", params)
    sd, put_linear = _export_llm_common(p)
    mla = cfg.mla
    inv = torch.argsort(_mla_rope_input_permutation(mla.qk_rope_head_dim))

    def put_rows(dst, node, row_perm):
        sd[f"{dst}.weight"] = row_perm(_T(node["kernel"])).contiguous()
        if "bias" in node:
            sd[f"{dst}.bias"] = row_perm(as_tensor(node["bias"])).contiguous()

    q_inv = lambda w: _mla_permute_q_rows_with(  # noqa: E731
        w, mla.num_heads, mla.qk_nope_head_dim, mla.qk_rope_head_dim, inv)
    kva_inv = lambda w: _mla_permute_kva_rows(  # noqa: E731
        w, mla.kv_lora_rank, mla.qk_rope_head_dim, inv)
    for i in range(cfg.num_layers):
        lp = p[f"layers_{i}"]
        b = f"model.layers.{i}"
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{b}.{norm}.weight"] = as_tensor(lp[norm]["weight"])
        attn = lp["self_attn"]
        put_rows(f"{b}.self_attn.kv_a_proj_with_mqa", attn["kv_a_proj_with_mqa"], kva_inv)
        put_linear(f"{b}.self_attn.o_proj", attn["o_proj"])
        kvb = as_tensor(attn["kv_b_proj_kernel"]).reshape(
            mla.kv_lora_rank, mla.num_heads * (mla.qk_nope_head_dim + mla.v_head_dim))
        sd[f"{b}.self_attn.kv_b_proj.weight"] = _T(kvb)
        if "kv_a_layernorm" in attn:
            sd[f"{b}.self_attn.kv_a_layernorm.weight"] = as_tensor(
                attn["kv_a_layernorm"]["weight"])
        if "q_proj" in attn:
            put_rows(f"{b}.self_attn.q_proj", attn["q_proj"], q_inv)
        else:
            put_linear(f"{b}.self_attn.q_a_proj", attn["q_a_proj"])
            sd[f"{b}.self_attn.q_a_layernorm.weight"] = as_tensor(attn["q_a_layernorm"]["weight"])
            put_rows(f"{b}.self_attn.q_b_proj", attn["q_b_proj"], q_inv)
        if cfg.moe is not None and i >= cfg.moe_first_k_dense:
            sd[f"{b}.mlp.gate.weight"] = _T(lp["mlp"]["router"]["kernel"])
            for j in range(cfg.moe.num_experts):
                for hf, ours in (("gate_proj", "w_gate"), ("up_proj", "w_up"),
                                 ("down_proj", "w_down")):
                    sd[f"{b}.mlp.experts.{j}.{hf}.weight"] = _T(as_tensor(lp["mlp"][ours])[j])
        else:
            for name in ("gate_proj", "up_proj", "down_proj"):
                put_linear(f"{b}.mlp.{name}", lp["mlp"][name])
    return sd


def convert_hf_gqa_llm(sd: Mapping, cfg) -> dict:
    """Stock HF GQA checkpoint (Qwen3 / LLaMA naming) -> GQATransformer
    params (JAX convert.py:1046-1080)."""
    sd = _strip_llm_prefix({k: as_tensor(v) for k, v in sd.items()})
    p = {"embed_tokens": {"embedding": sd["embed_tokens.weight"]}, "norm": _rmsnorm(sd, "norm")}
    if not cfg.tie_word_embeddings:
        p["lm_head"] = {"kernel": _T(sd["lm_head.weight"])}
    for i in range(cfg.num_layers):
        b = f"layers.{i}"
        a = f"{b}.self_attn"
        attn = {name: _linear(sd, f"{a}.{name}") for name in ("q_proj", "k_proj", "v_proj",
                                                               "o_proj")}
        if f"{a}.q_norm.weight" in sd:  # Qwen3's per-head qk-norm
            attn["q_norm"] = _rmsnorm(sd, f"{a}.q_norm")
            attn["k_norm"] = _rmsnorm(sd, f"{a}.k_norm")
        p[f"layers_{i}"] = {
            "input_layernorm": _rmsnorm(sd, f"{b}.input_layernorm"),
            "post_attention_layernorm": _rmsnorm(sd, f"{b}.post_attention_layernorm"),
            "self_attn": attn,
            "mlp": _swiglu(sd, b),
        }
    return {"params": p}


def export_gqa_llm_hf(params: Mapping, cfg) -> dict:
    """GQATransformer params -> HF-layout state dict, the inverse of
    `convert_hf_gqa_llm` (JAX convert.py:1083-1121)."""
    p = params.get("params", params)
    sd, put_linear = _export_llm_common(p)
    for i in range(cfg.num_layers):
        lp = p[f"layers_{i}"]
        b = f"model.layers.{i}"
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{b}.{norm}.weight"] = as_tensor(lp[norm]["weight"])
        attn = lp["self_attn"]
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            put_linear(f"{b}.self_attn.{name}", attn[name])
        for name in ("q_norm", "k_norm"):
            if name in attn:
                sd[f"{b}.self_attn.{name}.weight"] = as_tensor(attn[name]["weight"])
        for name in ("gate_proj", "up_proj", "down_proj"):
            put_linear(f"{b}.mlp.{name}", lp["mlp"][name])
    return sd


# --- InternVideo3: vision tower + projector + LLM (JAX convert.py:1209-1312)


class sd_prefixed(dict):
    """Read-through view adding a key prefix (keeps the _linear /
    _layernorm helpers usable on prefixed reference state dicts)."""

    def __init__(self, sd, prefix):
        super().__init__()
        self._sd, self._prefix = sd, prefix

    def __getitem__(self, k):
        return as_tensor(self._sd[self._prefix + k])

    def __contains__(self, k):
        return (self._prefix + k) in self._sd


def convert_internvideo3_vision(sd: Mapping, cfg, prefix: str = "") -> dict:
    """xtuner InternVideo3VisionModel state dict -> VisionTower params; the
    Conv3d kernel (D, C, tp, p, p) becomes the patchify kernel with inputs
    in (tp, p, p, C) order."""
    sdp = sd_prefixed(sd, prefix)
    p: dict = {
        "patch_embed": {"kernel": _patchify_kernel(sdp["patch_embed.proj.weight"]),
                        "bias": sdp["patch_embed.proj.bias"]},
        "pos_embed": sdp["pos_embed.weight"],
    }
    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        p[f"blocks_{i}"] = {
            "norm1": _layernorm(sdp, f"{b}.norm1"),
            "norm2": _layernorm(sdp, f"{b}.norm2"),
            "qkv": _linear(sdp, f"{b}.attn.qkv"),
            "proj": _linear(sdp, f"{b}.attn.proj"),
            "fc1": _linear(sdp, f"{b}.mlp.linear_fc1"),
            "fc2": _linear(sdp, f"{b}.mlp.linear_fc2"),
        }
    return {"params": p}


def _patch_merger(sdp, prefix: str) -> dict:
    return {"norm": _layernorm(sdp, f"{prefix}.norm"),
            "linear_fc1": _linear(sdp, f"{prefix}.linear_fc1"),
            "linear_fc2": _linear(sdp, f"{prefix}.linear_fc2")}


def convert_internvideo3_projector(sd: Mapping, num_deepstack: int, prefix: str = "") -> dict:
    """InternVideo3Projector (merger + deepstack_merger_list) -> {merger,
    deepstack_merger_i} subtrees."""
    sdp = sd_prefixed(sd, prefix)
    out = {"merger": _patch_merger(sdp, "merger")}
    for i in range(num_deepstack):
        out[f"deepstack_merger_{i}"] = _patch_merger(sdp, f"deepstack_merger_list.{i}")
    return out


def convert_internvideo3(sd: Mapping, cfg) -> dict:
    """Full InternVideo3ForConditionalGeneration HF checkpoint -> VideoMLLM
    params: the tower and projector under `model.visual.` (or `visual.`),
    the text model under `model.language_model.` (or `model.`); the text
    config's flavor picks the MLA or the GQA converter."""
    sd = {k: as_tensor(v) for k, v in sd.items()}
    vis_prefix = next((c for c in ("model.visual.", "visual.")
                       if any(k.startswith(c + "blocks.0.") for k in sd)), None)
    if vis_prefix is None:
        raise KeyError("no '<prefix>visual.blocks.0.' keys found")
    params = {
        "vision_tower": convert_internvideo3_vision(sd, cfg.vision, prefix=vis_prefix)["params"],
        **convert_internvideo3_projector(sd, len(cfg.vision.deepstack_indexes),
                                         prefix=vis_prefix),
    }
    lm_sd = {k: v for k, v in sd.items() if not k.startswith(vis_prefix)}
    lm = (convert_hf_gqa_llm if hasattr(cfg.text, "num_kv_heads") else convert_hf_mla_llm)(
        lm_sd, cfg.text)
    params["language_model"] = lm["params"]
    return {"params": params}


def convert_internvit(sd: Mapping, *, depth: int, prefix: str = "") -> dict:
    """InternViT vision checkpoint (HF `InternVLVisionModel` naming, which
    the reference's compose vision subclasses) -> InternVideo2 encoder
    params at T = 1 (JAX convert.py:675-747). Both norm flavors: InternVL's
    LayerNorm blocks (no QK-norm) and Intern-S1's RMSNorm + QK-norm. The
    separate q / k / v projections fold into the flat (D, 3D) qkv kernel;
    the xtuner subclass's `layer.{i}.` (no `encoder.`) is read too. A final
    `layernorm` (use_mean_pooling=False) raises: the compose has none."""
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    sd = {k: as_tensor(v) for k, v in sd.items()}
    if "layernorm.weight" in sd:
        raise NotImplementedError(
            "InternViT with a final layernorm (use_mean_pooling=False) is not supported by "
            "the compose path")
    w = sd["embeddings.patch_embeddings.projection.weight"]  # (D, 3, p, p)
    p: dict = {"patch_embed": {"proj": {"kernel": _patchify_kernel(w[:, :, None])}}}
    if "embeddings.patch_embeddings.projection.bias" in sd:
        p["patch_embed"]["proj"]["bias"] = sd["embeddings.patch_embeddings.projection.bias"]
    p["cls_token"] = sd["embeddings.cls_token"]
    if "embeddings.position_embeddings" in sd:
        p["pos_embed"] = sd["embeddings.position_embeddings"][0]
    for i in range(depth):
        b = f"encoder.layer.{i}"
        if f"{b}.attention.q_proj.weight" not in sd and \
                f"layer.{i}.attention.q_proj.weight" in sd:
            b = f"layer.{i}"  # the xtuner subclass flattens `encoder.`
        norm = _layernorm if f"{b}.layernorm_before.bias" in sd else _rmsnorm
        a = f"{b}.attention"
        attn = {"qkv": {"kernel": torch.cat([_T(sd[f"{a}.{n}_proj.weight"])
                                             for n in "qkv"], dim=1)},
                "proj": _linear(sd, f"{a}.projection_layer")}
        if f"{a}.q_proj.bias" in sd:
            attn["qkv"]["bias"] = torch.cat([sd[f"{a}.{n}_proj.bias"] for n in "qkv"])
        if f"{a}.q_norm.weight" in sd:
            attn["q_norm"] = _rmsnorm(sd, f"{a}.q_norm")
            attn["k_norm"] = _rmsnorm(sd, f"{a}.k_norm")
        p[f"blocks_{i}"] = {
            "attn": attn,
            "norm1": norm(sd, f"{b}.layernorm_before"),
            "norm2": norm(sd, f"{b}.layernorm_after"),
            "ls1": {"gamma": sd[f"{b}.lambda_1"]},
            "ls2": {"gamma": sd[f"{b}.lambda_2"]},
            "mlp": {"fc1": _linear(sd, f"{b}.mlp.fc1"), "fc2": _linear(sd, f"{b}.mlp.fc2")},
        }
    return {"params": p}


def convert_internvl(sd: Mapping, cfg) -> dict:
    """Full InternVL / Intern-S1 compose checkpoint -> InternVLChat params
    (JAX convert.py:750-769): `model.vision_tower.*` through
    convert_internvit, `model.multi_modal_projector.*` (layer_norm +
    linear_1 / linear_2 -> mlp1_*), `model.language_model.*` through the
    MLA LLM bridge (MoE included) when the file holds it."""
    sd = {k: as_tensor(v) for k, v in sd.items()}
    pj = "model.multi_modal_projector."
    out = {
        "vision_tower": convert_internvit(sd, depth=cfg.vision.depth,
                                          prefix="model.vision_tower.")["params"],
        "mlp1_norm": _layernorm(sd, pj + "layer_norm"),
        "mlp1_fc1": _linear(sd, pj + "linear_1"),
        "mlp1_fc2": _linear(sd, pj + "linear_2"),
    }
    if any(k.startswith("model.language_model.") for k in sd):
        out["language_model"] = convert_hf_mla_llm(sd, cfg.text)["params"]
    return {"params": out}
