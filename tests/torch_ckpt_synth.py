"""Synthetic reference-layout state dicts from a port model's weights, for
the checkpoint tests: the inverse of the reference converters' layout
changes, so that a seeded port model can be written as the reference (or
HF) checkpoint it would have been loaded from.

Port names equal the reference's except where the converters reshape:
the Conv3d patchify (D, C, kt, kh, kw), the leading broadcast dim of pos
embeds, the attention pool's `q_bias` Parameters, and stage 2's HF BERT
(`export_bert_to_hf` plus the MLM head under `cls.predictions.*`).
"""

import torch

from internvideo_tpu_torch.models.convert import export_bert_to_hf, params_to_jax


def encoder_reference_sd(sd: dict, cfg, prefix: str = "") -> dict:
    """Port-named encoder tensors under `prefix` (an InternVideo2 or a
    pretrain student's extras) -> the reference InternVideo2 layout."""
    out = {}
    for k, v in sd.items():
        if not k.startswith(prefix):
            continue
        k = k[len(prefix):]
        if k == "patch_embed.proj.weight":
            p, ts = cfg.patch_size, cfg.tubelet_size
            v = v.reshape(v.shape[0], ts, p, p, 3).permute(0, 4, 1, 2, 3).contiguous()
        elif k in ("pos_embed", "clip_pos_embed", "mae_pos_embed"):
            v = v[None]
        elif (k.startswith("clip_projector.cross_attn.") and k.endswith(".bias")
              and k.split(".")[2] in ("q", "k", "v")):
            k = f"clip_projector.cross_attn.{k.split('.')[2]}_bias"
        out[k] = v.detach().cpu().clone()
    return out


def stage2_reference_sd(model) -> dict:
    """A port VideoCLIP with the pretrain tower -> the reference stage-2
    layout (`convert_internvideo2_stage2`'s input)."""
    cfg = model.config
    sd = model.state_dict()
    vis = encoder_reference_sd(sd, cfg.vision, prefix="vision_encoder.encoder.")
    vis.update(encoder_reference_sd(
        {k: v for k, v in sd.items() if not k.startswith("vision_encoder.encoder.")},
        cfg.vision, prefix="vision_encoder."))
    out = {f"vision_encoder.{k}": v for k, v in vis.items()}
    text = params_to_jax(sd, model)["params"]["text_encoder"]
    hf = export_bert_to_hf(text, cfg.text.num_layers)
    hf["cls.predictions.transform.dense.weight"] = text["mlm_transform"]["kernel"].t()
    hf["cls.predictions.transform.dense.bias"] = text["mlm_transform"]["bias"]
    hf["cls.predictions.transform.LayerNorm.weight"] = text["mlm_norm"]["scale"]
    hf["cls.predictions.transform.LayerNorm.bias"] = text["mlm_norm"]["bias"]
    hf["cls.predictions.decoder.weight"] = text["mlm_decoder"]["kernel"].t()
    hf["cls.predictions.bias"] = text["mlm_decoder"]["bias"]
    out.update({f"text_encoder.{k}": v.contiguous() for k, v in hf.items()})
    for k in ("vision_proj.weight", "vision_proj.bias", "text_proj.weight", "text_proj.bias",
              "itm_head.weight", "itm_head.bias", "temp"):
        out[k] = sd[k].detach().cpu().clone()
    return out


def same_weights(a: torch.nn.Module, b: torch.nn.Module) -> bool:
    """Bit-equal state_dicts (same keys, dtypes and values)."""
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(
        sa[k].dtype == sb[k].dtype and torch.equal(sa[k].cpu(), sb[k].cpu()) for k in sa)
