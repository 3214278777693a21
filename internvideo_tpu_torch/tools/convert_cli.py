"""Checkpoint conversion CLI of the PyTorch port: reference / HF
checkpoints -> the converted param tree as a flat .npz.

    # reference InternVideo2 encoder (.pth / .npz / .safetensors) -> npz
    python -m internvideo_tpu_torch.tools.convert_cli \
        --kind internvideo2_encoder --depth 40 --src 1B_ft.pth --dst enc.npz

    # stage-2 VideoCLIP full checkpoint
    python -m internvideo_tpu_torch.tools.convert_cli --kind internvideo2_stage2 \
        --depth 40 --clip-return-layers 6 --text-layers 24 \
        --src stage2.pth --dst stage2.npz

    # HF MLA LLM safetensors directory -> npz (a Qwen3-MoE layout with
    # --preset qwen3_moe_text, or qwen3_moe_tiny at test widths)
    python -m internvideo_tpu_torch.tools.convert_cli --kind hf_mla_llm \
        --preset qwen3_8b_mla --src /hf/ckpt_dir --dst llm.npz

Port of internvideo_tpu/tools/convert_cli.py: the same flags and kinds,
and the same file: a flat npz of the converted tree, '/'-joined paths
under the top-level `params`, so either package's file loads in the other.
numpy has no bf16 without ml_dtypes; a bf16 leaf is written as its bits
viewed as `V2`, the record numpy writes for an ml_dtypes bf16 array, and a
`V2` leaf reads back as bf16 (`load_flat_params`). `.pth` files load with
`torch.load(weights_only=True)` and stay torch tensors, so a bf16 `.pth`
converts as it is. The output feeds the train CLI's
`data.*_checkpoint=` teachers, the eval CLI's `checkpoint=` and
`models/convert.py:params_from_jax`.

    # InternViT (Intern-S1's 6B tower) and the full Intern-S1 compose
    python -m internvideo_tpu_torch.tools.convert_cli --kind internvit \
        --depth 45 --src vit.safetensors --dst vit.npz
    python -m internvideo_tpu_torch.tools.convert_cli --kind internvl \
        --preset intern_s1 --src /hf/intern_s1_dir --dst intern_s1.npz

Kinds whose model the port does not have yet (mobileclip_text,
beats_tokenizer, viclip) raise NotImplementedError (ROADMAP queue 1, item
10). `internvideo2_pretrain` takes its decoder counts from
`--clip-return-layers` and `--mae-return-layers` (JAX's CLI passes
neither, and its converter requires both). `internvl` reads the preset's
depths, as JAX's CLI does; given explicitly, `--depth` and
`--text-layers` cut the preset's vision and text depths (a checkpoint
written at a cut depth; JAX's CLI has no such cut).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Mapping

import numpy as np
import torch

_V2 = np.dtype("V2")


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """numpy leaf -> tensor; `V2` records are bf16 bits."""
    if a.dtype == _V2:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    from internvideo_tpu_torch.core.checkpoint import as_tensor

    return as_tensor(a)


def _to_numpy(t) -> np.ndarray:
    """tensor leaf -> numpy; bf16 as its bits viewed as `V2`."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_V2)
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        raise ValueError(f"an npz cannot tag {t.dtype}; convert fp8 leaves first")
    return t.numpy()


def load_npz(path: str) -> dict[str, torch.Tensor]:
    with np.load(path, allow_pickle=False) as z:
        return {k: _from_numpy(z[k]) for k in z.files}


def load_state_dict(path: str) -> dict:
    """torch .pth / .npz / .safetensors (file or HF directory) -> {name:
    tensor}."""
    from internvideo_tpu_torch.core.checkpoint import load_hf_checkpoint, read_safetensors

    if os.path.isdir(path):
        return load_hf_checkpoint(path)
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    if path.endswith(".npz"):
        return load_npz(path)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "module", "state_dict"):
        if isinstance(raw, dict) and key in raw and isinstance(raw[key], dict):
            raw = raw[key]
    return dict(raw)


def flatten_params(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """{"params": nested tree} -> {'a/b/c': numpy leaf} (bf16 as `V2`)."""
    out = {}
    node = tree.get("params", tree) if isinstance(tree, Mapping) and not prefix else tree
    for k, v in node.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten_params(v, path))
        else:
            out[path] = _to_numpy(v)
    return out


def load_flat_params(path: str) -> dict:
    """Inverse of the CLI's output: flat npz -> {"params": nested tree of
    tensors}."""
    tree: dict = {}
    for key, v in load_npz(path).items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return {"params": tree}


_LATER = ("mobileclip_text", "beats_tokenizer", "viclip")
_DEPTH, _TEXT_LAYERS = 40, 24  # --depth / --text-layers when not given


def convert(kind: str, sd: dict, args) -> dict:
    from internvideo_tpu_torch.models import convert as C
    from internvideo_tpu_torch.models import presets

    if kind in _LATER:
        raise NotImplementedError(f"--kind {kind}: its model is not ported yet "
                                  "(ROADMAP queue 1, item 10)")
    if kind == "internvl":
        cfg = getattr(presets, args.preset)()
        if args.depth is not None:
            cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision,
                                                                      depth=args.depth))
        if args.text_layers is not None:
            cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text,
                                                                    num_layers=args.text_layers))
        return C.convert_internvl(sd, cfg)
    if kind == "internvideo2_encoder":
        return C.convert_internvideo2_encoder(sd, depth=args.depth)
    if kind == "internvideo2_pretrain":
        return C.convert_internvideo2_pretrain(
            sd, depth=args.depth, clip_return_layers=args.clip_return_layers,
            mae_return_layers=args.mae_return_layers)
    if kind == "internvideo2_stage2":
        return C.convert_internvideo2_stage2(
            sd, depth=args.depth, clip_return_layers=args.clip_return_layers,
            text_layers=args.text_layers)
    if kind == "internvl_clip_teacher":
        return C.convert_internvl_clip_teacher(sd, depth=args.depth)
    if kind == "videomae_teacher":
        return C.convert_videomae_teacher(sd, depth=args.depth)
    if kind == "hf_bert":
        return C.convert_hf_bert(sd, num_layers=args.text_layers)
    if kind == "beats":
        return C.convert_beats(sd, num_layers=args.depth)
    if kind == "internvit":
        return C.convert_internvit(sd, depth=args.depth)
    if kind == "internvideo3":
        return C.convert_internvideo3(sd, getattr(presets, args.preset)())
    if kind == "hf_mla_llm":
        return C.convert_hf_mla_llm(sd, getattr(presets, args.preset)())
    if kind == "hf_gqa_llm":
        return C.convert_hf_gqa_llm(sd, getattr(presets, args.preset)())
    raise SystemExit(f"unknown --kind {kind!r}")


KINDS = (
    "internvideo2_encoder", "internvideo2_pretrain", "internvideo2_stage2",
    "internvl_clip_teacher", "videomae_teacher", "hf_bert",
    "mobileclip_text", "beats", "beats_tokenizer", "internvit",
    "internvideo3", "internvl", "viclip", "hf_mla_llm", "hf_gqa_llm",
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", required=True, choices=KINDS)
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True, help=".npz output path")
    ap.add_argument("--depth", type=int, default=None,
                    help=f"encoder depth (default {_DEPTH}); internvl: cuts the preset's vision "
                         "depth")
    ap.add_argument("--clip-return-layers", type=int, default=6)
    ap.add_argument("--mae-return-layers", type=int, default=0,
                    help="internvideo2_pretrain's MAE decoders")
    ap.add_argument("--text-layers", type=int, default=None,
                    help=f"text depth (default {_TEXT_LAYERS}); internvl: cuts the preset's text "
                         "depth")
    ap.add_argument("--preset", default="qwen3_8b_mla",
                    help="models/presets name (hf_mla_llm / hf_gqa_llm / internvideo3 / internvl "
                         "kinds)")
    args = ap.parse_args(argv)
    if args.kind != "internvl":
        args.depth = _DEPTH if args.depth is None else args.depth
        args.text_layers = _TEXT_LAYERS if args.text_layers is None else args.text_layers

    sd = load_state_dict(args.src)
    flat = flatten_params(convert(args.kind, sd, args))
    os.makedirs(os.path.dirname(args.dst) or ".", exist_ok=True)
    np.savez(args.dst, **flat)
    total = sum(v.size for v in flat.values())
    print(f"wrote {args.dst}: {len(flat)} tensors, {total/1e6:.1f}M params")
    return 0


if __name__ == "__main__":
    sys.exit(main())
