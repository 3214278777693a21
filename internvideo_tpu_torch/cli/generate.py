"""Generation CLI of the PyTorch port: prompt token ids -> generated tokens.

    python -m internvideo_tpu_torch.cli.generate --preset qwen3_8b_mla \
        --ids 1,2,3 --max-new-tokens 32 --paged --device cuda
    python -m internvideo_tpu_torch.cli.generate --preset qwen3_8b_dense \
        --ids 1,2,3 --max-new-tokens 32 --device cuda
    python -m internvideo_tpu_torch.cli.generate --preset qwen3_dense_tiny \
        --ids 1,2,3 --device cpu
    python -m internvideo_tpu_torch.cli.generate --preset qwen3_8b_mla \
        --checkpoint /hf/ckpt_dir --ids 1,2,3 --paged --device cuda
    python -m internvideo_tpu_torch.cli.generate --preset qwen3_moe_text \
        --ids 1,2,3 --paged --device cuda

Port of internvideo_tpu/cli/generate.py in token-id mode, for the M2LA
presets (qwen3_8b_mla, ...; the MoE ones qwen3_moe_text, gpt_oss_moe_text,
deepseek_v3) and the dense-GQA ones (qwen3_8b_dense; at test widths
qwen3_mla_tiny, qwen3_moe_tiny and qwen3_dense_tiny, for a CPU). Prints
{"tokens": [...]}. `--checkpoint` is an HF-layout `.safetensors` file or
directory (sharded with `model.safetensors.index.json`, or not); its
weights go through `convert_hf_mla_llm` or `convert_hf_gqa_llm` by the
preset's flavor and `params_from_jax` into the model (`load_checkpoint`).
With no checkpoint the weights are the seeded random init (`--seed`).
`--device` is explicit: `cuda` (the default) with no GPU is an error, not
a CPU run. The prefill runs causal flash attention (K5 on
the card; grouped-query heads for the GQA preset). `--paged` decodes over
latent page pools (K6 on the card): M2LA only, a GQA preset raises as in
JAX; the GQA decode attends on the plain route. The `--prompt` /
`--tokenizer` text mode (ROADMAP queue 1, item 11) is not ported yet: the
card's environment has no tokenizer package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def build_model(args, device: torch.device):
    """The preset's model, dispatched by config type, with seeded weights."""
    from internvideo_tpu_torch.models import presets
    from internvideo_tpu_torch.models.llm import MLATransformer
    from internvideo_tpu_torch.models.llm_gqa import GQATransformer

    if not hasattr(presets, args.preset):
        raise SystemExit(f"unknown preset {args.preset!r}; see models/presets.py")
    cfg = getattr(presets, args.preset)()
    gen = torch.Generator(device).manual_seed(args.seed)
    if hasattr(cfg, "mla"):  # a bare LLMConfig
        return MLATransformer(cfg, device=device, generator=gen)
    if hasattr(cfg, "num_kv_heads"):  # dense-GQA flavour
        return GQATransformer(cfg, device=device, generator=gen)
    raise SystemExit(f"preset {args.preset!r} is not a text-LLM config; generate serves "
                     "the LLM flavors")


def load_checkpoint(model, path: str) -> None:
    """HF-layout weights (a `.safetensors` file or an HF directory) into
    `model`: converted by `convert_hf_gqa_llm` for a dense-GQA config,
    `convert_hf_mla_llm` otherwise (JAX cli/generate.py:47-65), then
    loaded with strict=True."""
    from internvideo_tpu_torch.core.checkpoint import load_hf_checkpoint, read_safetensors
    from internvideo_tpu_torch.models.convert import (
        convert_hf_gqa_llm,
        convert_hf_mla_llm,
        params_from_jax,
    )

    sd = load_hf_checkpoint(path) if os.path.isdir(path) else read_safetensors(path)
    convert = convert_hf_gqa_llm if hasattr(model.cfg, "num_kv_heads") else convert_hf_mla_llm
    model.load_state_dict(params_from_jax(convert(sd, model.cfg), model.cfg), strict=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="qwen3_8b_mla")
    ap.add_argument("--checkpoint", default=None,
                    help="HF-layout .safetensors file or directory (converted on load); "
                         "omit for the seeded random init")
    ap.add_argument("--tokenizer", default=None, help="not ported yet")
    ap.add_argument("--prompt", default=None, help="not ported yet; use --ids")
    ap.add_argument("--ids", default=None, help="comma-separated prompt token ids")
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--eos-token-id", type=int, default=None)
    ap.add_argument("--paged", action="store_true",
                    help="page-pool decode (the paged decode kernel on the card)")
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)

    if args.prompt is not None or args.tokenizer is not None:
        raise SystemExit("--prompt / --tokenizer: the text mode needs a tokenizer package, "
                         "which is not ported (ROADMAP queue 1, item 11); pass --ids")
    if not args.ids:
        raise SystemExit("pass --ids")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    ids = torch.tensor([[int(t) for t in args.ids.split(",")]], dtype=torch.int64)

    from internvideo_tpu_torch.models.generation import generate

    model = build_model(args, device).eval()
    if args.checkpoint is not None:
        load_checkpoint(model, args.checkpoint)
    out = generate(
        model, ids.to(device),
        max_new_tokens=args.max_new_tokens, eos_token_id=args.eos_token_id,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        generator=torch.Generator(device).manual_seed(args.seed),
        paged=args.paged, page_size=args.page_size,
        cache_dtype=getattr(torch, model.cfg.dtype),
    )
    print(json.dumps({"tokens": out[0].tolist()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
