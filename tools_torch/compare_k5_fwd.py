#!/usr/bin/env python3
"""K5's forward (csrc/flash_fwd_causal.cu) against another checkout's, on
one card in one process.

    python3 tools_torch/compare_k5_fwd.py kernels --other DIR
    python3 tools_torch/compare_k5_fwd.py downstream [--root DIR]

`kernels` builds this checkout's kernel library and DIR's (each with its own
`ops/_build.py`, into its own `build/`), and times `ivt_flash_fwd_causal`
of both through this checkout's wrapper at every shape a main path gives
K5, in turns (other, this, this, other; CUDA events, 20 launches each),
after checking that the two outputs agree (rel-L2 <= 1e-2). The C entry's
signature must be the same in both.

`downstream` runs DIR's own `chip_smoke.py` timing phases (default: this
checkout) in this process: the qwen3_8b_mla prefill at B 8 x 2048 (phase
19), the qwen3_8b_dense prefill (28), the SFT step (23) and the RL
iteration (32). Run it once per checkout, each in its own process, in turns.

Each prints the card's name and power limit, then one JSON line. Needs one
CUDA card; nothing here imports JAX.
"""

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit(f"{Path(sys.argv[0]).stem}: needs a CUDA card")
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _load_build(root: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        name, root / "internvideo_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernels(other: Path) -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from internvideo_tpu_torch.ops import flash_attention as fa

    card = _card()
    print(card, flush=True)
    builds = {"this": _load_build(ROOT, "this_build"), "other": _load_build(other, "other_build")}
    for tag, mod in builds.items():
        print(f"{tag}: {mod.build()}", flush=True)

    @contextlib.contextmanager
    def using(tag):
        saved, fa._build = fa._build, builds[tag]
        try:
            yield
        finally:
            fa._build = saved

    g = torch.Generator("cuda").manual_seed(10)
    b, s, h, d, dv = cs.CAUSAL_SHAPE
    b2, s2, h2, d2, dv2 = cs.CAUSAL_SHAPE_2B
    bg, sg, hq, hkv, dg = cs.GQA_SHAPE
    br, sr, hqr, hkvr, dr = cs.RL_SHAPE
    bs, ss, hs, ds, dvs = cs.SFT_ATTN_SHAPE
    bh, sh, hh, dh, dvh = cs.HICO_ATTN_SHAPE
    shapes = [  # tag, (B, S, Hq, Hkv, d_qk, d_v), window, segments
        ("qwen3_8b_mla", (b, s, h, h, d, dv), None, False),
        ("qwen3_2b_mla", (b2, s2, h2, h2, d2, dv2), None, False),
        ("qwen3_8b_dense_gqa", (bg, sg, hq, hkv, dg, dg), None, False),
        ("gqa_window", (bg, sg, hq, hkv, dg, dg), cs.GQA_WINDOW, False),
        ("sft_seg", (bs, ss, hs, hs, ds, dvs), None, True),
        ("hico_2b", (bh, sh, hh, hh, dh, dvh), None, False),
        ("rl_gqa", (br, sr, hqr, hkvr, dr, dr), None, False),
    ]
    res = {}
    for tag, (b_, s_, hq_, hkv_, d_, dv_), window, seg in shapes:
        q = torch.randn(b_, s_, hq_, d_, device="cuda", generator=g).bfloat16()
        kv = torch.randn(b_, s_, hkv_, d_ + dv_, device="cuda", generator=g).bfloat16()
        k, v = kv[..., :d_], kv[..., d_:]  # strided views, as the models pass them
        segs = (cs._stream_segments(s_), ) * 2 if seg else (None, None)
        scale = d_ ** -0.5

        def call():
            return fa._flash_fwd_causal_cuda(q, k, v, scale, True, 0, *segs, window)

        with torch.no_grad():
            outs = {}
            for tag_ in ("other", "this"):
                with using(tag_):
                    outs[tag_] = call()[0]
            torch.cuda.synchronize()
            rel = ((outs["this"].float() - outs["other"].float()).norm()
                   / outs["other"].float().norm()).item()
            if not rel <= 1e-2:
                raise AssertionError(f"{tag}: the two kernels disagree (rel-L2 {rel:.3e})")
            times = {"other": [], "this": []}
            for tag_ in ("other", "this", "this", "other"):
                with using(tag_):
                    times[tag_].append(cs._time_ms(call, iters=20, warmup=3))
        mean = {t: sum(v_) / len(v_) for t, v_ in times.items()}
        res[tag] = {"shape": [b_, s_, hq_, hkv_, d_, dv_], "window": window, "segments": seg,
                    "this_ms": times["this"], "other_ms": times["other"],
                    "speedup": mean["other"] / mean["this"], "rel_l2_between": rel}
        print(f"[{card}] K5 {tag} {(b_, s_, hq_, hkv_, d_, dv_)} window {window} segments {seg}: "
              f"this {times['this']} ms, other {times['other']} ms, x{res[tag]['speedup']:.2f}, "
              f"rel-L2 between {rel:.2e}", flush=True)
        del q, kv, k, v, outs
    return res


def downstream(root: Path) -> dict:
    os.chdir(root)  # chip_smoke reads its configs relative to the checkout
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from internvideo_tpu_torch.ops import _build
    from internvideo_tpu_torch.ops import flash_attention as fa

    card = _card()
    print(card, flush=True)
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"root": str(root)}
    llm = cs._llm(cs.PRESET_8B)
    res["qwen3_8b_mla"] = cs.time_llm(llm, cs.PRESET_8B, card)
    del llm
    for name, fn in (("qwen3_8b_dense", lambda: cs.time_gqa_llm(card)),
                     ("sft", lambda: cs.time_sft_step(fa, card)),
                     ("rl", lambda: cs.time_rl_iteration(card))):
        gc.collect()
        torch.cuda.empty_cache()
        res[name] = fn()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    k = sub.add_parser("kernels")
    k.add_argument("--other", type=Path, required=True, help="the other checkout's root")
    d = sub.add_parser("downstream")
    d.add_argument("--root", type=Path, default=ROOT, help="the checkout to time")
    args = ap.parse_args()
    res = kernels(args.other.resolve()) if args.cmd == "kernels" else downstream(
        args.root.resolve())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
