#!/usr/bin/env python3
"""K5's backward (csrc/flash_bwd_causal_dq.cu, flash_bwd_causal_dkv.cu)
against another checkout's, on one card in one process.

    python3 tools_torch/compare_k5_bwd.py kernels --other DIR
    python3 tools_torch/compare_k5_bwd.py downstream [--root DIR]

`kernels` builds this checkout's kernel library and DIR's (each with its own
`ops/_build.py`, into its own `build/`), checks that the two give the same
dq / dk / dv (rel-L2 <= 1e-2: the sum order differs, so bit-identity is not
expected), then times `ivt_flash_bwd_causal_dq` and `ivt_flash_bwd_causal_dkv`
of both through this checkout's wrapper, in turns (other, this, this, other;
CUDA events, 20 launches each), at the path shapes: the RL update's GQA
(4, 1152, 32 / 8, 128) causal and with a window of 128, the SFT backward
(K8) at (1, 8192, 32, 256 / 128) with the stream's segments, and the same
shape unsegmented (the MLA backward). Beside them: TFLOP/s over the visible
pairs and, for GQA, PyTorch SDPA's enable_gqa backward on the same inputs
(a yardstick; the port never calls it). The C entries' signatures must be
the same in both.

`downstream` runs DIR's own `chip_smoke.py` timing of the SFT step (phase
23) and the RL iteration (phase 32) in this process (default: this
checkout). Run it once per checkout, each in its own process, in turns.

Each prints the card's name and power limit, then one JSON line. Needs one
CUDA card; nothing here imports JAX.
"""

import argparse
import contextlib
import gc
import json
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
from compare_k5_fwd import _card, _load_build  # noqa: E402


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

    g = torch.Generator("cuda").manual_seed(11)
    br, sr, hqr, hkvr, dr = cs.RL_SHAPE
    bs, ss, hs, ds, dvs = cs.SFT_ATTN_SHAPE
    shapes = [  # tag, (B, S, Hq, Hkv, d_qk, d_v), window, segments
        ("rl_gqa", (br, sr, hqr, hkvr, dr, dr), None, False),
        ("rl_gqa_window", (br, sr, hqr, hkvr, dr, dr), cs.GQA_WINDOW, False),
        ("sft_seg", (bs, ss, hs, hs, ds, dvs), None, True),
        ("mla_unsegmented", (bs, ss, hs, hs, ds, dvs), None, False),
    ]
    res = {}
    for tag, (b, s, hq, hkv, d, dv), window, seg in shapes:
        q = torch.randn(b, s, hq, d, device="cuda", generator=g).bfloat16()
        kv = torch.randn(b, s, hkv, d + dv, device="cuda", generator=g).bfloat16()
        k, v = kv[..., :d], kv[..., d:]  # strided views, as the models pass them
        do = torch.randn(b, s, hq, dv, device="cuda", generator=g).bfloat16()
        segs = (cs._stream_segments(s),) * 2 if seg else (None, None)
        scale = d ** -0.5
        pairs = (hq * cs._visible_pairs(segs[0]) if seg
                 else b * hq * cs._band_pairs(s, window))
        with torch.no_grad():
            out, lse = fa._flash_fwd_causal_cuda(q, k, v, scale, True, 0, *segs, window)
            delta = fa._bwd_delta(out, do)
            grads = {}
            for tag_ in ("other", "this"):
                with using(tag_):
                    grads[tag_] = fa._flash_bwd_causal_cuda(q, k, v, out, lse, do, scale, True, 0,
                                                            *segs, window=window)
            torch.cuda.synchronize()
            rel = [((a.float() - w.float()).norm() / w.float().norm()).item()
                   for a, w in zip(grads["this"], grads["other"])]
            if not max(rel) <= 1e-2:
                raise AssertionError(f"{tag}: the two backward kernels disagree (rel-L2 dq / dk "
                                     f"/ dv {rel})")
            buf = tuple(torch.empty_like(x) for x in (q, k, v))
            ptrs = fa._seg_ptrs(*segs)[1]
            times = {kind: {"other": [], "this": []} for kind in ("dq", "dkv")}
            for kind in ("dq", "dkv"):
                for tag_ in ("other", "this", "this", "other"):
                    with using(tag_):
                        times[kind][tag_].append(cs._time_ms(lambda: fa._launch_bwd_causal(
                            kind, q, k, v, do, lse, delta, ptrs, buf, scale, True, 0, window),
                            iters=20, warmup=3))
        row = {"shape": [b, s, hq, hkv, d, dv], "window": window, "segments": seg,
               "rel_l2_between": dict(zip(("dq", "dk", "dv"), rel))}
        for kind, flops in (("dq", 2 * (2 * d + dv)), ("dkv", 2 * (2 * d + 2 * dv))):
            mean = {t: sum(x) / len(x) for t, x in times[kind].items()}
            row[kind] = {"this_ms": times[kind]["this"], "other_ms": times[kind]["other"],
                         "speedup": mean["other"] / mean["this"],
                         "this_tflops": flops * pairs / mean["this"] / 1e9,
                         "other_tflops": flops * pairs / mean["other"] / 1e9}
        if hkv != hq:
            row["sdpa_bwd_ms"], row["sdpa_note"] = cs._sdpa_gqa_bwd_ms(q, k, v, do, window)
        res[tag] = row
        print(f"[{card}] K5 bwd {tag} {(b, s, hq, hkv, d, dv)} window {window} segments {seg}: "
              + "; ".join(f"{kind} this {row[kind]['this_ms']} ms, other {row[kind]['other_ms']} "
                          f"ms, x{row[kind]['speedup']:.2f}, {row[kind]['this_tflops']:.1f} "
                          f"TFLOP/s" for kind in ("dq", "dkv"))
              + f"; rel-L2 between {rel}"
              + (f"; SDPA backward {row['sdpa_bwd_ms']} ms ({row['sdpa_note']})"
                 if "sdpa_bwd_ms" in row else ""), flush=True)
        del q, kv, k, v, do, out, lse, delta, grads, buf
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
    for name, fn in (("sft", lambda: cs.time_sft_step(fa, card)),
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
