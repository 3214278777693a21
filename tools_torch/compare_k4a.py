#!/usr/bin/env python3
"""K4a, the encoder's flash backward (csrc/flash_bwd.cu: dq and dk/dv),
against another checkout's, on one card in one process.

    python3 tools_torch/compare_k4a.py kernels --other DIR
    python3 tools_torch/compare_k4a.py downstream [--root DIR]

`kernels` builds this checkout's kernel library and DIR's (each with its own
`ops/_build.py`, into its own `build/`). At the finetune's (32, 2049, 16,
88) bf16, with q / k / v as views of one (B, S, 3 * 1408) projection, it
first checks that the two give the same dq / dk / dv (rel-L2 <= 1e-2; it
reports whether they are bit-identical) and that this checkout's kernels
give bit-identical outputs across two calls, then times `ivt_flash_bwd_dq`
and `ivt_flash_bwd_dkv` of both through this checkout's wrapper, in turns
(other, this, this, other; CUDA events, 20 launches each), with TFLOP/s
(6 and 8 B H S^2 d operations). Beside them, in the same process: the
wrapper's `_bwd_delta` (rowsum(dO * O), which the kernels take as input)
and, as a yardstick the port never calls, PyTorch's flash SDPA backward on
the same shape (`chip_smoke._sdpa_times`; it computes its own delta). The C
entries' signatures must be the same in both.

`downstream` times phase 10's finetune train step (chip_smoke.py
`time_finetune_step`: InternVideo2-1B at 8 x 224, B 32, on a device-resident
batch) with DIR's package (default: this checkout). Run it once per
checkout, each in its own process, in turns.

Each prints the card's name and power limit, then one JSON line. Needs one
CUDA card; nothing here imports JAX.
"""

import argparse
import contextlib
import importlib.util
import json
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
from compare_k5_fwd import _card, _load_build  # noqa: E402


def _chip_smoke():
    """This checkout's chip_smoke.py, loaded by path (its package imports
    resolve through sys.path, so `downstream --root` times DIR's package)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_this", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernels(other: Path) -> dict:
    sys.path.insert(0, str(ROOT))
    cs = _chip_smoke()
    from internvideo_tpu_torch.ops import flash_attention as fa

    card = _card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
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

    b, s, h, d = cs.TRAIN_SHAPE
    g = torch.Generator("cuda").manual_seed(12)
    qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=g).bfloat16()
    q, k, v = (x.unflatten(-1, (h, d)) for x in qkv.split(h * d, dim=-1))  # strided views
    do = torch.randn(b, s, h, d, device="cuda", generator=g).bfloat16()
    scale = d ** -0.5
    res = {"shape": [b, s, h, d], "card": card}
    with torch.no_grad():
        out, lse = fa._flash_fwd_cuda(q, k, v, scale)
        delta = fa._bwd_delta(out, do)
        outs = {"dq": (torch.empty_like(q),), "dkv": (torch.empty_like(k), torch.empty_like(v))}

        def launch(kind, bufs):
            fa._launch_bwd(f"flash_bwd_{kind}", q, k, v, do, lse, delta, bufs, scale)

        grads = {}
        for tag in ("other", "this", "this_again"):
            with using(tag.split("_")[0]):
                dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
                launch("dq", (dq,))
                launch("dkv", (dk, dv))
                grads[tag] = (dq, dk, dv)
        torch.cuda.synchronize()
        names = ("dq", "dk", "dv")
        rel = {n: ((a.float() - w.float()).norm() / w.float().norm()).item()
               for n, a, w in zip(names, grads["this"], grads["other"])}
        same = {n: bool(torch.equal(a, w)) for n, a, w in zip(names, grads["this"],
                                                             grads["other"])}
        again = {n: bool(torch.equal(a, w)) for n, a, w in zip(names, grads["this"],
                                                              grads["this_again"])}
        print(f"[{card}] K4a {cs.TRAIN_SHAPE} strided qkv views: rel-L2 this vs other {rel}, "
              f"bit-identical to other {same}, across two calls {again}", flush=True)
        if not max(rel.values()) <= 1e-2:
            raise AssertionError(f"the two backward kernels disagree (rel-L2 {rel})")
        if not all(again.values()):
            raise AssertionError(f"this checkout's kernels are not deterministic: {again}")
        res.update(rel_l2_between=rel, bit_identical_between=same, deterministic=again)
        del grads
        times = {kind: {"other": [], "this": []} for kind in ("dq", "dkv")}
        for kind in ("dq", "dkv"):
            bufs = outs[kind]
            for tag in ("other", "this", "this", "other"):
                with using(tag):
                    times[kind][tag].append(cs._time_ms(lambda: launch(kind, bufs), iters=20,
                                                        warmup=3))
        for kind, n_ops in (("dq", 6), ("dkv", 8)):
            flops = n_ops * b * h * s * s * d
            mean = {t: sum(x) / len(x) for t, x in times[kind].items()}
            res[kind] = {"this_ms": times[kind]["this"], "other_ms": times[kind]["other"],
                         "speedup": mean["other"] / mean["this"],
                         "this_tflops": flops / mean["this"] / 1e9,
                         "other_tflops": flops / mean["other"] / 1e9}
            print(f"[{card}] K4a {kind} {cs.TRAIN_SHAPE}: this {times[kind]['this']} ms "
                  f"({res[kind]['this_tflops']:.1f} TFLOP/s), other {times[kind]['other']} ms "
                  f"({res[kind]['other_tflops']:.1f}), x{res[kind]['speedup']:.2f}", flush=True)
        res["bwd_delta_ms"] = cs._time_ms(lambda: fa._bwd_delta(out, do), iters=20, warmup=3)
        print(f"[{card}] _bwd_delta {cs.TRAIN_SHAPE}: {res['bwd_delta_ms']:.4f} ms", flush=True)
        del qkv, q, k, v, do, out, lse, delta, outs
    res["sdpa"] = cs._sdpa_times(cs.TRAIN_SHAPE, card)
    return res


def downstream(root: Path) -> dict:
    os.chdir(root)  # the configs are read relative to the checkout
    sys.path.insert(0, str(root))
    cs = _chip_smoke()
    from internvideo_tpu_torch.core.config import load_config
    from internvideo_tpu_torch.ops import _build

    card = _card()
    print(card, flush=True)
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    step_ms = cs.time_finetune_step(load_config(cs.CONFIG_TRAIN), card)
    return {"root": str(root), "card": card, "finetune_step_ms": step_ms,
            "clips_per_s": cs.TRAIN_SHAPE[0] * 1e3 / step_ms}


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
