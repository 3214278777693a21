#!/usr/bin/env python3
"""chip_smoke.py's MoE phases alone, on one card.

    python3 tools_torch/run_moe_phases.py [--parent DIR] [--depth PRESET=N ...]
        [--only 74,75,76,77]

Builds the kernel library, prints the ptxas report of K5's (128, 64)
forward and of K6's bf16 kernel, then runs chip_smoke's phases 74-77 in
order: K5 at (128, 64) and K6 at 64 / 128 heads against their plain
versions, with their times; qwen3_moe_text at full depth through the
ServingEngine and generate (launch counts, rates, the one-slot engine
against B-1 generate on all 8 prompts, the 8-slot engine's agreement with
B-8 generate, the MoE profile)
and its depth-4 kernel / plain / fp32 routes; gpt_oss_moe_text at full
depth; deepseek_v3 at depth 4. `--depth PRESET=N` cuts a preset's depth
(a quicker check; chip_smoke runs the depths above). With `--parent DIR`
(another checkout, e.g. `git archive` of the parent commit) it first times
K6 at its earlier shapes, the 8B decode's (B 8, H 32, R 896, P 128) and the
2B video decode's (B 8, H 20, R 512, P 64), with this checkout's kernels
and DIR's, in turns (parent, this, this, parent; CUDA graph replay, median
of 5 each), the two outputs held to each other (rel-L2 <= 1e-2). Prints
each phase's wall seconds, then one JSON line; any failure raises. Needs
one CUDA card; nothing here imports JAX.
"""

import argparse
import contextlib
import gc
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from compare_k5_fwd import _load_build  # noqa: E402
from internvideo_tpu_torch.ops import _build  # noqa: E402
from internvideo_tpu_torch.ops import flash_attention as fa  # noqa: E402
from internvideo_tpu_torch.ops import paged_decode as pd  # noqa: E402


def k6_against_parent(parent_build, card) -> dict:
    """K6 at the 8B and 2B decode shapes with this checkout's library and
    the parent's (`parent_build`: its ops/_build.py module, built), in
    turns, through this checkout's wrapper (both take its split rule: at <=
    32 heads the two wrappers' rules agree)."""
    builds = {"this": _build, "parent": parent_build}

    @contextlib.contextmanager
    def using(tag):
        saved = pd._build
        pd._build = builds[tag]
        try:
            yield
        finally:
            pd._build = saved

    res = {}
    for tag, (b, h, r, p_dim, ps), lens in (("8b", cs.DECODE_SHAPE, cs.DECODE_LENS),
                                           ("2b", cs.DECODE_SHAPE_2B, [cs.HICO_PROMPT] * 8)):
        q_lat, q_pe, pages, tables, sl = cs._paged_inputs(b, h, r, p_dim, ps,
                                                          -(-max(lens) // ps) + 1, lens,
                                                          torch.bfloat16, 21)
        pages = torch.nan_to_num(pages)
        scale = (128 + p_dim) ** -0.5
        call = lambda: pd._paged_decode_cuda(q_lat, q_pe, pages, tables, sl, scale)  # noqa: E731
        outs, times = {}, {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            with using(who), torch.no_grad():
                outs.setdefault(who, call())
                times[who].append(cs._median_graph_ms(call))
        rel = cs._rel(outs["this"], outs["parent"])
        if not rel <= 1e-2:
            raise AssertionError(f"K6 {tag}: this checkout and the parent differ, rel-L2 {rel}")
        res[tag] = {"shape": [b, h, r, p_dim, ps, min(lens), max(lens)], "this_ms": times["this"],
                    "parent_ms": times["parent"], "rel_l2": rel,
                    "bit_identical": bool(torch.equal(outs["this"], outs["parent"]))}
        print(f"[{card}] K6 {tag} (B {b}, H {h}, R {r}, P {p_dim}): this {times['this']} ms, "
              f"parent {times['parent']} ms (graph replay, medians of 5; in turns), rel-L2 "
              f"{rel:.3e}, bit-identical {res[tag]['bit_identical']}", flush=True)
        del q_lat, q_pe, pages, tables, sl, outs
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--depth", action="append", default=[], help="PRESET=N")
    ap.add_argument("--only", default="74,75,76,77")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("run_moe_phases: needs a CUDA card")
    depth = {cs.PRESET_DEEPSEEK: cs.DEEPSEEK_DEPTH}
    depth.update({k: int(v) for k, v in (d.split("=") for d in args.depth)})
    only = set(args.only.split(","))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    parent = None if args.parent is None else _load_build(args.parent, "parent_build")
    with ThreadPoolExecutor(2) as ex:  # this checkout's build and the parent's side by side
        lib, _ = ex.map(lambda m: m and m.build(), (_build, parent))
    _build.load_library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    card = cs._card()
    print(card, flush=True)
    log = lib.with_suffix(".log").read_text()
    ptxas = {"K5 forward": cs._ptxas_k5(log), "K3 / K6": cs._ptxas_k3_k6(log)}
    for what, rep in ptxas.items():
        print(f"ptxas, {what}: " + "; ".join(
            f"{k} {v['registers']} registers, {v['spill_stores']} / {v['spill_loads']} bytes "
            "spilled" for k, v in rep.items()), flush=True)
    out = {"card": card, "ptxas": ptxas}

    def timed(label, fn, *a, **kw):
        t = time.perf_counter()
        r = fn(*a, **kw)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{label} {time.perf_counter() - t:.1f} s", flush=True)
        return r

    if parent is not None:
        out["k6_vs_parent"] = timed("K6 vs parent", k6_against_parent, parent, card)
    if "74" in only:
        out["phase_74"] = timed("phase 74", cs.check_moe_kernels, fa, pd, card)
    if "75" in only:
        out[cs.PRESET_MOE] = timed("phase 75 (serve)", cs.run_moe_path, fa, pd, card,
                                   cs.PRESET_MOE, depth.get(cs.PRESET_MOE), agreement=True,
                                   profile=True)
        out["routes_depth_4"] = timed("phase 75 (routes)", cs.check_moe_routes, cs.PRESET_MOE,
                                      cs.MOE_ROUTE_DEPTH, card)
    if "76" in only:
        out[cs.PRESET_GPT_OSS] = timed("phase 76", cs.run_moe_path, fa, pd, card,
                                       cs.PRESET_GPT_OSS, depth.get(cs.PRESET_GPT_OSS),
                                       agreement=True)
    if "77" in only:
        out[cs.PRESET_DEEPSEEK] = timed("phase 77", cs.run_moe_path, fa, pd, card,
                                        cs.PRESET_DEEPSEEK, depth.get(cs.PRESET_DEEPSEEK),
                                        agreement=True)
    print(f"MoE phases ok in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
