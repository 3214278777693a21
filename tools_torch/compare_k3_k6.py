#!/usr/bin/env python3
"""K3, the fused qkv + QK-RMSNorm + small-S attention (csrc/fused_qkv.cu:
its row-statistics pre-pass and attention kernel), and K6, the paged
absorbed-MLA decode (csrc/paged_decode.cu: its split and merge passes),
against another checkout's, on one card.

    python3 tools_torch/compare_k3_k6.py kernels --other DIR [--only k3|k6]
    python3 tools_torch/compare_k3_k6.py downstream [--root DIR]

`kernels` builds this checkout's kernel library and DIR's (each with its own
`ops/_build.py`, into its own `build/`, the two builds side by side) and runs
both through this checkout's wrappers. K3: at the UMT student's (32, 833,
16, 88) and the CLIP-6B teacher's (512, 257, 25, 128), bf16, the (B, S, 3W)
projection and (W,) fp32 weights, it checks whether the two outputs are
bit-identical (else their rel-L2, which must be <= 1e-2) and that this
checkout's are bit-identical across two calls, then times the op (pre-pass +
attention) of both in turns (other, this, this, other; CUDA events, 20
calls each) and once more each by CUDA graph replay, with this checkout's
split between its two launches (torch.profiler), the bound, K2 on the
pre-normed q / k (the forward body without the norm) and, as a yardstick the
port never calls, SDPA on the pre-normed q / k. K6: at the 8B decode's
(B 8, H 32, R 896, P 128, page 64, seq 2048-2112) and the 2B video decode's
(B 8, H 20, R 512, P 64, seq 1056), bf16, each checkout with its own split
rule (DIR's wrapper's: `split_len_for`), it checks both against the plain
version (rel-L2 <= 1e-2), their distance, and this checkout's determinism,
then times both in turns and by graph replay (the device's time: the
wrapper's host work hides the kernel under CUDA events),
with GB/s of pool and this checkout's split / merge times (torch.profiler).
The C entries' signatures must be the same in both.

`downstream` times, with DIR's package (default: this checkout), the UMT
pretrain step (phase 14) on a device-resident batch, and the paged decode
step at B 8 of qwen3_8b_mla (36 layers, seq 2048) and of qwen3_2b_mla (the
internvideo25_hico_2b text model, 24 layers, seq 1056: the video decode
step): wall ms by CUDA events, then one step under torch.profiler (device
busy ms, idle share, K6's device ms and launches). Run it once per checkout,
each in its own process, in turns.

Each prints the card's name and power limit, then one JSON line. Needs one
CUDA card; nothing here imports JAX.
"""

import argparse
import contextlib
import gc
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
from compare_fwd_k1k2 import _in_turns  # noqa: E402
from compare_k4a import _chip_smoke  # noqa: E402
from compare_k5_fwd import _card, _load_build  # noqa: E402

K3_SHAPES = [("pretrain_student", (32, 833, 16, 88)), ("clip_teacher", (512, 257, 25, 128))]
# (tag, (B, H, R, P, page size), lengths)
K6_SHAPES = [("qwen3_8b_mla", (8, 32, 896, 128, 64), [2048, 2060, 2075, 2080, 2090, 2100, 2111,
                                                       2112]),
             ("hico_2b_video", (8, 20, 512, 64, 64), [1056] * 8)]


def _split_ms(call, keys, n: int = 10) -> dict:
    """Device ms per call of the launches whose names hold each of `keys`
    (torch.profiler over `n` calls)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    res = dict.fromkeys(keys, 0.0)
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for key in keys:
            if key in evt.key:
                res[key] += evt.self_device_time_total / 1e3 / n
    return res


def _k3(cs, fa, using, card, g) -> dict:
    from internvideo_tpu_torch.ops.rmsnorm import rms_norm

    res = {}
    for tag, (b, s, h, d) in K3_SHAPES:
        w = h * d
        qkv = (torch.randn(b, s, 3 * w, device="cuda", generator=g) * 2).bfloat16()
        qw, kw = (torch.randn(w, device="cuda", generator=g) * 0.1 + 1 for _ in range(2))
        scale = d ** -0.5

        def call():
            return fa._fused_qkv_cuda(qkv, qw, kw, h, scale, 1e-6)

        with torch.no_grad():
            outs = {}
            for t in ("other", "this", "this_again"):
                with using(t.split("_")[0]):
                    outs[t] = call()
            ref = fa.fused_qkv_ref(qkv, qw, kw, h, scale)
            torch.cuda.synchronize()
            r = {"shape_b_s_h_d": [b, s, h, d],
                 "bit_identical_between": bool(torch.equal(outs["this"], outs["other"])),
                 "rel_l2_between": cs._rel(outs["this"], outs["other"]),
                 "deterministic": bool(torch.equal(outs["this"], outs["this_again"])),
                 "rel_l2_to_plain": cs._rel(outs["this"], ref),
                 "other_rel_l2_to_plain": cs._rel(outs["other"], ref)}
            if not r["rel_l2_between"] <= 1e-2:
                raise AssertionError(f"K3 {tag}: the two kernels disagree {r['rel_l2_between']}")
            if not r["deterministic"]:
                raise AssertionError(f"K3 {tag}: this checkout's kernel is not deterministic")
            del outs, ref
            flops = 4 * b * h * s * s * d
            _in_turns(cs, using, call, r, flops)
            r["bound_ms"], r["bound_by"] = cs._bound(flops, 3 * b * s * w * 2 + b * s * w * 2
                                                     + 2 * w * 4)
            for t in ("other", "this"):
                with using(t):
                    split = _split_ms(call, ("fused_qkv_rstd", "fused_qkv_fwd"))
                r[f"{t}_prepass_ms"], r[f"{t}_attention_ms"] = (split["fused_qkv_rstd"],
                                                                split["fused_qkv_fwd"])
            qn = rms_norm(qkv[..., :w], qw).unflatten(-1, (h, d))
            kn = rms_norm(qkv[..., w:2 * w], kw).unflatten(-1, (h, d))
            v = qkv[..., 2 * w:].unflatten(-1, (h, d))
            r["k2_on_normed_ms"] = cs._time_ms(
                lambda: fa._flash_fwd_cuda(qn, kn, v, scale, kernel="small_s_fwd"), iters=20,
                warmup=3)
            r["sdpa_on_normed_ms"] = cs._sdpa_fwd_ms(qn, kn, v)
            del qn, kn, v
        res[tag] = r
        print(f"[{card}] K3 {tag} {(b, s, h, d)}: this {r['this_ms']} ms (graph "
              f"{r['this_graph_ms']:.4f}; pre-pass {r['this_prepass_ms']:.4f} + attention "
              f"{r['this_attention_ms']:.4f}), other {r['other_ms']} (graph "
              f"{r['other_graph_ms']:.4f}; {r['other_prepass_ms']:.4f} + "
              f"{r['other_attention_ms']:.4f}), x{r['speedup']:.2f}; K2 on normed q / k "
              f"{r['k2_on_normed_ms']:.4f}, SDPA on normed {r['sdpa_on_normed_ms']:.4f}; bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}); bit-identical "
              f"{r['bit_identical_between']} (rel-L2 {r['rel_l2_between']:.3e}; to plain "
              f"{r['rel_l2_to_plain']:.3e} / {r['other_rel_l2_to_plain']:.3e})", flush=True)
        del qkv
        torch.cuda.empty_cache()
    return res


def _k6(cs, pd, using, card) -> dict:
    res = {}
    for tag, (b, h, r_dim, p_dim, ps), lens in K6_SHAPES:
        mp = -(-max(lens) // ps) + 1
        q_lat, q_pe, pages, tables, sl = cs._paged_inputs(b, h, r_dim, p_dim, ps, mp, lens,
                                                          torch.bfloat16, 15)
        pages = torch.nan_to_num(pages)
        scale = (r_dim // 7 + p_dim) ** -0.5

        def call():
            return pd._paged_decode_cuda(q_lat, q_pe, pages, tables, sl, scale)

        with torch.no_grad():
            outs = {}
            for t in ("other", "this", "this_again"):
                with using(t.split("_")[0]):
                    outs[t] = call()
            ref = pd.paged_mla_decode_ref(q_lat, q_pe, pages, tables, sl, softmax_scale=scale)
            torch.cuda.synchronize()
            r = {"shape_b_h_r_p_page": [b, h, r_dim, p_dim, ps], "seq": [min(lens), max(lens)],
                 "bit_identical_between": bool(torch.equal(outs["this"], outs["other"])),
                 "rel_l2_between": cs._rel(outs["this"], outs["other"]),
                 "deterministic": bool(torch.equal(outs["this"], outs["this_again"])),
                 "rel_l2_to_plain": cs._rel(outs["this"], ref),
                 "other_rel_l2_to_plain": cs._rel(outs["other"], ref)}
            if not max(r["rel_l2_to_plain"], r["other_rel_l2_to_plain"]) <= 1e-2:
                raise AssertionError(f"K6 {tag}: a kernel disagrees with the plain version {r}")
            if not r["deterministic"]:
                raise AssertionError(f"K6 {tag}: this checkout's kernel is not deterministic")
            del outs, ref
            pool = sum(lens) * (r_dim + p_dim) * 2
            _in_turns(cs, using, call, r, 0.0)
            for t in ("this", "other"):
                r[f"{t}_pool_gb_per_s_graph"] = pool / r[f"{t}_graph_ms"] / 1e6
            r["bound_ms"], r["bound_by"] = cs._bound(
                sum(lens) * h * 2 * (r_dim + p_dim + r_dim),
                pool + b * h * (2 * r_dim + p_dim) * 2 + tables.numel() * 4)
            with using("this"):
                split = _split_ms(call, ("paged_decode_mma", "paged_decode_merge"))
            r["this_split_pass_ms"], r["this_merge_ms"] = (split["paged_decode_mma"],
                                                           split["paged_decode_merge"])
        res[tag] = r
        print(f"[{card}] K6 {tag} (B {b}, H {h}, R {r_dim}, P {p_dim}, page {ps}, seq "
              f"{min(lens)}-{max(lens)}): this graph {r['this_graph_ms']:.4f} ms "
              f"({r['this_pool_gb_per_s_graph']:.0f} GB/s of pool; split pass "
              f"{r['this_split_pass_ms']:.4f} + merge {r['this_merge_ms']:.4f}), events "
              f"{r['this_ms']}; other graph {r['other_graph_ms']:.4f} "
              f"({r['other_pool_gb_per_s_graph']:.0f} GB/s), events {r['other_ms']}; graph "
              f"x{r['graph_speedup']:.2f}; bound {r['bound_ms']:.4f} ({r['bound_by']}); rel-L2 "
              f"to plain {r['rel_l2_to_plain']:.3e} / {r['other_rel_l2_to_plain']:.3e}, between "
              f"{r['rel_l2_between']:.3e}", flush=True)
        del q_lat, q_pe, pages, tables, sl
        torch.cuda.empty_cache()
    return res


def kernels(other: Path, only=None) -> dict:
    sys.path.insert(0, str(ROOT))
    cs = _chip_smoke()
    from internvideo_tpu_torch.ops import flash_attention as fa
    from internvideo_tpu_torch.ops import paged_decode as pd

    card = _card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    builds = {"this": _load_build(ROOT, "this_build"), "other": _load_build(other, "other_build")}
    with ThreadPoolExecutor(2) as ex:
        for tag, path in zip(builds, ex.map(lambda m: m.build(), builds.values())):
            print(f"{tag}: {path}", flush=True)
    this_split = pd._split_len

    def other_split(dtype, batch, heads, max_tokens, device):  # the other wrapper's rule
        return pd.split_len_for(batch, heads, max_tokens)

    @contextlib.contextmanager
    def using(tag):
        saved = fa._build, pd._build
        fa._build = pd._build = builds[tag]
        pd._split_len = this_split if tag == "this" else other_split
        try:
            yield
        finally:
            fa._build, pd._build = saved
            pd._split_len = this_split

    g = torch.Generator("cuda").manual_seed(15)
    res = {"card": card}
    if only in (None, "k3"):
        res["k3"] = _k3(cs, fa, using, card, g)
    if only in (None, "k6"):
        res["k6"] = _k6(cs, pd, using, card)
    return res


def _decode_step(cs, preset: str, seq: int, card) -> dict:
    """Wall ms of a paged decode step at B 8 over `seq` cached tokens (CUDA
    events), then one step under torch.profiler: device busy ms, the idle
    share, K6's device ms and launches."""
    from torch.profiler import ProfilerActivity, profile

    from internvideo_tpu_torch.models.llm import init_paged_cache

    model = cs._llm(preset)
    b = 8
    g = torch.Generator("cuda").manual_seed(15)
    pages, tables = init_paged_cache(model.cfg, b, seq + 64, 64, torch.bfloat16, "cuda")
    tok = torch.randint(1, cs.VOCAB, (b, 1), device="cuda", generator=g)
    lens = torch.full((b,), seq, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        step = lambda: model.decode_step_paged(tok, pages, tables, lens, 64)  # noqa: E731
        wall = cs._time_ms(step, iters=20, warmup=3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
    busy = k6 = 0.0
    k6_launches = 0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.self_device_time_total <= 0:
            continue
        busy += evt.self_device_time_total / 1e3
        if "paged_decode" in evt.key:
            k6 += evt.self_device_time_total / 1e3
            k6_launches += evt.count
    res = {"preset": preset, "batch": b, "seq": seq, "layers": model.cfg.num_layers,
           "wall_ms": wall, "tokens_per_s": b * 1e3 / wall, "profiled_wall_ms": prof_wall,
           "device_busy_ms": busy, "idle_share": max(0.0, 1 - busy / prof_wall),
           "paged_decode_device_ms": k6, "paged_decode_kernel_launches": k6_launches}
    print(f"[{card}] {preset} paged decode step B={b} seq {seq}: {wall:.2f} ms = "
          f"{b * 1e3 / wall:.1f} tokens/s; under the profiler wall {prof_wall:.1f} ms, device "
          f"busy {busy:.2f} ms (idle {res['idle_share']:.1%}), K6 {k6:.3f} ms in "
          f"{k6_launches} kernel launches", flush=True)
    del model, pages
    return res


def downstream(root: Path) -> dict:
    os.chdir(root)  # the configs are read relative to the checkout
    sys.path.insert(0, str(root))
    cs = _chip_smoke()
    from internvideo_tpu_torch.core.config import load_config
    from internvideo_tpu_torch.ops import _build
    from internvideo_tpu_torch.ops import flash_attention as fa

    card = _card()
    print(card, flush=True)
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"root": str(root), "card": card}
    res["pretrain"] = cs.time_pretrain_step(fa, load_config(cs.CONFIG_PRETRAIN), card)
    gc.collect()
    torch.cuda.empty_cache()
    res["decode_8b"] = _decode_step(cs, cs.PRESET_8B, cs.PREFILL_SHAPE[1], card)
    gc.collect()
    torch.cuda.empty_cache()
    res["decode_2b_video"] = _decode_step(cs, cs.PRESET_2B, cs.HICO_PROMPT, card)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    k = sub.add_parser("kernels")
    k.add_argument("--other", type=Path, required=True, help="the other checkout's root")
    k.add_argument("--only", choices=("k3", "k6"), help="one of the two kernels")
    d = sub.add_parser("downstream")
    d.add_argument("--root", type=Path, default=ROOT, help="the checkout to time")
    args = ap.parse_args()
    res = kernels(args.other.resolve(), args.only) if args.cmd == "kernels" else downstream(
        args.root.resolve())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
