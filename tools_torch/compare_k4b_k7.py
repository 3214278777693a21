#!/usr/bin/env python3
"""K4b, the small-S attention backward (csrc/small_s_bwd.cu: dq and dk/dv),
and K7, the dynamic-int8 GEMM (csrc/int8_gemm.cu), against another
checkout's, on one card in one process.

    python3 tools_torch/compare_k4b_k7.py kernels --other DIR [--only k4b|k7]
    python3 tools_torch/compare_k4b_k7.py downstream [--root DIR]

`kernels` builds this checkout's kernel library and DIR's (each with its own
`ops/_build.py`, into its own `build/`, the two builds side by side). K4b: at
every shape a main path gives it (the UMT student's (32, 833, 16, 88), the
SFT tower's (8, 196, 16, 72)) and at head dims 64 and 128, bf16, q / k / v
views of one (B, S, 3 H d) projection, the LSE and delta from this
checkout's K2 forward, it checks that the two give the same dq / dk / dv
(rel-L2 <= 1e-2; it reports whether they are bit-identical) and that this
checkout's are bit-identical across two calls, then times
`ivt_small_s_bwd_dq` and `ivt_small_s_bwd_dkv` of both through this
checkout's wrapper in turns (other, this, this, other; CUDA events, 20
launches each) and once more each by replaying a CUDA graph of 20 wrapper
calls (the device's time alone), with TFLOP/s (6 and 8 B H S^2 d
operations); beside them PyTorch's flash SDPA backward, a yardstick the port
never calls. K7: at every (M, K, N) the int8 paths give it (chip_smoke's
INT8_SHAPES), bf16 x, it checks that the two give bit-identical f32 and
bf16 outputs and that this checkout's equal the plain version's, then times
both with bf16 output in turns, with TOPS (2 M K N) and this checkout's
split between its two launches (torch.profiler), the bound, and as
yardsticks bf16 `F.linear` and torch's quantize + `_int_mm` + rescale. The
C entries' signatures must be the same in both.

`downstream` times, with DIR's package (default: this checkout), the UMT
pretrain step (phase 14) and the SFT step (phase 23) on device-resident
batches, the qwen3_8b_mla paged prefill at B 8 x 2048 with quant="int8_mix"
and in bf16, and the InternVideo2-1B forward at 16 x 224, B 16, with
quant="int8" and in bf16. Run it once per checkout, each in its own
process, in turns.

Each prints the card's name and power limit, then one JSON line. Needs one
CUDA card; nothing here imports JAX.
"""

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
from compare_fwd_k1k2 import _in_turns  # noqa: E402
from compare_k4a import _chip_smoke  # noqa: E402
from compare_k5_fwd import _card, _load_build  # noqa: E402

# (tag, (B, S, H, d)): K4b's path shapes, then head dims 64 and 128 (no
# model path runs them in bf16 training; checked for the record).
K4B_SHAPES = [
    ("pretrain_student", (32, 833, 16, 88)),
    ("sft_tower", (8, 196, 16, 72)),
    ("d64", (8, 833, 16, 64)),
    ("d128", (8, 833, 16, 128)),
]


def _k4b(cs, fa, using, card, g) -> dict:
    res = {}
    for tag, (b, s, h, d) in K4B_SHAPES:
        _, (q, k, v) = cs._qkv_views(b, s, h, d, g)
        do = torch.randn(b, s, h, d, device="cuda", generator=g).bfloat16()
        scale = d ** -0.5
        with torch.no_grad():
            out, lse = fa._flash_fwd_cuda(q, k, v, scale, kernel="small_s_fwd")
            delta = fa._bwd_delta(out, do)
            bufs = {"dq": (torch.empty_like(q),), "dkv": (torch.empty_like(k), torch.empty_like(v))}

            def launch(kind, outs):
                fa._launch_bwd(f"small_s_bwd_{kind}", q, k, v, do, lse, delta, outs, scale)

            grads = {}
            for t in ("other", "this", "this_again"):
                with using(t.split("_")[0]):
                    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
                    launch("dq", (dq,))
                    launch("dkv", (dk, dv))
                    grads[t] = (dq, dk, dv)
            torch.cuda.synchronize()
            names = ("dq", "dk", "dv")
            r = {"shape_b_s_h_d": [b, s, h, d],
                 "rel_l2_between": {n: cs._rel(a, w) for n, a, w in
                                    zip(names, grads["this"], grads["other"])},
                 "bit_identical_between": {n: bool(torch.equal(a, w)) for n, a, w in
                                           zip(names, grads["this"], grads["other"])},
                 "deterministic": {n: bool(torch.equal(a, w)) for n, a, w in
                                   zip(names, grads["this"], grads["this_again"])}}
            if not max(r["rel_l2_between"].values()) <= 1e-2:
                raise AssertionError(f"K4b {tag}: the two kernels disagree {r['rel_l2_between']}")
            if not all(r["deterministic"].values()):
                raise AssertionError(f"K4b {tag}: this checkout's kernels are not deterministic")
            del grads
            io = 4 * b * s * h * d * 2 + 2 * b * h * s * 4  # q, k, v, dO; lse, delta
            for kind, n_ops, n_out in (("dq", 6, 1), ("dkv", 8, 2)):
                rk = {}
                _in_turns(cs, using, lambda: launch(kind, bufs[kind]), rk,
                          n_ops * b * h * s * s * d)
                rk["bound_ms"], rk["bound_by"] = cs._bound(n_ops * b * h * s * s * d,
                                                           io + n_out * b * s * h * d * 2)
                r[kind] = rk
            r["sdpa_bwd_ms"] = cs._sdpa_bwd_ms(q, k, v, do)
        res[tag] = r
        print(f"[{card}] K4b {tag} {(b, s, h, d)}: dq this {r['dq']['this_ms']} ms (graph "
              f"{r['dq']['this_graph_ms']:.4f}), other {r['dq']['other_ms']} (graph "
              f"{r['dq']['other_graph_ms']:.4f}), x{r['dq']['speedup']:.2f}; dk/dv this "
              f"{r['dkv']['this_ms']} (graph {r['dkv']['this_graph_ms']:.4f}), other "
              f"{r['dkv']['other_ms']} (graph {r['dkv']['other_graph_ms']:.4f}), "
              f"x{r['dkv']['speedup']:.2f}; SDPA backward {r['sdpa_bwd_ms']:.4f}; bounds "
              f"{r['dq']['bound_ms']:.4f} / {r['dkv']['bound_ms']:.4f}; bit-identical "
              f"{r['bit_identical_between']}", flush=True)
        del q, k, v, do, out, lse, delta, bufs
        torch.cuda.empty_cache()
    return res


def _k7_split(call, n: int = 5) -> tuple:
    """Device ms of one call's two launches, (row quantizer, GEMM), from
    torch.profiler over `n` calls."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    quant = gemm = 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and "int8_" in evt.key:
            if "quantize" in evt.key:
                quant += evt.self_device_time_total / 1e3 / n
            else:
                gemm += evt.self_device_time_total / 1e3 / n
    return quant, gemm


def _k7(cs, ig, using, card, g) -> dict:
    res = {}
    for path, shapes in cs.INT8_SHAPES.items():
        for m, k, n in shapes:
            x, w_q, w_s = cs._int8_inputs((m,), k, n, torch.bfloat16, g)
            r = {"path": path, "shape_m_k_n": [m, k, n]}
            with torch.no_grad():
                for out_dtype in (torch.float32, torch.bfloat16):
                    outs = {}
                    for t in ("other", "this"):
                        with using(t):
                            outs[t] = ig.int8_matmul_fused(x, w_q, w_s, out_dtype)
                    ref = ig.int8_matmul_reference(x, w_q, w_s, out_dtype)
                    torch.cuda.synchronize()
                    key = str(out_dtype)[6:]
                    r[f"bit_identical_between_{key}"] = bool(torch.equal(outs["this"],
                                                                         outs["other"]))
                    r[f"bit_identical_to_plain_{key}"] = bool(torch.equal(outs["this"], ref))
                    rel = cs._rel(outs["this"], outs["other"])
                    if not rel <= 1e-2:
                        raise AssertionError(f"K7 {(m, k, n)} {key}: the two disagree ({rel})")
                    del outs, ref
                ops = 2 * m * k * n
                _in_turns(cs, using, lambda: ig.int8_matmul_fused(x, w_q, w_s, torch.bfloat16),
                          r, ops)
                t_ops = ops / cs.PEAK_INT8_OPS
                t_bytes = (2 * m * k + k * n + 2 * m * n) / cs.PEAK_BYTES_PER_S
                r["bound_ms"] = max(t_ops, t_bytes) * 1e3
                r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
                with using("this"):
                    r["this_quantize_ms"], r["this_gemm_ms"] = _k7_split(
                        lambda: ig.int8_matmul_fused(x, w_q, w_s, torch.bfloat16))
                w_bf16 = (w_q.float() * w_s[:, None]).bfloat16()
                r["bf16_linear_ms"] = cs._time_ms(lambda: F.linear(x, w_bf16), iters=20, warmup=3)
                r["library_ms"] = cs._int_mm_ms(x, w_q, w_s)
            res[f"{path} {m}x{k}x{n}"] = r
            print(f"[{card}] K7 {path} {(m, k, n)}: this {r['this_ms']} ms "
                  f"({r['this_tflops']:.0f} TOPS; graph {r['this_graph_ms']:.4f}), other "
                  f"{r['other_ms']} ({r['other_tflops']:.0f}), x{r['speedup']:.2f}; this's "
                  f"quantizer / GEMM {r['this_quantize_ms']:.4f} / {r['this_gemm_ms']:.4f} "
                  f"(profiler); bound "
                  f"{r['bound_ms']:.4f} ({r['bound_by']}); bf16 F.linear "
                  f"{r['bf16_linear_ms']:.4f}; bit-identical between f32 / bf16 "
                  f"{r['bit_identical_between_float32']} / {r['bit_identical_between_bfloat16']},"
                  f" to plain {r['bit_identical_to_plain_float32']} / "
                  f"{r['bit_identical_to_plain_bfloat16']}", flush=True)
            del x, w_q, w_s, w_bf16
            torch.cuda.empty_cache()
    return res


def kernels(other: Path, only=None) -> dict:
    sys.path.insert(0, str(ROOT))
    cs = _chip_smoke()
    from internvideo_tpu_torch.ops import flash_attention as fa
    from internvideo_tpu_torch.ops import int8_gemm as ig

    card = _card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    builds = {"this": _load_build(ROOT, "this_build"), "other": _load_build(other, "other_build")}
    with ThreadPoolExecutor(2) as ex:
        for tag, path in zip(builds, ex.map(lambda m: m.build(), builds.values())):
            print(f"{tag}: {path}", flush=True)

    @contextlib.contextmanager
    def using(tag):
        saved = fa._build, ig._build
        fa._build = ig._build = builds[tag]
        try:
            yield
        finally:
            fa._build, ig._build = saved

    g = torch.Generator("cuda").manual_seed(14)
    res = {"card": card}
    if only in (None, "k4b"):
        res["k4b"] = _k4b(cs, fa, using, card, g)
    if only in (None, "k7"):
        res["k7"] = _k7(cs, ig, using, card, g)
    return res


def _prefill_ms(cs, model) -> float:
    """The paged prefill at B 8 x 2048 (phase 19 / 36's timing)."""
    from internvideo_tpu_torch.models.llm import init_paged_cache

    b, s = cs.PREFILL_SHAPE
    ids = torch.randint(1, cs.VOCAB, (b, s), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(37))
    pages, tables = init_paged_cache(model.cfg, b, s + 64, 64, torch.bfloat16, "cuda")
    with torch.no_grad():
        return cs._time_ms(lambda: model.prefill_paged(ids, pages, tables, 64), iters=3)


def downstream(root: Path) -> dict:
    os.chdir(root)  # the configs are read relative to the checkout
    sys.path.insert(0, str(root))
    cs = _chip_smoke()
    from internvideo_tpu_torch.core.config import load_config
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2
    from internvideo_tpu_torch.ops import _build
    from internvideo_tpu_torch.ops import flash_attention as fa
    from internvideo_tpu_torch.ops.quant import quantize_params_like

    card = _card()
    print(card, flush=True)
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"root": str(root), "card": card}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    res["pretrain"] = cs.time_pretrain_step(fa, load_config(cs.CONFIG_PRETRAIN), card)
    free()
    res["sft"] = cs.time_sft_step(fa, card)
    free()
    b, s = cs.PREFILL_SHAPE
    for quant in ("int8_mix", "bf16"):
        model = cs._int8_llm(quant)[0] if quant != "bf16" else cs._llm(cs.PRESET_8B)
        ms = _prefill_ms(cs, model)
        res[f"prefill_{quant}_ms"], res[f"prefill_{quant}_tokens_per_s"] = ms, b * s * 1e3 / ms
        print(f"[{card}] {cs.PRESET_8B} {quant} prefill_paged B={b} x {s}: {ms:.1f} ms = "
              f"{b * s * 1e3 / ms:.0f} tokens/s", flush=True)
        del model
        free()
    cfg = load_config(cs.CONFIG_1B).model
    video = torch.randn(cs.ENC_INT8_B, cfg.num_frames, cfg.img_size, cfg.img_size, 3,
                        device="cuda", generator=torch.Generator("cuda").manual_seed(36))
    dense = InternVideo2(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    model = InternVideo2(dataclasses.replace(cfg, quant="int8"), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))
    model.load_state_dict(quantize_params_like(model, dense.state_dict()), strict=True)
    for quant, m in (("int8", model.eval()), ("bf16", dense.eval())):
        with torch.no_grad():
            ms = cs._time_ms(lambda: m(video), iters=3)
        res[f"encoder_{quant}_ms"] = ms
        res[f"encoder_{quant}_clips_per_s"] = cs.ENC_INT8_B * 1e3 / ms
        print(f"[{card}] InternVideo2-1B quant={quant} fwd 16x224 B={cs.ENC_INT8_B}: {ms:.1f} ms "
              f"= {cs.ENC_INT8_B * 1e3 / ms:.2f} clips/s", flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    k = sub.add_parser("kernels")
    k.add_argument("--other", type=Path, required=True, help="the other checkout's root")
    k.add_argument("--only", choices=("k4b", "k7"), help="one of the two kernels")
    d = sub.add_parser("downstream")
    d.add_argument("--root", type=Path, default=ROOT, help="the checkout to time")
    args = ap.parse_args()
    res = kernels(args.other.resolve(), args.only) if args.cmd == "kernels" else downstream(
        args.root.resolve())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
