#!/usr/bin/env python3
"""K1 and K2, the encoders' attention forwards (csrc/flash_fwd.cu,
csrc/small_s_fwd.cu), against another checkout's, on one card in one
process.

    python3 tools_torch/compare_fwd_k1k2.py kernels --other DIR
    python3 tools_torch/compare_fwd_k1k2.py downstream [--root DIR]

`kernels` builds this checkout's kernel library and DIR's (each with its own
`ops/_build.py`, into its own `build/`, the two builds side by side). At
every shape a main path gives K1 or K2, bf16, with q / k / v as views of one
(B, S, 3 H d) projection, it first checks that the two outputs agree (rel-L2
<= 1e-2; it reports whether out and LSE are bit-identical) and that this
checkout's are bit-identical across two calls, then times `ivt_flash_fwd` /
`ivt_small_s_fwd` of both through this checkout's wrapper, in turns (other,
this, this, other; CUDA events, 20 launches each), and once more each by
replaying a CUDA graph of 20 wrapper calls (the device's time alone, which
at the short shapes the host's launch rate hides), with TFLOP/s (4 B H Sq
Sk d operations). Beside them, in the same process: PyTorch's flash SDPA
forward on the same inputs, a yardstick the port never calls. K5's forward
shares the body (csrc/flash_fwd_causal.cu), so its 8B prefill and
dense-GQA prefill shapes are checked and timed the same way. The C entries'
signatures must be the same in both.

`downstream` times, with DIR's package (default: this checkout), the
InternVideo2-1B forward at 16 x 224, B 16 (phase 6), the finetune train step
(phase 10, `time_finetune_step`) and the UMT pretrain step (phase 14,
`time_pretrain_step`), each on a device-resident batch. Run it once per
checkout, each in its own process, in turns.

Each prints the card's name and power limit, then one JSON line. Needs one
CUDA card; nothing here imports JAX.
"""

import argparse
import contextlib
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
from compare_k4a import _chip_smoke  # noqa: E402
from compare_k5_fwd import _card, _load_build  # noqa: E402

# (tag, kernel, (B, Sq, Sk, H, d)): the path shapes of K1 and K2.
SHAPES = [
    ("eval_1b", "flash_fwd", (16, 4097, 4097, 16, 88)),
    ("finetune", "flash_fwd", (32, 2049, 2049, 16, 88)),
    ("mae_teacher", "flash_fwd", (32, 4096, 4096, 16, 88)),
    ("retrieval_tower", "flash_fwd", (32, 1025, 1025, 16, 88)),
    ("rerank_cross_attention", "flash_fwd", (32, 32, 1025, 16, 64)),
    ("pretrain_student", "small_s_fwd", (32, 833, 833, 16, 88)),
    ("hico_tower", "small_s_fwd", (64, 196, 196, 16, 72)),
    ("sft_tower", "small_s_fwd", (8, 196, 196, 16, 72)),
]


def _graph_ms(cs, fn, n: int = 20) -> float:
    """Device ms of one `fn()` from replaying a CUDA graph of `n` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cs._time_ms(graph.replay, iters=5, warmup=1) / n


def _in_turns(cs, using, call, res: dict, flops: float) -> None:
    """Times `call` with each build in turns into `res`: event ms (other,
    this, this, other), graph ms (other, this), means, speedup, TFLOP/s."""
    times = {"other": [], "this": []}
    for tag in ("other", "this", "this", "other"):
        with using(tag):
            times[tag].append(cs._time_ms(call, iters=20, warmup=3))
    graph = {}
    for tag in ("other", "this"):
        with using(tag):
            graph[tag] = _graph_ms(cs, call)
    mean = {t: sum(x) / len(x) for t, x in times.items()}
    res.update(this_ms=times["this"], other_ms=times["other"], this_graph_ms=graph["this"],
               other_graph_ms=graph["other"], speedup=mean["other"] / mean["this"],
               graph_speedup=graph["other"] / graph["this"],
               this_tflops=flops / mean["this"] / 1e9, other_tflops=flops / mean["other"] / 1e9)


def _agree(outs: dict, tag: str) -> dict:
    """rel-L2 between this and other, bit-identity to other and across two
    calls of this, for (out, lse) pairs; raises past rel-L2 1e-2."""
    (o_t, l_t), (o_o, l_o), (o_a, l_a) = (outs[k] for k in ("this", "other", "this_again"))
    rel = ((o_t.float() - o_o.float()).norm() / o_o.float().norm()).item()
    res = {"rel_l2_between": rel,
           "bit_identical_between": bool(torch.equal(o_t, o_o) and torch.equal(l_t, l_o)),
           "deterministic": bool(torch.equal(o_t, o_a) and torch.equal(l_t, l_a))}
    if not rel <= 1e-2:
        raise AssertionError(f"{tag}: the two kernels disagree (rel-L2 {rel:.3e})")
    if not res["deterministic"]:
        raise AssertionError(f"{tag}: this checkout's kernel is not deterministic")
    return res


def kernels(other: Path) -> dict:
    sys.path.insert(0, str(ROOT))
    cs = _chip_smoke()
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from internvideo_tpu_torch.ops import flash_attention as fa

    card = _card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    builds = {"this": _load_build(ROOT, "this_build"), "other": _load_build(other, "other_build")}
    with ThreadPoolExecutor(2) as ex:
        for tag, path in zip(builds, ex.map(lambda m: m.build(), builds.values())):
            print(f"{tag}: {path}", flush=True)

    @contextlib.contextmanager
    def using(tag):
        saved, fa._build = fa._build, builds[tag]
        try:
            yield
        finally:
            fa._build = saved

    g = torch.Generator("cuda").manual_seed(13)
    res = {"card": card}
    for tag, kernel, (b, sq, sk, h, d) in SHAPES:
        qkv = torch.randn(b, max(sq, sk), 3 * h * d, device="cuda", generator=g).bfloat16()
        q, k, v = (x.unflatten(-1, (h, d)) for x in qkv.split(h * d, dim=-1))
        q, k, v = q[:, :sq], k[:, :sk], v[:, :sk]

        def call():
            return fa._flash_fwd_cuda(q, k, v, d ** -0.5, kernel=kernel)

        with torch.no_grad():
            outs = {}
            for t in ("other", "this", "this_again"):
                with using(t.split("_")[0]):
                    outs[t] = call()
            torch.cuda.synchronize()
            r = {"kernel": kernel, "shape_b_sq_sk_h_d": [b, sq, sk, h, d], **_agree(outs, tag)}
            del outs
            _in_turns(cs, using, call, r, 4 * b * h * sq * sk * d)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                r["sdpa_ms"] = cs._time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                                           iters=20, warmup=3)
            r["bound_ms"], r["bound_by"] = cs._fwd_bound(b, sq, h, d) if sq == sk else cs._bound(
                4 * b * h * sq * sk * d, (2 * b * sq * h * d + 2 * b * sk * h * d) * 2
                + b * h * sq * 4)
        res[tag] = r
        print(f"[{card}] {kernel} {tag} {(b, sq, sk, h, d)}: this {r['this_ms']} ms "
              f"({r['this_tflops']:.1f} TFLOP/s; graph {r['this_graph_ms']:.4f}), other "
              f"{r['other_ms']} ({r['other_tflops']:.1f}; graph {r['other_graph_ms']:.4f}), "
              f"x{r['speedup']:.2f} (graph x{r['graph_speedup']:.2f}); SDPA {r['sdpa_ms']:.4f}; "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']}); rel-L2 between "
              f"{r['rel_l2_between']:.2e}, bit-identical {r['bit_identical_between']}",
              flush=True)
        del qkv, q, k, v
        torch.cuda.empty_cache()

    # K5's forward runs the same body: its prefill shapes, k / v strided views
    for tag, (b, s, hq, hkv, d, dv) in (
            ("k5_qwen3_8b_mla", (*cs.CAUSAL_SHAPE[:3], cs.CAUSAL_SHAPE[2], *cs.CAUSAL_SHAPE[3:])),
            ("k5_qwen3_8b_dense_gqa", (*cs.GQA_SHAPE, cs.GQA_SHAPE[-1]))):
        q = torch.randn(b, s, hq, d, device="cuda", generator=g).bfloat16()
        kv = torch.randn(b, s, hkv, d + dv, device="cuda", generator=g).bfloat16()
        k, v = kv[..., :d], kv[..., d:]

        def call():
            return fa._flash_fwd_causal_cuda(q, k, v, d ** -0.5, True, 0, None, None, None)

        with torch.no_grad():
            outs = {}
            for t in ("other", "this", "this_again"):
                with using(t.split("_")[0]):
                    outs[t] = call()
            torch.cuda.synchronize()
            r = {"shape_b_s_hq_hkv_dqk_dv": [b, s, hq, hkv, d, dv], **_agree(outs, tag)}
            del outs
            _in_turns(cs, using, call, r, 2 * b * hq * (s * (s + 1) // 2) * (d + dv))
        res[tag] = r
        print(f"[{card}] K5 {tag}: this {r['this_ms']} ms, other {r['other_ms']}, "
              f"x{r['speedup']:.2f}; bit-identical {r['bit_identical_between']}", flush=True)
        del q, kv, k, v
    return res


def downstream(root: Path) -> dict:
    os.chdir(root)  # the configs are read relative to the checkout
    sys.path.insert(0, str(root))
    cs = _chip_smoke()
    from internvideo_tpu_torch.core.config import load_config
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2
    from internvideo_tpu_torch.ops import _build
    from internvideo_tpu_torch.ops import flash_attention as fa

    card = _card()
    print(card, flush=True)
    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"root": str(root), "card": card}
    g = torch.Generator("cuda").manual_seed(2)
    model = InternVideo2(load_config(cs.CONFIG_1B).model, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0)).eval()
    video = torch.randn(16, 16, 224, 224, 3, device="cuda", generator=g)
    with torch.inference_mode():
        ms = cs._time_ms(lambda: model(video), iters=3)
    res["forward_1b_b16_ms"], res["forward_1b_clips_per_s"] = ms, 16e3 / ms
    print(f"[{card}] InternVideo2-1B fwd 16x224 bf16 B=16: {ms:.1f} ms = {16e3 / ms:.2f} "
          f"clips/s", flush=True)
    del model, video
    gc.collect()
    torch.cuda.empty_cache()
    step_ms = cs.time_finetune_step(load_config(cs.CONFIG_TRAIN), card)
    res["finetune_step_ms"] = step_ms
    res["finetune_clips_per_s"] = cs.TRAIN_SHAPE[0] * 1e3 / step_ms
    gc.collect()
    torch.cuda.empty_cache()
    res["pretrain"] = cs.time_pretrain_step(fa, load_config(cs.CONFIG_PRETRAIN), card)
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
