#!/usr/bin/env python3
"""K11, the fused qkv + QK-RMSNorm + blocked-K attention for 1024 < S <=
8192 (csrc/fused_qkv.cu's pre-pass, csrc/fused_qkv_large.cu's entry),
against another checkout's, on one card.

    python3 tools_torch/compare_k11.py kernels --other DIR

Builds this checkout's kernel library and DIR's (each with its own
`ops/_build.py`, into its own `build/`, the two builds side by side). At
the 1B eval's (16, 4097, 16, 88) and the stage-2 tower's (32, 1025, 16, 88),
bf16, on one (B, S, 3W) projection with (W,) fp32 weights, it runs this
checkout's op through its wrapper and DIR's through its own C entries
(DIR's signature if its library has no normed-k pre-pass, else this
checkout's wrapper on DIR's library). It holds both outputs to the plain
version (rel-L2 <= 1e-2), gives their distance, checks that this
checkout's output is bit-identical across two calls and that its normed k
rows are the cast chain on its own 1/rms bit for bit (and how many
elements, at most how many bf16 ulps, differ from `rms_norm` of the k
slice), then times the op (pre-pass + attention) of both in turns (other,
this, this, other; CUDA events, 20 calls each) and once more each by CUDA
graph replay, with each checkout's split between its two launches
(torch.profiler), the bound, and the yardsticks in the same call: K1 on the
pre-normed q / k, the production route (2 `rms_norm` + K1) and, as a
yardstick the port never calls, SDPA on the pre-normed q / k.

Prints the card's name and power limit, then one JSON line. Needs one CUDA
card; nothing here imports JAX.
"""

import argparse
import contextlib
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
from compare_fwd_k1k2 import _in_turns  # noqa: E402
from compare_k3_k6 import _split_ms  # noqa: E402
from compare_k4a import _chip_smoke  # noqa: E402
from compare_k5_fwd import _card, _load_build  # noqa: E402

SHAPES = [("eval_1b", (16, 4097, 16, 88)), ("retrieval_tower", (32, 1025, 16, 88))]
EPS = 1e-6


def _earlier_op(lib, qkv, qw, kw, h: int, scale: float):
    """The op through a library whose K11 entry has the earlier signature
    (no normed-k buffer: the attention norms q and k on load): the rstd
    pre-pass, then ivt_fused_qkv_large_fwd with K3's arguments; (B, S, W)."""
    b, s, w3 = qkv.shape
    w = w3 // 3
    d = w // h
    q_rstd, k_rstd = (torch.empty((b, s), dtype=torch.float32, device=qkv.device)
                      for _ in range(2))
    out = torch.empty((b, s, w), dtype=qkv.dtype, device=qkv.device)
    s_b, s_s = qkv.stride()[:2]
    stream = torch.cuda.current_stream().cuda_stream
    rc = lib.ivt_fused_qkv_rstd(1, qkv.data_ptr(), q_rstd.data_ptr(), k_rstd.data_ptr(), b, s, w,
                                s_b, s_s, EPS, stream)
    rc = rc or lib.ivt_fused_qkv_large_fwd(
        1, qkv.data_ptr(), q_rstd.data_ptr(), k_rstd.data_ptr(), qw.data_ptr(), kw.data_ptr(),
        out.data_ptr(), b, s, h, d, s_b, s_s, s * w, w, d, scale, stream)
    if rc != 0:
        raise RuntimeError(f"the other checkout's K11 failed: cudaError_t {rc}")
    return out


def _k11(cs, fa, using, card, g) -> dict:
    from internvideo_tpu_torch.ops.rmsnorm import rms_norm

    res = {}
    for tag, (b, s, h, d) in SHAPES:
        w = h * d
        qkv = (torch.randn(b, s, 3 * w, device="cuda", generator=g) * 2).bfloat16()
        qw, kw = (torch.randn(w, device="cuda", generator=g) * 0.1 + 1 for _ in range(2))
        scale = d ** -0.5
        with torch.no_grad():
            outs = {}
            for t in ("other", "this", "this_again"):
                with using(t.split("_")[0]) as call:
                    outs[t] = call(qkv, qw, kw, h, scale)
            ref = fa.fused_qkv_large_ref(qkv, qw, kw, h, scale)
            with using("this"):
                _, k_rstd, k_normed = fa._fused_prepass_cuda(qkv, kw, EPS, normed_k=True)
            ref_normed = fa.fused_qkv_large_prepass_ref(qkv, kw, EPS)[2]
            own = (kw * (qkv[..., w:2 * w].float() * k_rstd[..., None]).bfloat16()).bfloat16()
            torch.cuda.synchronize()
            bits = [x.float().view(torch.int32) >> 16 for x in (k_normed, ref_normed)]
            r = {"shape_b_s_h_d": [b, s, h, d],
                 "rel_l2_between": cs._rel(outs["this"], outs["other"]),
                 "bit_identical_between": bool(torch.equal(outs["this"], outs["other"])),
                 "deterministic": bool(torch.equal(outs["this"], outs["this_again"])),
                 "rel_l2_to_plain": cs._rel(outs["this"], ref),
                 "other_rel_l2_to_plain": cs._rel(outs["other"], ref),
                 "normed_k_is_chain_on_own_rstd": bool(torch.equal(k_normed, own)),
                 "normed_k_elements_off_rms_norm": int((k_normed != ref_normed).sum().item()),
                 "normed_k_max_ulps_off_rms_norm": int((bits[0] - bits[1]).abs().max().item())}
            del outs, ref, k_rstd, k_normed, ref_normed, own, bits
            if not max(r["rel_l2_to_plain"], r["other_rel_l2_to_plain"]) <= 1e-2:
                raise AssertionError(f"K11 {tag}: a kernel disagrees with the plain version {r}")
            if not (r["deterministic"] and r["normed_k_is_chain_on_own_rstd"]
                    and r["normed_k_max_ulps_off_rms_norm"] <= 2):
                raise AssertionError(f"K11 {tag}: this checkout's op is off {r}")
            flops = 4 * b * h * s * s * d

            def timed():
                return timed.call(qkv, qw, kw, h, scale)

            @contextlib.contextmanager
            def timing(t):
                with using(t) as call:
                    timed.call = call
                    yield

            _in_turns(cs, timing, timed, r, flops)
            r["bound_ms"], r["bound_by"] = cs._bound(flops, 4 * b * s * w * 2 + 2 * w * 4)
            for t in ("other", "this"):
                with timing(t):
                    split = _split_ms(timed, ("fused_qkv_rstd", "fused_qkv_large_fwd"))
                r[f"{t}_prepass_ms"] = split["fused_qkv_rstd"]
                r[f"{t}_attention_ms"] = split["fused_qkv_large_fwd"]
            with using("this"):
                qn = rms_norm(qkv[..., :w], qw).unflatten(-1, (h, d))
                kn = rms_norm(qkv[..., w:2 * w], kw).unflatten(-1, (h, d))
                v = qkv[..., 2 * w:].unflatten(-1, (h, d))
                r["k1_on_normed_ms"] = cs._time_ms(lambda: fa._flash_fwd_cuda(qn, kn, v, scale),
                                                   iters=20, warmup=3)
                r["production_route_ms"] = cs._time_ms(
                    lambda: fa._fused_large_unfused(qkv, qw, kw, h, scale, EPS), iters=20,
                    warmup=3)
                r["sdpa_on_normed_ms"] = cs._sdpa_fwd_ms(qn, kn, v)
            del qn, kn, v
        res[tag] = r
        print(f"[{card}] K11 {tag} {(b, s, h, d)}: this {r['this_ms']} ms (graph "
              f"{r['this_graph_ms']:.4f}; pre-pass {r['this_prepass_ms']:.4f} + attention "
              f"{r['this_attention_ms']:.4f}), other {r['other_ms']} (graph "
              f"{r['other_graph_ms']:.4f}; {r['other_prepass_ms']:.4f} + "
              f"{r['other_attention_ms']:.4f}), x{r['speedup']:.2f}; K1 on normed q / k "
              f"{r['k1_on_normed_ms']:.4f}, the production route "
              f"{r['production_route_ms']:.4f}, SDPA on normed {r['sdpa_on_normed_ms']:.4f}; "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']}); rel-L2 to plain "
              f"{r['rel_l2_to_plain']:.3e} / {r['other_rel_l2_to_plain']:.3e}, between "
              f"{r['rel_l2_between']:.3e}; normed k: the chain on its own 1/rms "
              f"{r['normed_k_is_chain_on_own_rstd']}, {r['normed_k_elements_off_rms_norm']} "
              f"elements off rms_norm (<= {r['normed_k_max_ulps_off_rms_norm']} ulp)",
              flush=True)
        del qkv
        torch.cuda.empty_cache()
    return res


def kernels(other: Path) -> dict:
    sys.path.insert(0, str(ROOT))
    cs = _chip_smoke()
    from internvideo_tpu_torch.ops import flash_attention as fa

    card = _card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    builds = {"this": _load_build(ROOT, "this_build"), "other": _load_build(other, "other_build")}
    with ThreadPoolExecutor(2) as ex:
        for tag, path in zip(builds, ex.map(lambda m: m.build(), builds.values())):
            print(f"{tag}: {path}", flush=True)
    other_lib = builds["other"].load_library()
    earlier = not hasattr(other_lib, "ivt_fused_qkv_rstd_normed_k")

    def wrapper(qkv, qw, kw, h, scale):
        return fa._fused_qkv_cuda(qkv, qw, kw, h, scale, EPS, kernel="fused_qkv_large_fwd")

    def other_earlier(qkv, qw, kw, h, scale):
        return _earlier_op(other_lib, qkv, qw, kw, h, scale)

    @contextlib.contextmanager
    def using(tag):
        saved, fa._build = fa._build, builds[tag]
        try:
            yield other_earlier if tag == "other" and earlier else wrapper
        finally:
            fa._build = saved

    g = torch.Generator("cuda").manual_seed(16)
    return {"card": card, "other_signature": "earlier" if earlier else "this",
            "k11": _k11(cs, fa, using, card, g)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    k = sub.add_parser("kernels")
    k.add_argument("--other", type=Path, required=True, help="the other checkout's root")
    args = ap.parse_args()
    print(json.dumps(kernels(args.other.resolve())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
