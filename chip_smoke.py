#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each raising on failure (none is caught, so any failure exits
non-zero and prints no result):

  1. device: needs torch.cuda; prints torch/CUDA versions and the card's
     name and power limit from nvidia-smi;
  2. build: compiles internvideo_tpu_torch/csrc/*.cu with nvcc;
  3. the flash kernel vs its plain PyTorch version on the card, at the JAX
     kernel tests' shapes (fp32, max-abs 2e-5) and at the encoder's
     (2, 4097, 16, 88) bf16 with q/k/v as views of one (B, S, 3*1408)
     tensor (out rel-L2 <= 1e-2, LSE max-abs <= 1e-2);
  4. the main path: `internvideo_tpu_torch.cli.eval` on
     configs/torch/eval_classification_1b.py (InternVideo2-1B, 16 x 224 px,
     bf16, B = 16); every kernel launch count is reset just before and
     read just after, and must be 40 per forward; logits must be finite;
  5. the same seeded 1B model at B = 2 with every LayerScale gamma at 0.1,
     kernel route vs plain route (pooled and logits rel-L2 <= 1e-2), and
     the kernel vs plain on the real q/k/v of blocks 0 and 39;
  6. at the main path's (16, 4097, 16, 88) bf16: the kernel vs plain
     (rel-L2 <= 1e-2) and both times with CUDA events; the 1B forward at
     B = 16 through both routes (clips/s).

The last two lines are the kernel table as JSON and
{"ok": true, "device": {...}}.
"""

import contextlib
import io
import json
import subprocess
import sys
import time

import torch

CONFIG_1B = "configs/torch/eval_classification_1b.py"
MAIN_SHAPE = (16, 4097, 16, 88)  # B, S, H, head_dim of the 1B at 16 x 224
DEPTH_1B = 40


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _time_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _set_attn_impl(model, impl: str) -> None:
    from internvideo_tpu_torch.nn.transformer import Attention

    for m in model.modules():
        if isinstance(m, Attention):
            m.attn_impl = impl


def check_kernel(fa) -> None:
    """Phase 3."""
    g = torch.Generator("cuda").manual_seed(0)
    for b, sq, sk, h, d in [(2, 256, 256, 2, 64), (1, 257, 257, 2, 88),
                            (1, 256, 263, 2, 64), (1, 263, 256, 2, 64)]:
        q = torch.randn(b, sq, h, d, device="cuda", generator=g)
        k = torch.randn(b, sk, h, d, device="cuda", generator=g)
        v = torch.randn(b, sk, h, d, device="cuda", generator=g)
        out, lse = fa.flash_attention_with_lse(q, k, v)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5)
        e_out = (out - ref).abs().max().item()
        e_lse = (lse - ref_lse).abs().max().item()
        print(f"kernel fp32 {(b, sq, sk, h, d)}: out max-abs {e_out:.3e}, "
              f"lse max-abs {e_lse:.3e} (bar 2e-5)", flush=True)
        if not (e_out <= 2e-5 and e_lse <= 2e-5):
            raise AssertionError("fp32 kernel disagrees with its plain version")

    b, s, h, d = 2, *MAIN_SHAPE[1:]
    qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=g).bfloat16()
    q, k, v = (x.unflatten(-1, (h, d)) for x in qkv.split(h * d, dim=-1))
    out, lse = fa.flash_attention_with_lse(q, k, v)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5)
    rel, e_lse = _rel(out, ref), (lse - ref_lse).abs().max().item()
    max_abs = (out.float() - ref.float()).abs().max().item()
    print(f"kernel bf16 {(b, s, s, h, d)} strided qkv views: out rel-L2 {rel:.3e} "
          f"(bar 1e-2), out max-abs {max_abs:.3e}, lse max-abs {e_lse:.3e} (bar 1e-2)",
          flush=True)
    if not (rel <= 1e-2 and e_lse <= 1e-2):
        raise AssertionError("bf16 kernel disagrees with its plain version")


def run_main_path(fa) -> int:
    """Phase 4; returns the kernel launches of the main-path run."""
    from internvideo_tpu_torch.cli import eval as cli
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2

    forwards = []

    def record(module, args, out):
        if isinstance(module, InternVideo2):
            forwards.append((tuple(out.logits.shape), bool(torch.isfinite(out.logits).all())))

    hook = torch.nn.modules.module.register_module_forward_hook(record)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        fa.reset_launch_count()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--config", CONFIG_1B, "--device", "cuda"])
        torch.cuda.synchronize()
        launches = fa.launch_count()
    finally:
        hook.remove()
    wall = time.perf_counter() - t0
    result = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"cli.eval {CONFIG_1B}: {json.dumps(result)} ({wall:.1f} s wall incl. init "
          f"and data)", flush=True)
    print(f"main path: {len(forwards)} forwards, logits {forwards[0][0] if forwards else None}, "
          f"flash_fwd launches {launches}", flush=True)
    if rc != 0 or not forwards:
        raise AssertionError("cli.eval did not run a forward")
    if not all(finite for _, finite in forwards):
        raise AssertionError("non-finite logits on the main path")
    if launches != DEPTH_1B * len(forwards):
        raise AssertionError(f"{launches} kernel launches for {len(forwards)} forwards; "
                             f"expected {DEPTH_1B} per forward")
    return launches


def check_routes(fa, model):
    """Phase 5 on `model` (gammas already 0.1)."""
    g = torch.Generator("cuda").manual_seed(1)
    video = torch.randn(2, 16, 224, 224, 3, device="cuda", generator=g)
    outs = {}
    for impl in ("kernel", "plain"):
        _set_attn_impl(model, impl)
        with torch.inference_mode():
            outs[impl] = model(video)
    for name in ("pooled", "logits"):
        k, p = getattr(outs["kernel"], name), getattr(outs["plain"], name)
        rel = _rel(k, p)
        print(f"1B B=2 gammas 0.1, kernel vs plain route: {name} rel-L2 {rel:.3e} "
              f"(bar 1e-2)", flush=True)
        if not (torch.isfinite(k).all() and rel <= 1e-2):
            raise AssertionError(f"routes disagree on {name}")

    captured = {}
    hooks = [model.blocks[i].attn.register_forward_pre_hook(
        lambda mod, args, i=i: captured.__setitem__(i, mod.project_qkv(args[0])))
        for i in (0, DEPTH_1B - 1)]
    _set_attn_impl(model, "kernel")
    with torch.inference_mode():
        model(video)
    for h in hooks:
        h.remove()
    for i, (q, k, v) in sorted(captured.items()):
        with torch.inference_mode():
            out, lse = fa.flash_attention_with_lse(q, k, v)
            ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, q.shape[-1] ** -0.5)
        rel, e_lse = _rel(out, ref), (lse - ref_lse).abs().max().item()
        print(f"block {i} real q/k/v {tuple(q.shape)}: out rel-L2 {rel:.3e}, "
              f"lse max-abs {e_lse:.3e} (bars 1e-2)", flush=True)
        if not (rel <= 1e-2 and e_lse <= 1e-2):
            raise AssertionError(f"kernel disagrees with plain on block {i}")


def time_all(fa, model, card):
    """Phase 6; returns (kernel ms, plain ms, kernel max-abs error) at
    MAIN_SHAPE, the shape the main path gives the kernel."""
    g = torch.Generator("cuda").manual_seed(2)
    q, k, v = (torch.randn(*MAIN_SHAPE, device="cuda", generator=g).bfloat16()
               for _ in range(3))
    scale = MAIN_SHAPE[-1] ** -0.5
    with torch.inference_mode():
        out, lse = fa.flash_attention_with_lse(q, k, v)
        ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, scale)
        torch.cuda.synchronize()
    rel, e_lse = _rel(out, ref), (lse - ref_lse).abs().max().item()
    max_abs = (out.float() - ref.float()).abs().max().item()
    print(f"kernel bf16 {MAIN_SHAPE} (main-path shape): out rel-L2 {rel:.3e}, "
          f"max-abs {max_abs:.3e}, lse max-abs {e_lse:.3e} (bars 1e-2)", flush=True)
    if not (rel <= 1e-2 and e_lse <= 1e-2):
        raise AssertionError("bf16 kernel disagrees with its plain version at the main shape")
    del out, lse, ref, ref_lse
    with torch.inference_mode():
        kern_ms = _time_ms(lambda: fa.flash_attention_with_lse(q, k, v), iters=20, warmup=3)
        plain_ms = _time_ms(lambda: fa.flash_attention_ref_with_lse(q, k, v, scale), iters=2)
    b, s, h, d = MAIN_SHAPE
    tflop = 4 * b * h * s * s * d / 1e12
    print(f"[{card}] flash fwd {MAIN_SHAPE} bf16: kernel {kern_ms:.3f} ms "
          f"({tflop / kern_ms * 1e3:.1f} TFLOP/s), plain {plain_ms:.3f} ms "
          f"({tflop / plain_ms * 1e3:.1f} TFLOP/s)", flush=True)

    video = torch.randn(16, 16, 224, 224, 3, device="cuda", generator=g)
    with torch.inference_mode():
        _set_attn_impl(model, "kernel")
        fwd_k = _time_ms(lambda: model(video), iters=3)
        # the plain route's fp32 scores are ~4.3 GB per layer for 4 clips:
        # it runs the batch in chunks of 4
        _set_attn_impl(model, "plain")
        fwd_p = _time_ms(lambda: [model(c) for c in video.split(4)], iters=1)
    print(f"[{card}] InternVideo2-1B fwd 16x224 bf16 B=16: kernel route {fwd_k:.1f} ms "
          f"= {16e3 / fwd_k:.2f} clips/s; plain route {fwd_p:.1f} ms "
          f"= {16e3 / fwd_p:.2f} clips/s", flush=True)
    return kern_ms, plain_ms, max_abs


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from internvideo_tpu_torch.core.config import load_config
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2
    from internvideo_tpu_torch.nn.transformer import LayerScale
    from internvideo_tpu_torch.ops import _build
    from internvideo_tpu_torch.ops import flash_attention as fa

    card = _card()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}", flush=True)
    print(f"card: {card}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernel vs plain
    check_kernel(fa)

    # 4. the main path, counting launches
    launches = run_main_path(fa)

    # 5. kernel route vs plain route end to end
    cfg = load_config(CONFIG_1B).model
    model = InternVideo2(cfg, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0)).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LayerScale):
                m.gamma.fill_(0.1)
    check_routes(fa, model)

    # 6. times
    kern_ms, plain_ms, max_abs = time_all(fa, model, card)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "internvideo_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "internvideo_tpu/ops/flash_attention.py:153",
        "launches": launches, "max_abs_err": max_abs,
        "ms": kern_ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
