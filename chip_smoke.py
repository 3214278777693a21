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
     B = 16 through both routes (clips/s);
  7. the backward kernels (dq, dk/dv) vs their plain version on the card:
     fp32 at the JAX kernel tests' shapes (max-abs <= 5e-4, the JAX grad
     bar), bf16 at the finetune's (32, 2049, 16, 88) with q/k/v as views of
     one (B, S, 3*1408) tensor (rel-L2 <= 1e-2 each), and with a nonzero
     LSE cotangent;
  8. the training main path: `internvideo_tpu_torch.cli.train` on
     configs/torch/finetune_k400_1b.py (InternVideo2-1B, 8 x 224 px, B = 32,
     bf16 + fp32 params, remat, drop-path, mixup/cutmix) for 3 steps; the
     launch counts are reset just before and read just after and must be
     80 flash_fwd (forward + remat recompute), 40 dq and 40 dk/dv per step;
     every logged loss and grad_norm must be finite;
  9. kernel route vs plain route in training: fp32 at 1B widths and depth
     2 (loss and every parameter's grad max-abs <= 5e-4), and bf16 at the
     full depth with B = 2 (loss rel <= 1e-2; rel-L2 <= 2e-2 on the grads of
     blocks.{0,39}.attn.qkv.weight and .q_norm.weight);
 10. times with CUDA events: the train step at B = 32 on a device-resident
     batch (ms, clips/s), dq and dk/dv at (32, 2049, 16, 88) bf16 beside the
     plain backward, and as yardsticks only (never on the port's path)
     PyTorch's flash SDPA forward, backward and forward + backward at the
     finetune's and the eval's shapes; one more train step under
     torch.profiler gives device time by kernel group and the idle share.

The last three lines are the card, the kernel table as JSON and
{"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import gc
import io
import json
import math
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

CONFIG_1B = "configs/torch/eval_classification_1b.py"
MAIN_SHAPE = (16, 4097, 16, 88)  # B, S, H, head_dim of the 1B at 16 x 224
DEPTH_1B = 40
CONFIG_TRAIN = "configs/torch/finetune_k400_1b.py"
TRAIN_SHAPE = (32, 2049, 16, 88)  # B, S, H, head_dim of the 1B finetune at 8 x 224
TRAIN_STEPS = 3
# H100 SXM dense peaks (NVIDIA data sheet, 700 W): bf16 tensor cores, HBM
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12


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


def _bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(least ms on the card, what bounds it) for `flops` bf16 tensor-core
    operations and `nbytes` of device-memory traffic."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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


def check_backward(fa) -> dict:
    """Phase 7; returns the max-abs errors of dq and of dk/dv at TRAIN_SHAPE
    bf16, the shape the main path gives the kernels."""
    g = torch.Generator("cuda").manual_seed(3)

    def grads(q, k, v, do, gl=None):
        q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
        out, lse = fa.flash_attention_with_lse(q, k, v)
        loss = (out.float() * do.float()).sum()
        if gl is not None:
            loss = loss + (lse * gl).sum()
        got = torch.autograd.grad(loss, (q, k, v))
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), out.detach(),
                                         lse.detach(), do, q.shape[-1] ** -0.5, lse_ct=gl)
        return got, ref

    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=g)  # noqa: E731
    cases = [(2, 256, 256, 2, 64, False), (1, 257, 257, 2, 88, False),
             (1, 256, 263, 2, 64, False), (1, 263, 256, 2, 64, False),
             (1, 257, 257, 2, 88, True)]
    for b, sq, sk, h, d, with_lse in cases:
        q, do = rnd(b, sq, h, d), rnd(b, sq, h, d)
        k, v = rnd(b, sk, h, d), rnd(b, sk, h, d)
        gl = rnd(b, h, sq) if with_lse else None
        got, ref = grads(q, k, v, do, gl)
        errs = [(x - r).abs().max().item() for x, r in zip(got, ref)]
        print(f"bwd kernels fp32 {(b, sq, sk, h, d)}{' + dLSE' if with_lse else ''}: "
              f"dq/dk/dv max-abs {errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e} (bar 5e-4)",
              flush=True)
        if not max(errs) <= 5e-4:
            raise AssertionError("fp32 backward kernels disagree with their plain version")

    out = {}
    for b, with_lse in ((TRAIN_SHAPE[0], False), (2, True)):
        _, s, h, d = TRAIN_SHAPE
        qkv = rnd(b, s, 3 * h * d).bfloat16()
        q, k, v = (x.unflatten(-1, (h, d)) for x in qkv.split(h * d, dim=-1))
        do = rnd(b, s, h, d).bfloat16()
        gl = rnd(b, h, s) if with_lse else None
        got, ref = grads(q, k, v, do, gl)
        rels = [_rel(x, r) for x, r in zip(got, ref)]
        errs = [(x.float() - r.float()).abs().max().item() for x, r in zip(got, ref)]
        print(f"bwd kernels bf16 {(b, s, s, h, d)} strided qkv views"
              f"{' + dLSE' if with_lse else ''}: dq/dk/dv rel-L2 {rels[0]:.3e} / "
              f"{rels[1]:.3e} / {rels[2]:.3e} (bar 1e-2), max-abs {errs[0]:.3e} / "
              f"{errs[1]:.3e} / {errs[2]:.3e}", flush=True)
        if not max(rels) <= 1e-2:
            raise AssertionError("bf16 backward kernels disagree with their plain version")
        if not with_lse:
            out = {"flash_bwd_dq": errs[0], "flash_bwd_dkv": max(errs[1:])}
        del qkv, q, k, v, do, got, ref
    return out


def run_train_path(fa) -> dict:
    """Phase 8; returns the launches of each kernel in the main-path run."""
    from internvideo_tpu_torch.cli import train as cli

    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fa.reset_launch_count()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--config", CONFIG_TRAIN, "--device", "cuda",
                       f"trainer.total_steps={TRAIN_STEPS}", "trainer.log_every=1",
                       "trainer.checkpoint_dir=None"])
    torch.cuda.synchronize()
    launches = {name: fa.launch_count(name) for name in fa.KERNELS}
    wall = time.perf_counter() - t0
    records = [dict(kv.split(": ") for kv in line.split("  "))
               for line in buf.getvalue().splitlines() if line.startswith("step: ")]
    for r in records:
        print(f"cli.train {CONFIG_TRAIN}: {r}", flush=True)
    print(f"main path (train): {TRAIN_STEPS} steps in {wall:.1f} s wall incl. model init, "
          f"host data and the first call's build; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {launches}", flush=True)
    if rc != 0 or len(records) != TRAIN_STEPS:
        raise AssertionError(f"cli.train logged {len(records)} of {TRAIN_STEPS} steps")
    if not all(math.isfinite(float(r[k])) for r in records for k in ("loss", "grad_norm")):
        raise AssertionError("non-finite loss or grad_norm on the training main path")
    want = {"flash_fwd": 2 * DEPTH_1B * TRAIN_STEPS, "flash_bwd_dq": DEPTH_1B * TRAIN_STEPS,
            "flash_bwd_dkv": DEPTH_1B * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"launches {launches} on the training main path; expected "
                             f"{want} (80 forward incl. remat, 40 dq, 40 dk/dv per step)")
    return launches


def _train_model(run, **overrides):
    """The finetune config's model on the card, gammas 0.1 and the head at
    std ~0.02, so that every branch moves the loss."""
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2
    from internvideo_tpu_torch.nn.transformer import LayerScale

    cfg = dataclasses.replace(run.model, drop_path_rate=0.0, **overrides)
    model = InternVideo2(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LayerScale):
                m.gamma.fill_(0.1)
        model.head.weight.mul_(1000)
    return model


def _loss_and_grads(model, video, labels, impl):
    from internvideo_tpu_torch.data.mixup import smoothed_one_hot
    from internvideo_tpu_torch.train.engines.finetune import soft_target_ce

    _set_attn_impl(model, impl)
    model.zero_grad(set_to_none=True)
    logits = model(video).logits
    loss = soft_target_ce(logits, smoothed_one_hot(labels, logits.shape[-1], 0.1))
    loss.backward()
    return loss.detach(), {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def check_train_routes(run):
    """Phase 9."""
    g = torch.Generator("cuda").manual_seed(4)
    c = run.model
    video = torch.randn(2, c.num_frames, c.img_size, c.img_size, 3, device="cuda", generator=g)
    labels = torch.randint(0, c.num_classes, (2,), device="cuda", generator=g)

    model = _train_model(run, depth=2, dtype="float32", param_dtype="float32", remat=False)
    (lk, gk), (lp, gp) = (_loss_and_grads(model, video, labels, i) for i in ("kernel", "plain"))
    errs = {n: (gk[n] - gp[n]).abs().max().item() for n in gk}
    worst = max(errs, key=errs.get)
    print(f"train fp32 1B widths depth 2 B=2, kernel vs plain route: loss {lk.item():.6f} / "
          f"{lp.item():.6f} (abs diff {abs(lk - lp).item():.3e}), worst grad max-abs "
          f"{errs[worst]:.3e} at {worst} (grad max {gp[worst].abs().max().item():.3e}); "
          f"bar 5e-4 on all {len(errs)} params", flush=True)
    if not (abs(lk - lp).item() <= 5e-4 and errs[worst] <= 5e-4):
        raise AssertionError("fp32 training routes disagree")
    del model, gk, gp

    model = _train_model(run)
    (lk, gk), (lp, gp) = (_loss_and_grads(model, video, labels, i) for i in ("kernel", "plain"))
    rel_loss = abs(lk - lp).item() / abs(lp).item()
    names = [f"blocks.{i}.attn.{w}.weight" for i in (0, DEPTH_1B - 1) for w in ("qkv", "q_norm")]
    rels = {n: _rel(gk[n], gp[n]) for n in names}
    print(f"train bf16 1B B=2, kernel vs plain route: loss {lk.item():.6f} / {lp.item():.6f} "
          f"(rel {rel_loss:.3e}, bar 1e-2); grad rel-L2 "
          + ", ".join(f"{n} {r:.3e}" for n, r in rels.items()) + " (bar 2e-2)", flush=True)
    if not (rel_loss <= 1e-2 and max(rels.values()) <= 2e-2):
        raise AssertionError("bf16 training routes disagree")


def _sdpa_times(shape, card) -> dict:
    """PyTorch's flash SDPA at `shape` (B, S, H, D) bf16, as a yardstick:
    forward, backward alone (the aten backward op) and forward + backward."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, s, h, d = shape
    g = torch.Generator("cuda").manual_seed(5)
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=g).bfloat16()
                   .transpose(1, 2) for _ in range(4))
    aten = torch.ops.aten
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        fwd = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=10, warmup=2)
        r = aten._scaled_dot_product_flash_attention(q, k, v, 0.0, False, False)
        bwd = _time_ms(lambda: aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, r[0], r[1], r[2], r[3], r[4], r[5], 0.0, False, r[6], r[7]),
            iters=10, warmup=2)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        both = _time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(*leaves), leaves, do), iters=10, warmup=2)
    print(f"[{card}] yardstick torch flash SDPA {shape} bf16: fwd {fwd:.3f} ms, bwd "
          f"{bwd:.3f} ms, fwd+bwd {both:.3f} ms", flush=True)
    return {"fwd": fwd, "bwd": bwd, "fwd_bwd": both}


def _kernel_group(name: str) -> str:
    n = name.lower()
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if key in n:
            return key
    if any(t in n for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "GEMMs (cuBLAS)"
    if "adam" in n or "multi_tensor" in n:
        return "optimizer (foreach AdamW, norms)"
    return "elementwise / reductions / copies"


def profile_step(step, card) -> None:
    """One train step under torch.profiler: device time by kernel group and
    the device's idle share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    groups, launches = {}, {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.self_device_time_total <= 0:
            continue
        g = _kernel_group(evt.key)
        groups[g] = groups.get(g, 0.0) + evt.self_device_time_total / 1e3
        launches[g] = launches.get(g, 0) + evt.count
    busy = sum(groups.values())
    if not busy:
        print(f"[{card}] train step profile: the profiler saw no device time; breakdown "
              f"not measured (step wall {wall:.1f} ms)", flush=True)
        return
    print(f"[{card}] train step under torch.profiler: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms, idle {max(0.0, 1 - busy / wall):.1%}", flush=True)
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {t:.1f} ms ({t / busy:.1%} of device time, {launches[g]} launches)",
              flush=True)


def time_train(fa, run, card) -> dict:
    """Phase 10; returns each backward kernel's ms, the plain backward's ms
    and the SDPA yardsticks."""
    from internvideo_tpu_torch.cli import train as cli

    b, s, h, d = TRAIN_SHAPE
    g = torch.Generator("cuda").manual_seed(6)
    q, k, v, do = (torch.randn(*TRAIN_SHAPE, device="cuda", generator=g).bfloat16()
                   for _ in range(4))
    scale = d ** -0.5
    with torch.no_grad():
        out, lse = fa._flash_fwd_cuda(q, k, v, scale)
        delta = fa._bwd_delta(out, do)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        ms = {
            "flash_fwd": _time_ms(lambda: fa._flash_fwd_cuda(q, k, v, scale), iters=10, warmup=2),
            "flash_bwd_dq": _time_ms(lambda: fa._launch_bwd(
                "flash_bwd_dq", q, k, v, do, lse, delta, (dq,), scale), iters=10, warmup=2),
            "flash_bwd_dkv": _time_ms(lambda: fa._launch_bwd(
                "flash_bwd_dkv", q, k, v, do, lse, delta, (dk, dv), scale), iters=10, warmup=2),
            "plain_bwd": _time_ms(lambda: fa.flash_attention_bwd_ref(
                q, k, v, out, lse, do, scale), iters=2),
        }
    tflop = {"flash_fwd": 4, "flash_bwd_dq": 6, "flash_bwd_dkv": 8}
    for name, n in tflop.items():
        rate = n * b * h * s * s * d / ms[name] / 1e9
        print(f"[{card}] {name} {TRAIN_SHAPE} bf16: {ms[name]:.3f} ms ({rate:.1f} TFLOP/s)",
              flush=True)
    print(f"[{card}] plain backward {TRAIN_SHAPE} bf16 (dq, dk, dv together): "
          f"{ms['plain_bwd']:.3f} ms", flush=True)
    del q, k, v, do, out, lse, delta, dq, dk, dv
    sdpa = {"train": _sdpa_times(TRAIN_SHAPE, card), "eval": _sdpa_times(MAIN_SHAPE, card)}

    trainer, _ = cli.build_finetune(dataclasses.replace(
        run, trainer=dataclasses.replace(run.trainer, checkpoint_dir=None)), torch.device("cuda"))
    c = run.model
    batch = {"video": torch.randn(b, c.num_frames, c.img_size, c.img_size, 3, device="cuda",
                                  generator=g),
             "label": torch.randint(0, c.num_classes, (b,), device="cuda", generator=g)}
    step_ms = _time_ms(lambda: trainer._step(trainer.state, batch), iters=3, warmup=1)
    print(f"[{card}] InternVideo2-1B finetune train step 8x224 bf16 B={b} (remat, drop-path, "
          f"mixup/cutmix, AdamW), device-resident batch: {step_ms:.1f} ms = "
          f"{b * 1e3 / step_ms:.2f} clips/s", flush=True)
    ms["train_step"] = step_ms
    profile_step(lambda: trainer._step(trainer.state, batch), card)
    ms["sdpa"] = sdpa
    return ms


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
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # 7. backward kernels vs plain
    bwd_err = check_backward(fa)

    # 8. the training main path, counting launches
    train_launches = run_train_path(fa)
    gc.collect()
    torch.cuda.empty_cache()

    # 9. kernel route vs plain route in training
    run = load_config(CONFIG_TRAIN)
    check_train_routes(run)
    gc.collect()
    torch.cuda.empty_cache()

    # 10. times
    t = time_train(fa, run, card)

    b, s, h, d = MAIN_SHAPE
    fwd_bound = _bound(4 * b * h * s * s * d, (4 * b * s * h * d) * 2 + b * h * s * 4)
    b, s, h, d = TRAIN_SHAPE
    io_bytes = 4 * b * s * h * d * 2 + 2 * b * h * s * 4  # q, k, v, dO; lse, delta
    bounds = {"flash_bwd_dq": _bound(6 * b * h * s * s * d, io_bytes + b * s * h * d * 2),
              "flash_bwd_dkv": _bound(8 * b * h * s * s * d, io_bytes + 2 * b * s * h * d * 2)}
    src = "internvideo_tpu_torch/csrc/"
    kernels = [{
        "name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
        "replaces": "internvideo_tpu/ops/flash_attention.py:153",
        "launches": launches + train_launches["flash_fwd"],
        "launches_by_path": {"eval": launches, "train": train_launches["flash_fwd"]},
        "max_abs_err": max_abs, "ms": kern_ms, "plain_ms": plain_ms,
        "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
        "library_ms": t["sdpa"]["eval"]["fwd"], "shape": list(MAIN_SHAPE),
    }] + [{
        "name": name, "route": "cuda", "source": src + "flash_bwd.cu",
        "replaces": f"internvideo_tpu/ops/flash_attention.py:{line}",
        "launches": train_launches[name], "max_abs_err": bwd_err[name],
        "ms": t[name], "plain_ms": t["plain_bwd"],
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        "library_ms": t["sdpa"]["train"]["bwd"], "shape": list(TRAIN_SHAPE),
    } for name, line in (("flash_bwd_dq", 468), ("flash_bwd_dkv", 613))]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
