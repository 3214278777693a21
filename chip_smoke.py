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
     torch.profiler gives device time by kernel group and the idle share;
 11. the pretrain kernels vs their plain versions on the card: small-S
     attention (K2 forward, K4b dq and dk/dv) and the fused qkv op (K3: its
     row-statistics pre-pass and attention kernel; backward through K2 /
     K4b) in fp32 at small shapes of every instantiated head dim (max-abs
     2e-5 forward, 5e-4 grads), and in bf16 at the path's shapes on views of
     one (B, S, 3W) tensor: (32, 833, 16, 88) for K2 / K4b / K3 and the CLIP
     teacher's (512, 257, 25, 128) for K3 (rel-L2 <= 1e-2);
 12. the pretrain main path: `internvideo_tpu_torch.cli.train` on
     configs/torch/pretrain_1b_umt.py (1B student at 16 x 224, S = 833,
     CLIP-6B and MAE-g14 teachers, B = 32) for 3 steps; the launch counts are
     reset just before and read just after and must be, per step, 128
     fused_qkv_fwd and 128 fused_qkv_rstd (40 student forward + 40 remat
     recompute + 48 CLIP teacher), 40 small_s_fwd / small_s_bwd_dq /
     small_s_bwd_dkv (K3's backward), 40 flash_fwd (MAE teacher) and no K4a;
     every logged loss, loss term and grad_norm must be finite;
 13. kernel route vs plain route in pretraining at full widths, B = 2, with
     the same keep indices on both: the CLIP teacher's z, pooled and
     attention and the MAE teacher's z (rel-L2 <= 2e-2: 48 bf16 blocks
     deep), the loss (rel <= 1e-2) and
     the grads of encoder.blocks.{0,39}.attn.{qkv,q_norm}.weight and
     clip_decoder.0.head.weight (rel-L2 <= 2e-2);
 14. times with CUDA events: the pretrain step at B = 32 on a device-resident
     batch (ms, clips/s) split into CLIP teacher, MAE teacher and the
     student's forward + backward + update; each new kernel at its path
     shape beside its plain version, its bound and the SDPA yardstick; one
     more step under torch.profiler.

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
CONFIG_PRETRAIN = "configs/torch/pretrain_1b_umt.py"
PRETRAIN_SHAPE = (32, 833, 16, 88)  # B, S, H, head_dim of the masked 1B student
TEACHER_SHAPE = (512, 257, 25, 128)  # B*T, S, H, head_dim of the CLIP-6B teacher
PRETRAIN_STEPS = 3
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


def _raise_gammas(model, value: float = 0.1) -> None:
    """Every LayerScale gamma at `value`, so that each block moves the output."""
    from internvideo_tpu_torch.nn.transformer import LayerScale

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LayerScale):
                m.gamma.fill_(value)


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
    want = {**dict.fromkeys(fa.KERNELS, 0), "flash_fwd": 2 * DEPTH_1B * TRAIN_STEPS,
            "flash_bwd_dq": DEPTH_1B * TRAIN_STEPS, "flash_bwd_dkv": DEPTH_1B * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"launches {launches} on the training main path; expected "
                             f"{want} (80 forward incl. remat, 40 dq, 40 dk/dv per step)")
    return launches


def _train_model(run, **overrides):
    """The finetune config's model on the card, gammas 0.1 and the head at
    std ~0.02, so that every branch moves the loss."""
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2

    cfg = dataclasses.replace(run.model, drop_path_rate=0.0, **overrides)
    model = InternVideo2(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    _raise_gammas(model)
    with torch.no_grad():
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
    for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "small_s_fwd", "small_s_dq",
                "small_s_dkv", "fused_qkv_fwd", "fused_qkv_rstd"):
        if key in n:
            return key
    if any(t in n for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "GEMMs (cuBLAS)"
    if "adam" in n or "multi_tensor" in n:
        return "optimizer (foreach AdamW, norms)"
    return "elementwise / reductions / copies"


def profile_step(step, card, what: str = "train step") -> None:
    """One step under torch.profiler: device time by kernel group and the
    device's idle share of the step's wall time."""
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
        print(f"[{card}] {what} profile: the profiler saw no device time; breakdown "
              f"not measured (step wall {wall:.1f} ms)", flush=True)
        return
    print(f"[{card}] {what} under torch.profiler: wall {wall:.1f} ms, device busy "
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


def _qkv_views(b, s, h, d, g, dtype=torch.bfloat16):
    """q, k, v as (B, S, H, D) views into one (B, S, 3W) tensor."""
    qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=g).to(dtype)
    return qkv, [x.unflatten(-1, (h, d)) for x in qkv.split(h * d, dim=-1)]


def _small_s_grads(fa, q, k, v, do):
    """(out, (dq, dk, dv)) through SmallSAttention (K2, K4b)."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = fa.SmallSAttention.apply(q, k, v, q.shape[-1] ** -0.5)
    return out, torch.autograd.grad((out.float() * do.float()).sum(), (q, k, v))


def _fused_grads(fa, qkv, qw, kw, h, do):
    """(out, (dqkv, dqw, dkw)) through FusedQKVAttention (K3; K2, K4b)."""
    leaves = [x.detach().requires_grad_() for x in (qkv, qw, kw)]
    out = fa.fused_qkv_rmsnorm_attention(*leaves, num_heads=h)
    return out, torch.autograd.grad((out.float() * do.float()).sum(), leaves)


def _fused_ref_grads(fa, qkv, qw, kw, h, do):
    leaves = [x.detach().requires_grad_() for x in (qkv, qw, kw)]
    out = fa.fused_qkv_ref(*leaves, h, (qkv.shape[-1] // 3 // h) ** -0.5)
    return out, torch.autograd.grad((out.float() * do.float()).sum(), leaves)


def check_pretrain_kernels(fa) -> dict:
    """Phase 11; returns each new kernel's max-abs error at its path shape
    in bf16 (the K3 entries: the op's output)."""
    g = torch.Generator("cuda").manual_seed(7)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=g)  # noqa: E731
    for b, s, h, d in [(2, 205, 4, 88), (1, 413, 8, 88), (2, 257, 4, 128), (1, 300, 2, 64)]:
        q, k, v, do = (rnd(b, s, h, d) for _ in range(4))
        out, got = _small_s_grads(fa, q, k, v, do)
        ref, lse = fa.small_s_attention_ref(q, k, v, d ** -0.5)
        refs = fa.small_s_attention_bwd_ref(q, k, v, ref, lse, do, d ** -0.5)
        e_out = (out - ref).abs().max().item()
        errs = [(x - r).abs().max().item() for x, r in zip(got, refs)]
        qkv, qw, kw = rnd(b, s, 3 * h * d) * 2, rnd(h * d) * 0.1 + 1, rnd(h * d) * 0.1 + 1
        fout, fgot = _fused_grads(fa, qkv, qw, kw, h, do.flatten(-2))
        fref, frefs = _fused_ref_grads(fa, qkv, qw, kw, h, do.flatten(-2))
        torch.cuda.synchronize()
        e_fout = (fout - fref).abs().max().item()
        ferrs = [((x - r).abs() / (1 + r.abs())).max().item() for x, r in zip(fgot, frefs)]
        print(f"pretrain kernels fp32 {(b, s, h, d)}: K2 out max-abs {e_out:.3e} (bar 2e-5), "
              f"K4b dq/dk/dv max-abs {errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e} (bar 5e-4); "
              f"K3 out max-abs {e_fout:.3e} (bar 2e-5), grads qkv/qw/kw max |err|/(1+|ref|) "
              f"{ferrs[0]:.3e} / {ferrs[1]:.3e} / {ferrs[2]:.3e} (bar 5e-4)", flush=True)
        if not (e_out <= 2e-5 and max(errs) <= 5e-4 and e_fout <= 2e-5 and max(ferrs) <= 5e-4):
            raise AssertionError("fp32 pretrain kernels disagree with their plain versions")

    out_err = {}
    b, s, h, d = PRETRAIN_SHAPE
    _, (q, k, v) = _qkv_views(b, s, h, d, g)
    do = rnd(b, s, h, d).bfloat16()
    out, got = _small_s_grads(fa, q, k, v, do)
    ref, lse = fa.small_s_attention_ref(q, k, v, d ** -0.5)
    refs = fa.small_s_attention_bwd_ref(q, k, v, ref, lse, do, d ** -0.5)
    torch.cuda.synchronize()
    rels = [_rel(x, r) for x, r in zip((out, *got), (ref, *refs))]
    errs = [(x.float() - r.float()).abs().max().item() for x, r in zip((out, *got), (ref, *refs))]
    print(f"K2 / K4b bf16 {PRETRAIN_SHAPE} strided qkv views: out/dq/dk/dv rel-L2 "
          + " / ".join(f"{r:.3e}" for r in rels) + " (bar 1e-2), max-abs "
          + " / ".join(f"{e:.3e}" for e in errs), flush=True)
    if not max(rels) <= 1e-2:
        raise AssertionError("bf16 small-S kernels disagree with their plain versions")
    out_err.update(small_s_fwd=errs[0], small_s_bwd_dq=errs[1], small_s_bwd_dkv=max(errs[2:]))
    del q, k, v, do, out, got, ref, lse, refs

    for b, s, h, d in (PRETRAIN_SHAPE, TEACHER_SHAPE):
        w = h * d
        qkv = (rnd(b, s, 3 * w) * 2).bfloat16()
        qw, kw = rnd(w) * 0.1 + 1, rnd(w) * 0.1 + 1
        fout = fa.fused_qkv_rmsnorm_attention(qkv, qw, kw, num_heads=h)
        q_rstd = torch.rsqrt(qkv[..., :w].float().square().mean(-1) + 1e-6)
        fref = fa.fused_qkv_ref(qkv, qw, kw, h, d ** -0.5)
        torch.cuda.synchronize()
        rel = _rel(fout, fref)
        err = (fout.float() - fref.float()).abs().max().item()
        print(f"K3 bf16 {(b, s, h, d)} (W {w}): out rel-L2 {rel:.3e} (bar 1e-2), max-abs "
              f"{err:.3e}; q 1/rms range {q_rstd.min().item():.3f}-{q_rstd.max().item():.3f}",
              flush=True)
        if not rel <= 1e-2:
            raise AssertionError(f"bf16 fused qkv kernel disagrees with its plain version at "
                                 f"{(b, s, h, d)}")
        out_err["fused_qkv_fwd" if s == PRETRAIN_SHAPE[1] else "fused_qkv_fwd_teacher"] = err
        del qkv, fout, fref
    b, s, h, d = PRETRAIN_SHAPE
    qkv = (rnd(2, s, 3 * h * d) * 2).bfloat16()
    qw, kw = rnd(h * d) * 0.1 + 1, rnd(h * d) * 0.1 + 1
    do = rnd(2, s, h * d).bfloat16()
    _, fgot = _fused_grads(fa, qkv, qw, kw, h, do)
    _, frefs = _fused_ref_grads(fa, qkv, qw, kw, h, do)
    rels = [_rel(x, r) for x, r in zip(fgot, frefs)]
    print(f"K3 backward (unfused composition through K2 / K4b) bf16 (2, {s}, {h}, {d}): "
          f"qkv/qw/kw grads rel-L2 " + " / ".join(f"{r:.3e}" for r in rels) + " (bar 2e-2)",
          flush=True)
    if not max(rels) <= 2e-2:
        raise AssertionError("bf16 fused qkv gradients disagree with the plain composition")
    return out_err


def _pretrain_want(fa, steps: int) -> dict:
    """Launches of each kernel in `steps` pretrain steps at the 1B recipe."""
    per_step = {"fused_qkv_fwd": 2 * DEPTH_1B + 48, "fused_qkv_rstd": 2 * DEPTH_1B + 48,
                "small_s_fwd": DEPTH_1B, "small_s_bwd_dq": DEPTH_1B,
                "small_s_bwd_dkv": DEPTH_1B, "flash_fwd": 40}
    return {n: per_step.get(n, 0) * steps for n in fa.KERNELS}


def run_pretrain_path(fa, card) -> dict:
    """Phase 12; returns the launches of each kernel in the main-path run."""
    from internvideo_tpu_torch.cli import train as cli

    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fa.reset_launch_count()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--config", CONFIG_PRETRAIN, "--device", "cuda",
                       f"trainer.total_steps={PRETRAIN_STEPS}", "trainer.log_every=1",
                       "trainer.checkpoint_dir=None"])
    torch.cuda.synchronize()
    launches = {name: fa.launch_count(name) for name in fa.KERNELS}
    wall = time.perf_counter() - t0
    records = [dict(kv.split(": ") for kv in line.split("  "))
               for line in buf.getvalue().splitlines() if line.startswith("step: ")]
    for r in records:
        print(f"cli.train {CONFIG_PRETRAIN}: {r}", flush=True)
    print(f"[{card}] main path (pretrain): {PRETRAIN_STEPS} steps in {wall:.1f} s wall incl. "
          f"model and teacher init and host data; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {launches}", flush=True)
    if rc != 0 or len(records) != PRETRAIN_STEPS:
        raise AssertionError(f"cli.train logged {len(records)} of {PRETRAIN_STEPS} steps")
    keys = ("loss", "loss_clip_middle", "loss_clip_final", "loss_mae", "grad_norm")
    if not all(math.isfinite(float(r[k])) for r in records for k in keys):
        raise AssertionError("non-finite loss, loss term or grad_norm on the pretrain path")
    want = _pretrain_want(fa, PRETRAIN_STEPS)
    if launches != want:
        raise AssertionError(f"launches {launches} on the pretrain main path; expected {want} "
                             "(per step: 128 K3 = 40 student + 40 remat + 48 CLIP teacher, "
                             "40 K2 / K4b dq / K4b dk/dv, 40 K1 for the MAE teacher)")
    return launches


def _pretrain_models(run, td_frames: int):
    """The recipe's student (drop-path off, gammas 0.1) and frozen teachers."""
    from internvideo_tpu_torch.models.pretrain import PretrainInternVideo2
    from internvideo_tpu_torch.models.teachers import CLIPTeacher, MAETeacher
    from internvideo_tpu_torch.train.state import frozen_teacher

    gen = lambda s: torch.Generator("cuda").manual_seed(s)  # noqa: E731
    cfg = dataclasses.replace(run.model, encoder=dataclasses.replace(
        run.model.encoder, drop_path_rate=0.0))
    student = PretrainInternVideo2(cfg, device="cuda", generator=gen(0))
    _raise_gammas(student)
    clip_t = frozen_teacher(CLIPTeacher(run.teacher, device="cuda", generator=gen(1)))
    mae_t = frozen_teacher(MAETeacher(run.mae_teacher, num_frames=td_frames, device="cuda",
                                      generator=gen(2)))
    return student, clip_t, mae_t


def check_pretrain_routes(run) -> None:
    """Phase 13."""
    from internvideo_tpu_torch.train.engines.pretrain import draw_keep_indices, pretrain_loss

    enc, eng = run.model.encoder, run.engine
    t_full = enc.num_frames * eng.td_ratio
    student, clip_t, mae_t = _pretrain_models(run, t_full)
    g = torch.Generator("cuda").manual_seed(8)
    video = torch.randn(2, t_full, enc.img_size, enc.img_size, 3, device="cuda", generator=g)
    teach = {}
    for impl in ("kernel", "plain"):
        for m in (student, clip_t, mae_t):
            _set_attn_impl(m, impl)
        with torch.no_grad():
            teach[impl] = (*clip_t(video[:, ::eng.td_ratio]), mae_t(video))
    rels = {n: _rel(k, p) for n, k, p in zip(("clip z", "clip pooled", "clip attn", "mae z"),
                                             teach["kernel"], teach["plain"])}
    # 2e-2, the grads' bar: the 48-block bf16 CLIP tower carries each
    # layer's rounding differences (~2e-3 per K3 call, phase 11) forward
    print("pretrain teachers B=2, kernel vs plain route: rel-L2 "
          + ", ".join(f"{n} {r:.3e}" for n, r in rels.items()) + " (bar 2e-2)", flush=True)
    if not max(rels.values()) <= 2e-2:
        raise AssertionError("teacher routes disagree")
    keep = draw_keep_indices(eng, g, teach["kernel"][2], 2, enc.num_frames // enc.tubelet_size)
    del teach

    names = [f"encoder.blocks.{i}.attn.{w}.weight" for i in (0, DEPTH_1B - 1)
             for w in ("qkv", "q_norm")] + ["clip_decoder.0.head.weight"]
    res = {}
    for impl in ("kernel", "plain"):
        for m in (student, clip_t, mae_t):
            _set_attn_impl(m, impl)
        student.zero_grad(set_to_none=True)
        loss, _, _ = pretrain_loss(student, clip_t, mae_t, eng, video, keep=keep,
                                   deterministic=True)
        loss.backward()
        params = dict(student.named_parameters())
        res[impl] = (loss.item(), {n: params[n].grad.detach().clone() for n in names})
    (lk, gk), (lp, gp) = res["kernel"], res["plain"]
    rel_loss = abs(lk - lp) / abs(lp)
    grels = {n: _rel(gk[n], gp[n]) for n in names}
    print(f"pretrain bf16 full widths B=2 (same keep indices), kernel vs plain route: loss "
          f"{lk:.6f} / {lp:.6f} (rel {rel_loss:.3e}, bar 1e-2); grad rel-L2 "
          + ", ".join(f"{n} {r:.3e}" for n, r in grels.items()) + " (bar 2e-2)", flush=True)
    if not (math.isfinite(lk) and rel_loss <= 1e-2 and max(grels.values()) <= 2e-2):
        raise AssertionError("pretrain routes disagree")


def _sdpa_fwd_ms(q, k, v) -> float:
    """torch's flash SDPA forward on (B, S, H, D) inputs (yardstick only)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return _time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=10, warmup=2)


def _sdpa_bwd_ms(q, k, v, do) -> float:
    """torch's flash SDPA backward alone (the aten op) (yardstick only)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v, do = (x.transpose(1, 2) for x in (q, k, v, do))
    aten = torch.ops.aten
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        r = aten._scaled_dot_product_flash_attention(q, k, v, 0.0, False, False)
        return _time_ms(lambda: aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, r[0], r[1], r[2], r[3], r[4], r[5], 0.0, False, r[6], r[7]),
            iters=10, warmup=2)


def time_pretrain_kernels(fa, card) -> dict:
    """Phase 14, kernels: ms, plain ms, bound and SDPA yardstick of each new
    kernel at its path shape."""
    from internvideo_tpu_torch.ops import _build
    from internvideo_tpu_torch.ops.rmsnorm import rms_norm

    lib = _build.load_library()
    g = torch.Generator("cuda").manual_seed(9)
    res = {}
    b, s, h, d = PRETRAIN_SHAPE
    scale = d ** -0.5
    _, (q, k, v) = _qkv_views(b, s, h, d, g)
    do = torch.randn(b, s, h, d, device="cuda", generator=g).bfloat16()
    with torch.no_grad():
        out, lse = fa._flash_fwd_cuda(q, k, v, scale, kernel="small_s_fwd")
        delta = fa._bwd_delta(out, do)
        dq, dk, dv = (torch.empty(x.shape, dtype=x.dtype, device="cuda") for x in (q, k, v))
        res["small_s_fwd"] = dict(
            ms=_time_ms(lambda: fa._flash_fwd_cuda(q, k, v, scale, kernel="small_s_fwd"),
                        iters=20, warmup=2),
            plain_ms=_time_ms(lambda: fa.small_s_attention_ref(q, k, v, scale), iters=2),
            library_ms=_sdpa_fwd_ms(q, k, v))
        plain_bwd = _time_ms(lambda: fa.small_s_attention_bwd_ref(q, k, v, out, lse, do, scale),
                             iters=2)
        sdpa_bwd = _sdpa_bwd_ms(q, k, v, do)
        for name, outs in (("small_s_bwd_dq", (dq,)), ("small_s_bwd_dkv", (dk, dv))):
            res[name] = dict(
                ms=_time_ms(lambda: fa._launch_bwd(name, q, k, v, do, lse, delta, outs, scale),
                            iters=20, warmup=2),
                plain_ms=plain_bwd, library_ms=sdpa_bwd)
    io_bytes = 4 * b * s * h * d * 2 + 2 * b * h * s * 4  # q, k, v, dO; lse, delta
    res["small_s_fwd"]["bound"] = _bound(4 * b * h * s * s * d, 4 * b * s * h * d * 2 + b * h * s * 4)
    res["small_s_bwd_dq"]["bound"] = _bound(6 * b * h * s * s * d, io_bytes + b * s * h * d * 2)
    res["small_s_bwd_dkv"]["bound"] = _bound(8 * b * h * s * s * d,
                                             io_bytes + 2 * b * s * h * d * 2)
    del q, k, v, do, out, lse, delta, dq, dk, dv

    for tag, (b, s, h, d) in (("student", PRETRAIN_SHAPE), ("teacher", TEACHER_SHAPE)):
        w = h * d
        qkv = (torch.randn(b, s, 3 * w, device="cuda", generator=g) * 2).bfloat16()
        qw, kw = (torch.randn(w, device="cuda", generator=g) * 0.1 + 1 for _ in range(2))
        q_rstd, k_rstd = (torch.empty(b, s, device="cuda") for _ in range(2))
        stream = torch.cuda.current_stream().cuda_stream

        def rstd():
            lib.ivt_fused_qkv_rstd(1, qkv.data_ptr(), q_rstd.data_ptr(), k_rstd.data_ptr(),
                                   b, s, w, qkv.stride(0), qkv.stride(1), 1e-6, stream)

        def rstd_plain():
            return [torch.rsqrt(qkv[..., i * w:(i + 1) * w].float().square().mean(-1) + 1e-6)
                    for i in (0, 1)]

        with torch.no_grad():
            op_ms = _time_ms(lambda: fa._fused_qkv_cuda(qkv, qw, kw, h, d ** -0.5, 1e-6),
                             iters=10, warmup=2)
            rstd_ms = _time_ms(rstd, iters=20, warmup=2)
            rstd_plain_ms = _time_ms(rstd_plain, iters=5)
            ref_q, ref_k = rstd_plain()
            rstd_err = max((q_rstd - ref_q).abs().max().item(), (k_rstd - ref_k).abs().max().item())
            plain_ms = _time_ms(lambda: fa.fused_qkv_ref(qkv, qw, kw, h, d ** -0.5), iters=1)
            qn = rms_norm(qkv[..., :w], qw).unflatten(-1, (h, d))
            kn = rms_norm(qkv[..., w:2 * w], kw).unflatten(-1, (h, d))
            lib_ms = _sdpa_fwd_ms(qn, kn, qkv[..., 2 * w:].unflatten(-1, (h, d)))
        qkv_bytes, rows = 3 * b * s * w * 2, 2 * b * s * 4
        res[f"fused_qkv_{tag}"] = dict(
            ms=op_ms, attn_ms=op_ms - rstd_ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound=_bound(4 * b * h * s * s * d, qkv_bytes + b * s * w * 2 + 2 * w * 4))
        res[f"fused_qkv_rstd_{tag}"] = dict(
            ms=rstd_ms, plain_ms=rstd_plain_ms, library_ms=None, err=rstd_err,
            bound=_bound(0, 2 * b * s * w * 2 + rows))
        del qkv, qn, kn, q_rstd, k_rstd
    for name, r in res.items():
        print(f"[{card}] {name}: kernel {r['ms']:.3f} ms, bound {r['bound'][0]:.3f} ms "
              f"({r['bound'][1]}), plain {r['plain_ms']:.3f} ms, SDPA yardstick "
              + (f"{r['library_ms']:.3f} ms" if r["library_ms"] is not None else "n/a"),
              flush=True)
    return res


def time_pretrain_step(fa, run, card) -> dict:
    """Phase 14, step: the pretrain step at B = 32 on a device-resident batch,
    split into the two teachers and the student's part; then one step under
    torch.profiler."""
    from internvideo_tpu_torch.cli import train as cli

    trainer, shape, (clip_t, mae_t) = cli.build_pretrain(dataclasses.replace(
        run, trainer=dataclasses.replace(run.trainer, checkpoint_dir=None)), torch.device("cuda"))
    g = torch.Generator("cuda").manual_seed(10)
    batch = {"video": torch.randn(*shape, device="cuda", generator=g)}
    step_ms = _time_ms(lambda: trainer._step(trainer.state, batch), iters=2, warmup=1)
    sv = batch["video"][:, ::run.engine.td_ratio]
    with torch.no_grad():
        clip_ms = _time_ms(lambda: clip_t(sv), iters=2, warmup=1)
        mae_ms = _time_ms(lambda: mae_t(batch["video"]), iters=2, warmup=1)
    b = shape[0]
    print(f"[{card}] InternVideo2-1B UMT pretrain step 16x224 (S = 833) + CLIP-6B + MAE-g14 "
          f"teachers bf16 B={b}, device-resident batch: {step_ms:.1f} ms = "
          f"{b * 1e3 / step_ms:.2f} clips/s; CLIP teacher {clip_ms:.1f} ms, MAE teacher "
          f"{mae_ms:.1f} ms, student forward + backward + update (the rest) "
          f"{step_ms - clip_ms - mae_ms:.1f} ms", flush=True)
    profile_step(lambda: trainer._step(trainer.state, batch), card, "pretrain step")
    return {"step_ms": step_ms, "clip_ms": clip_ms, "mae_ms": mae_ms}


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from internvideo_tpu_torch.core.config import load_config
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2
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
    _raise_gammas(model)
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
    del run
    gc.collect()
    torch.cuda.empty_cache()

    # 11. the pretrain kernels vs their plain versions
    pre_err = check_pretrain_kernels(fa)
    gc.collect()
    torch.cuda.empty_cache()

    # 12. the pretrain main path, counting launches
    pre_launches = run_pretrain_path(fa, card)
    gc.collect()
    torch.cuda.empty_cache()

    # 13. kernel route vs plain route in pretraining
    prun = load_config(CONFIG_PRETRAIN)
    check_pretrain_routes(prun)
    gc.collect()
    torch.cuda.empty_cache()

    # 14. times
    pk = time_pretrain_kernels(fa, card)
    gc.collect()
    torch.cuda.empty_cache()
    time_pretrain_step(fa, prun, card)

    b, s, h, d = MAIN_SHAPE
    fwd_bound = _bound(4 * b * h * s * s * d, (4 * b * s * h * d) * 2 + b * h * s * 4)
    b, s, h, d = TRAIN_SHAPE
    io_bytes = 4 * b * s * h * d * 2 + 2 * b * h * s * 4  # q, k, v, dO; lse, delta
    bounds = {"flash_bwd_dq": _bound(6 * b * h * s * s * d, io_bytes + b * s * h * d * 2),
              "flash_bwd_dkv": _bound(8 * b * h * s * s * d, io_bytes + 2 * b * s * h * d * 2)}
    src = "internvideo_tpu_torch/csrc/"
    jax_fa = "internvideo_tpu/ops/flash_attention.py:"

    def by_path(name, eval_n=0):
        return {"eval": eval_n, "train": train_launches[name], "pretrain": pre_launches[name]}

    def entry(name, source, line, r, err, shape):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": jax_fa + str(line), "launches": pre_launches[name],
                "launches_by_path": by_path(name), "max_abs_err": err, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": r["library_ms"], "shape": list(shape)}

    kernels = [{
        "name": "flash_fwd", "route": "cuda", "source": src + "flash_fwd.cu",
        "replaces": jax_fa + "153",
        "launches": launches + train_launches["flash_fwd"] + pre_launches["flash_fwd"],
        "launches_by_path": by_path("flash_fwd", launches),
        "max_abs_err": max_abs, "ms": kern_ms, "plain_ms": plain_ms,
        "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
        "library_ms": t["sdpa"]["eval"]["fwd"], "shape": list(MAIN_SHAPE),
    }] + [{
        "name": name, "route": "cuda", "source": src + "flash_bwd.cu",
        "replaces": jax_fa + str(line),
        "launches": train_launches[name], "launches_by_path": by_path(name),
        "max_abs_err": bwd_err[name], "ms": t[name], "plain_ms": t["plain_bwd"],
        "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
        "library_ms": t["sdpa"]["train"]["bwd"], "shape": list(TRAIN_SHAPE),
    } for name, line in (("flash_bwd_dq", 468), ("flash_bwd_dkv", 613))] + [
        entry("small_s_fwd", "small_s_fwd.cu", 1505, pk["small_s_fwd"],
              pre_err["small_s_fwd"], PRETRAIN_SHAPE),
        entry("small_s_bwd_dq", "small_s_bwd.cu", 1524, pk["small_s_bwd_dq"],
              pre_err["small_s_bwd_dq"], PRETRAIN_SHAPE),
        entry("small_s_bwd_dkv", "small_s_bwd.cu", 1553, pk["small_s_bwd_dkv"],
              pre_err["small_s_bwd_dkv"], PRETRAIN_SHAPE),
        {**entry("fused_qkv_fwd", "fused_qkv.cu", 1703, pk["fused_qkv_student"],
                 pre_err["fused_qkv_fwd"], PRETRAIN_SHAPE),
         "attn_kernel_ms": pk["fused_qkv_student"]["attn_ms"],
         "teacher": {"shape": list(TEACHER_SHAPE), "ms": pk["fused_qkv_teacher"]["ms"],
                     "attn_kernel_ms": pk["fused_qkv_teacher"]["attn_ms"],
                     "plain_ms": pk["fused_qkv_teacher"]["plain_ms"],
                     "bound_ms": pk["fused_qkv_teacher"]["bound"][0],
                     "bound_by": pk["fused_qkv_teacher"]["bound"][1],
                     "library_ms": pk["fused_qkv_teacher"]["library_ms"],
                     "max_abs_err": pre_err["fused_qkv_fwd_teacher"]}},
        {**entry("fused_qkv_rstd", "fused_qkv.cu", 1703, pk["fused_qkv_rstd_student"],
                 pk["fused_qkv_rstd_student"]["err"], PRETRAIN_SHAPE),
         "teacher": {"shape": list(TEACHER_SHAPE), "ms": pk["fused_qkv_rstd_teacher"]["ms"],
                     "plain_ms": pk["fused_qkv_rstd_teacher"]["plain_ms"],
                     "max_abs_err": pk["fused_qkv_rstd_teacher"]["err"],
                     "bound_ms": pk["fused_qkv_rstd_teacher"]["bound"][0],
                     "bound_by": pk["fused_qkv_rstd_teacher"]["bound"][1]}},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
