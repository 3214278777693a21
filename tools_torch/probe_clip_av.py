#!/usr/bin/env python3
"""Where the audio-visual stage-2 step's time goes, on one card.

    python3 tools_torch/probe_clip_av.py

On configs/torch/clip_av_stage2_1b.py's BEATs tower at B 64 (998 x 64
fbanks): the tower's forward + backward, its grouped position conv's and
one layer's alone (CUDA events), then the top device kernels of one
forward + backward under torch.profiler; then, with the kernels built, the
full audio_video step at B 64 on a device-resident batch: three steps'
wall times, the caching allocator's retries and device allocations over
them, peak memory, chip_smoke's `profile_step` (device activity) with its
own wall cost, and the top device kernels and host ops of one step traced
with host ops on, with that trace's wall cost.
Needs one CUDA card; nothing here imports JAX.
"""

import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from internvideo_tpu_torch.core.config import load_config  # noqa: E402
from internvideo_tpu_torch.models.beats import BEATsEncoder  # noqa: E402
from internvideo_tpu_torch.ops import _build  # noqa: E402


def _top(prof, n: int, cpu: bool = False) -> None:
    """The `n` largest self device (or, with `cpu`, host) times by name."""
    attr = "self_cpu_time_total" if cpu else "self_device_time_total"
    rows = sorted(((e.key, getattr(e, attr) / 1e3, e.count) for e in prof.key_averages()
                   if cpu or e.self_device_time_total > 0), key=lambda r: -r[1])
    for k, t, c in rows[:n]:
        print(f"  {'cpu ' if cpu else ''}{t:9.2f} ms  {c:6d}  {k[:150]}", flush=True)


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs._card()
    run = load_config(cs.CONFIG_AV)
    enc = BEATsEncoder(run.model.beats, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(0))
    audio = torch.randn(64, 998, 64, device="cuda")

    def fb():
        t, p = enc(audio)
        (t.float().mean() + p.float().mean()).backward()

    print("beats fwd+bwd ms", cs._time_ms(fb, iters=3, warmup=1), flush=True)
    x = torch.randn(64, 252, 768, device="cuda", dtype=torch.bfloat16, requires_grad=True)

    def posconv():
        enc.pos_conv(x.transpose(1, 2)).float().sum().backward()

    def layer0():
        enc.layers[0](x)[0].float().sum().backward()

    def layer1():
        enc.layers[1](x, enc.layers[0].self_attn.position_bias(252))[0].float().sum().backward()

    for name, fn in (("pos_conv fwd+bwd", posconv), ("layer 0 fwd+bwd", layer0),
                     ("layer 1 fwd+bwd", layer1)):
        print(name, "ms", cs._time_ms(fn, iters=3, warmup=1), flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fb()
        torch.cuda.synchronize()
    _top(prof, 25)
    del enc, x
    torch.cuda.empty_cache()

    _build.build()
    _build.load_library()
    from internvideo_tpu_torch.cli import train as cli

    trainer, _ = cli.build_clip_av(dataclasses.replace(
        run, trainer=dataclasses.replace(run.trainer, checkpoint_dir=None)), torch.device("cuda"))
    batch = cs._av_batch(run, 64, 62)
    step = lambda: trainer._step(trainer.state, batch)  # noqa: E731
    step()
    torch.cuda.synchronize()
    s0 = torch.cuda.memory_stats()
    for _ in range(3):
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        print("AV step wall ms", (time.perf_counter() - t) * 1e3, flush=True)
    s1 = torch.cuda.memory_stats()
    print("alloc retries", s0.get("num_alloc_retries"), s1.get("num_alloc_retries"),
          "cudaMalloc", s0.get("num_device_alloc"), s1.get("num_device_alloc"), "peak",
          torch.cuda.max_memory_allocated() / 1e9, flush=True)
    t = time.perf_counter()
    cs.profile_step(step, card, "AV step")
    print("profile_step total s", time.perf_counter() - t, flush=True)
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    _top(prof, 30)
    _top(prof, 15, cpu=True)
    print("host + device traced profile, summarised, total s", time.perf_counter() - t,
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
