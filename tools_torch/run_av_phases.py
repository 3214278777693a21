#!/usr/bin/env python3
"""chip_smoke.py's audio-visual stage-2 phases alone, on one card.

    python3 tools_torch/run_av_phases.py

Builds the kernel library, then runs chip_smoke's phases 60-65 in order:
the fusion cross-attention at the audio-visual shapes (K1 / K4a at Sk
1277, K2 / K4b at Sk 252) and the simple tower's K2 / K4b against their
plain versions and timed; task clip_av through the train CLI on
configs/torch/clip_av_stage2_1b.py with its launch counts; the step of
each media type (launches, ms, peak memory, device time by group, the
audio tower's share); the real-audio path (wavs -> load_fbank ->
prefetch_to_device -> steps); kernel route vs plain route per media type;
the simple tower's audio step. Prints each phase's wall seconds and "av
phases ok" at the end; any failure raises. Needs one CUDA card; nothing
here imports JAX.
"""

import gc
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from internvideo_tpu_torch.core.config import load_config  # noqa: E402
from internvideo_tpu_torch.ops import _build  # noqa: E402
from internvideo_tpu_torch.ops import flash_attention as fa  # noqa: E402
from internvideo_tpu_torch.ops import int8_gemm as ig  # noqa: E402
from internvideo_tpu_torch.ops import paged_decode as pd  # noqa: E402
from internvideo_tpu_torch.ops import rmsnorm as rms  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("run_av_phases: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build()
    _build.load_library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    card = cs._card()
    print(card, flush=True)

    def timed(label, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{label} {time.perf_counter() - t:.1f} s", flush=True)
        return out

    timed("phase 60 (check)", cs.check_av_kernels, fa)
    timed("phase 60 (times)", cs.time_av_kernels, fa, card)
    timed("phase 61", cs.run_clip_av_path, fa, pd, ig, rms, card)
    run = load_config(cs.CONFIG_AV)
    _, trainer = timed("phase 62", cs.time_clip_av_steps, fa, pd, ig, rms, run, card)
    timed("phase 63", cs.run_av_real_audio_path, trainer, run, card)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    timed("phase 64", cs.check_clip_av_routes, run)
    timed("phase 65", cs.run_simple_tower_step, fa, pd, ig, rms, run, card)
    print("av phases ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
