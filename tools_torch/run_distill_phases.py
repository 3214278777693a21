#!/usr/bin/env python3
"""chip_smoke.py's distill and data-layer phases alone, on one card.

    python3 tools_torch/run_distill_phases.py

Builds the kernel library, then runs chip_smoke's phases 53-59 in order:
K3 and K2 / K4b at the distill student's head dim 64 against their plain
versions and timed; task distill through the train CLI on
configs/torch/distill_l14_1b.py with its launch counts; kernel route vs
plain route of the distill loss; the distill step's time, teacher share,
peak memory and idle share; the jsonl SFT path (its launch counts, the
host's ms a batch, the step fed by prefetch_to_device, K5 + K8 on a real
pack); prefetch_to_device's bytes and GB/s. Prints each phase's wall
seconds and "distill phases ok" at the end; any failure raises. Needs one
CUDA card; nothing here imports JAX.
"""

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
        raise SystemExit("run_distill_phases: needs a CUDA card")
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
        print(f"{label} {time.perf_counter() - t:.1f} s", flush=True)
        return out

    timed("phase 53", cs.check_distill_kernels, fa)
    timed("phase 54", cs.time_distill_kernels, fa, card)
    timed("phase 55", cs.run_distill_path, fa, pd, ig, rms, card)
    run = load_config(cs.CONFIG_DISTILL)
    timed("phase 56", cs.check_distill_routes, run)
    timed("phase 57", cs.time_distill_step, fa, pd, ig, rms, run, card)
    timed("phase 58", cs.run_sft_jsonl_path, fa, pd, ig, rms, card)
    timed("phase 59", cs.check_prefetch, card)
    print("distill phases ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
