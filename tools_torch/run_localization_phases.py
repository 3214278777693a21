#!/usr/bin/env python3
"""chip_smoke.py's action-localization phases alone, on one card.

    python3 tools_torch/run_localization_phases.py

Builds the kernel library, then runs chip_smoke's phases 66-70 in order:
K5 + K8 non-causal with window 10 and pads at segment id -2 at
ActionFormer's six level shapes against the plain versions, and their fp32
times; ActionFormer at configs/torch/actionformer_thumos.py, kernel route vs
plain route; the ActionFormer main path (train steps, padded inference,
decode, the C++ NMS built into build/, mAP) with its launch counts and
times; the STAL head at configs/torch/stal_ava.py; the eval CLI's
temporal_detection / openset / spatiotemporal tasks on the card against the
CPU. Prints each phase's wall seconds and "localization phases ok" at the
end; any failure raises. Needs one CUDA card; nothing here imports JAX.
"""

import gc
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from internvideo_tpu_torch.ops import _build  # noqa: E402
from internvideo_tpu_torch.ops import flash_attention as fa  # noqa: E402
from internvideo_tpu_torch.ops import int8_gemm as ig  # noqa: E402
from internvideo_tpu_torch.ops import paged_decode as pd  # noqa: E402
from internvideo_tpu_torch.ops import rmsnorm as rms  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("run_localization_phases: needs a CUDA card")
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

    timed("phase 66 (check)", cs.check_actionformer_kernels, fa)
    timed("phase 66 (times)", cs.time_actionformer_kernels, fa, card)
    timed("phase 67", cs.check_actionformer_routes, fa)
    timed("phase 68", cs.run_actionformer_path, fa, pd, ig, rms, card)
    timed("phase 69", cs.run_stal_path, fa, pd, ig, rms, card)
    timed("phase 70", cs.run_localization_cli, card)
    print(f"localization phases ok in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
