#!/usr/bin/env python3
"""chip_smoke.py's checkpoint phases alone, on one card.

    python3 tools_torch/run_checkpoint_phases.py

Builds the kernel library, then runs chip_smoke's phases 71-73 in order:
HF-layout round trips of qwen3_8b_mla and qwen3_8b_dense at full width and
text depth 4 (export, 1 GiB shards with an index, the generate CLI's
loader, greedy tokens equal to the writer's); a synthetic reference-layout
InternVideo2-1B checkpoint through `cli.eval` with `checkpoint=` (kernel
route held to an fp32 copy); that file cut to the distill teacher,
converted by tools/convert_cli to npz and loaded by `cli.train` with
`data.teacher_checkpoint=` for two distill steps. Prints each phase's wall
seconds and "checkpoint phases ok" at the end; any failure raises. Needs
one CUDA card; nothing here imports JAX.
"""

import gc
import sys
import tempfile
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
        raise SystemExit("run_checkpoint_phases: needs a CUDA card")
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

    timed("phase 71", cs.run_ckpt_llm_path, fa, pd, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as root:
        ev = timed("phase 72", cs.run_ckpt_eval_path, fa, root, card)
        timed("phase 73", cs.run_ckpt_distill_path, fa, pd, ig, rms, root, ev, card)
    print(f"checkpoint phases ok in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
