#!/usr/bin/env python3
"""chip_smoke.py's InternVideo2-Chat phases alone, on one card.

    python3 tools_torch/run_chat_phases.py

Builds the kernel library, then runs chip_smoke's phases 48-52 in order:
K1 / K2 / K5 at the chat shapes against their plain versions, task videoqa
through the eval CLI on configs/torch/chat_videoqa_8b.py with its launch
counts, kernel route vs plain route on the full-width VideoChat, the TTFT
split / decode / idle share / peak memory and the kernels' times, and task
zeroshot on internvideo2_stage2_1b. Prints each phase's wall seconds and
"chat phases ok" at the end; any failure raises. Needs one CUDA card;
nothing here imports JAX.
"""

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
        raise SystemExit("run_chat_phases: needs a CUDA card")
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

    timed("phase 48", cs.check_chat_kernels, fa)
    timed("phase 49", cs.run_chat_path, fa, pd, ig, rms, card)
    chat = cs._chat_model()
    timed("phase 50", cs.check_chat_routes, chat, card)
    timed("phase 51", cs.time_chat, chat, fa, card)
    del chat
    timed("phase 51 kernels", cs.time_chat_kernels, fa, card)
    timed("phase 52", cs.run_zeroshot_path, fa, pd, ig, rms, card)
    print("chat phases ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
