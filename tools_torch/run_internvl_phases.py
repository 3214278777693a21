#!/usr/bin/env python3
"""chip_smoke.py's InternVL / Intern-S1 phases alone, on one card.

    python3 tools_torch/run_internvl_phases.py [--only a,b,c,d,e]

Builds the kernel library, prints the ptxas report of the slice's new
instantiations (K1 / K4a at d 128, K5's backward at (128, 64), bf16 and
fp32), then runs chip_smoke's phases 78-82 in order: (a) the new kernel
shapes against their plain versions, with their times, bounds and library
calls; (b) intern_s1's forward, vision uncut and text at 24 of 48 layers,
with its launch counts and the depth-2 / 2 route check; (c) three SFT steps
on intern_s1 at vision 8 / text 8 through Trainer + make_sft_step, with
the step's time, profile and the depth-2 / 2 route check; (d)
intern_s1_mini's forward uncut; (e) the convert CLI's internvl and
internvit kinds on synthetic HF-layout checkpoints, loaded back bit for
bit. A spill in a new bf16 instantiation raises, as in chip_smoke. Prints
each phase's wall seconds, then one JSON line; any failure raises. Needs
one CUDA card; nothing here imports JAX.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from internvideo_tpu_torch.ops import _build  # noqa: E402
from internvideo_tpu_torch.ops import flash_attention as fa  # noqa: E402
from internvideo_tpu_torch.ops import paged_decode as pd  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="a,b,c,d,e")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("run_internvl_phases: needs a CUDA card")
    only = set(args.only.split(","))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    card = cs._card()
    print(card, flush=True)
    ptxas = cs._ptxas_internvl(lib.with_suffix(".log").read_text())
    for k, v in ptxas.items():
        print(f"ptxas, {k}: {v['registers']} registers, {v['spill_stores']} / "
              f"{v['spill_loads']} bytes spilled (stores / loads)", flush=True)
    out = {"card": card, "ptxas": ptxas}

    def timed(label, fn, *a, **kw):
        t = time.perf_counter()
        r = fn(*a, **kw)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{label} {time.perf_counter() - t:.1f} s", flush=True)
        return r

    if "a" in only:
        out["phase_78"] = timed("phase 78 (a)", cs.check_internvl_kernels, fa, card)
    if "b" in only:
        out["phase_79"] = timed("phase 79 (b)", cs.run_internvl_forward, fa, pd, card)
        out["phase_79_routes"] = timed("phase 79 (b, routes)", cs.check_internvl_routes, fa,
                                       card)
    if "c" in only:
        out["phase_80"] = timed("phase 80 (c)", cs.run_internvl_sft, fa, pd, card)
        out["phase_80_routes"] = timed("phase 80 (c, routes)", cs.check_internvl_sft_routes,
                                       fa, card)
    if "d" in only:
        out["phase_81"] = timed("phase 81 (d)", cs.run_internvl_mini, fa, pd, card)
    if "e" in only:
        out["phase_82"] = timed("phase 82 (e)", cs.run_internvl_checkpoint, fa, pd, card)
    print(f"InternVL phases ok in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
