#!/usr/bin/env python3
"""The MoE expert backward before and after one unbind / split, on one card.

    python3 tools_torch/compare_moe_bwd.py

On intern_s1 at full width, vision 8 / text 8 layers (chip_smoke phase
80's model and packed batch, B 4 x 2048): first one forward + backward with
each `grouped_experts`, the gradients of the first and the last layer's
expert stacks, a vision weight and the loss held bit-identical; then the SFT
step through Trainer + make_sft_step with each, in turns (before, after,
after, before): per turn the step's ms (CUDA events, 2 steps after 1) and
one step under torch.profiler (device busy ms, the idle share, the
elementwise group's ms). "before" indexes each expert's weights and slices
each expert's rows, as `nn/moe.py:grouped_experts` did before; "after" is
the module's own. Prints one JSON line; any failure raises. Needs one CUDA
card; nothing here imports JAX.
"""

import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from internvideo_tpu_torch.nn import moe as moe_mod  # noqa: E402
from internvideo_tpu_torch.ops import _build  # noqa: E402


def grouped_experts_before(cfg, xs, sizes, w_gate, w_up, w_down, biases=None):
    """`grouped_experts` as it was: an index per expert weight and a slice
    per expert's rows."""
    parts, start = [], 0
    for ei, cnt in enumerate(sizes):
        if cnt == 0:
            continue
        rows = xs[start:start + cnt]
        start += cnt
        h, u = rows @ w_gate[ei], rows @ w_up[ei]
        if biases is not None:
            h, u = h + biases[0][ei], u + biases[1][ei]
        y = moe_mod.moe_act(cfg, h, u) @ w_down[ei]
        parts.append(y if biases is None else y + biases[2][ei])
    if not parts:
        return xs.new_zeros((0, w_down.shape[-1]))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


VERSIONS = {"before": grouped_experts_before, "after": moe_mod.grouped_experts}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("compare_moe_bwd: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    _build.load_library()
    card = cs._card()
    print(card, flush=True)
    depth = cs.INTERNVL_SFT_DEPTH
    model = cs._internvl(cs.PRESET_S1, vision_depth=depth, text_depth=depth)
    b, length = cs.INTERNVL_K5_SHAPE[:2]
    host = cs._internvl_sft_batch(model.config, b, length, 90)
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    names = [n for n, _ in model.named_parameters()
             if any(f"layers.{i}.mlp.w_" in n for i in (0, depth - 1))]
    names.append("vision_tower.blocks.0.attn.qkv.weight")
    grads = {}
    for tag, fn in VERSIONS.items():
        moe_mod.grouped_experts = fn
        grads[tag] = cs._internvl_loss_grads(model, batch, "kernel", names)
    same = all(torch.equal(grads["before"][1][n], grads["after"][1][n]) for n in names) and \
        torch.equal(grads["before"][0], grads["after"][0])
    print(f"gradients of {len(names)} weights and the loss bit-identical: {same}", flush=True)
    if not same:
        raise AssertionError("the two expert backwards give different gradients")
    del grads
    trainer = cs._internvl_sft_trainer(model, 1)
    dev = trainer.put_batch(host)
    step = lambda: trainer._step(trainer.state, dev)  # noqa: E731
    res = {tag: {"step_ms": [], "busy_ms": [], "elementwise_ms": [], "idle": []}
           for tag in VERSIONS}
    for tag in ("before", "after", "after", "before"):
        moe_mod.grouped_experts = VERSIONS[tag]
        ms = cs._time_ms(step, iters=2, warmup=1)
        prof = cs.profile_step(step, card, f"intern_s1 SFT step, expert backward {tag}")
        r, busy = res[tag], prof["busy_ms"]  # None when the profiler saw no device time
        r["step_ms"].append(ms)
        r["busy_ms"].append(busy)
        r["elementwise_ms"].append(prof["groups"].get("elementwise / reductions / copies"))
        r["idle"].append(None if busy is None else 1 - busy / prof["wall_ms"])
        print(f"[{card}] {tag}: step {ms:.1f} ms (CUDA events, 2 after 1), device busy "
              f"{busy} ms", flush=True)
    moe_mod.grouped_experts = VERSIONS["after"]
    for tag, r in res.items():
        r["median_step_ms"] = statistics.median(r["step_ms"])
    print(json.dumps({"card": card, "vision_depth": depth, "text_depth": depth,
                      "rows": b, "pack": length, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
