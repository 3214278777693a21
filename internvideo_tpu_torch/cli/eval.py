"""Evaluation CLI of the PyTorch port.

    python -m internvideo_tpu_torch.cli.eval \
        --config configs/torch/eval_classification_1b.py --device cuda

Port of internvideo_tpu/cli/eval.py. The config file defines
`config = EvalRunConfig(...)`; dotlist overrides follow. Only the
`classification` task is ported (encoder multi-view softmax ensemble ->
top-1/top-5); the JAX CLI's other tasks exit with "not yet ported".
`--device` is explicit: `cuda` (the default) with no GPU is an error, not a
CPU run. `checkpoint=None` means the seeded init; loading a checkpoint is
not ported yet (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Callable, Optional

import numpy as np
import torch

# The JAX CLI's task names (internvideo_tpu/cli/eval.py:329-340).
_JAX_TASKS = (
    "retrieval", "zeroshot", "classification", "mcqa", "videoqa",
    "mcq_benchmark", "grounding", "temporal_detection", "openset",
    "spatiotemporal",
)


@dataclasses.dataclass(frozen=True)
class EvalRunConfig:
    task: str = "retrieval"
    model: object = None  # task-appropriate model config
    checkpoint: Optional[str] = None  # None = seeded init
    data: Optional[Callable] = None  # () -> task inputs
    options: dict = dataclasses.field(default_factory=dict)


def run_classification(run: EvalRunConfig, device: torch.device) -> dict:
    from internvideo_tpu_torch.eval.classification import final_test
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2

    if run.checkpoint is not None:
        raise NotImplementedError(
            "checkpoint loading is not ported yet (ROADMAP queue 1, item 9)")
    model = InternVideo2(
        run.model, device=device,
        generator=torch.Generator(device=device).manual_seed(0),
    ).eval()

    @torch.inference_mode()
    def forward(video: np.ndarray) -> torch.Tensor:
        return model(torch.as_tensor(video, device=device)).logits

    return final_test(forward, run.data(), **run.options)


TASKS = {"classification": run_classification}


def main(argv=None):
    from internvideo_tpu_torch.core.config import apply_overrides, load_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    run = load_config(args.config)
    if args.overrides:
        run = apply_overrides(run, args.overrides)
    if run.task not in TASKS:
        if run.task in _JAX_TASKS:
            raise SystemExit(f"task {run.task!r} is not yet ported; "
                             f"ported: {list(TASKS)}")
        raise SystemExit(f"unknown task {run.task!r}; one of {list(TASKS)}")
    metrics = TASKS[run.task](run, device)
    print(json.dumps({"task": run.task, **{
        k: (round(float(v), 4) if hasattr(v, "__float__") else v)
        for k, v in metrics.items()
    }}))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
