"""Training CLI of the PyTorch port.

    python -m internvideo_tpu_torch.cli.train \
        --config configs/torch/finetune_k400_1b.py --device cuda \
        trainer.total_steps=3 trainer.log_every=1 trainer.checkpoint_dir=None

Port of internvideo_tpu/cli/train.py. The config file defines
`config = RunConfig(...)`; dotlist overrides follow. Only the `finetune`
task is ported (InternVideo2 + mixup/cutmix + soft-target CE + AdamW with
layer decay); the JAX CLI's other tasks exit with "not yet ported".
`--device` is explicit: `cuda` (the default) with no GPU is an error, not a
CPU run. The model starts from the seeded init (`trainer.seed`) and the
data from `data["stream"]`, or synthetic clips made from a fixed seed.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch

from internvideo_tpu_torch.core.config import apply_overrides, config_to_dict, load_config
from internvideo_tpu_torch.train.trainer import Trainer, TrainerConfig

# The JAX CLI's task names (internvideo_tpu/cli/train.py:92-124).
_JAX_TASKS = ("finetune", "pretrain", "clip", "clip_av", "sft", "distill")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """The JAX RunConfig's fields that the ported task reads."""

    task: str = "finetune"
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    model: object = None  # task-specific model config
    data: object = None  # task-specific data config: batch_size, stream
    engine: object = None  # task-specific engine config


def build_finetune(run: RunConfig, device: torch.device):
    """(trainer, example batch shapes) for the finetune task on `device`."""
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2
    from internvideo_tpu_torch.train.engines.finetune import make_finetune_step

    model = InternVideo2(run.model, device=device,
                         generator=torch.Generator(device=device).manual_seed(run.trainer.seed))
    c, b = run.model, run.data["batch_size"]
    batch = {"video": (b, c.num_frames, c.img_size, c.img_size, 3), "label": (b,)}
    trainer = Trainer(
        run.trainer, model,
        lambda grad_accum=1: make_finetune_step(run.engine, grad_accum=grad_accum))
    return trainer, batch


def synthetic_stream(batch: dict, num_classes: int, seed: int = 0):
    """Endless batches of standard-normal clips and uniform labels, as
    numpy arrays made from `seed` (the JAX CLI's stream)."""
    rng = np.random.default_rng(seed)
    while True:
        yield {
            "video": rng.normal(size=batch["video"]).astype(np.float32),
            "label": rng.integers(0, num_classes, size=batch["label"]).astype(np.int32),
        }


def main(argv: Optional[list[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")

    run: RunConfig = load_config(args.config)
    run = apply_overrides(run, args.overrides)
    if run.task != "finetune":
        if run.task in _JAX_TASKS:
            raise SystemExit(f"task {run.task!r} is not yet ported; ported: ['finetune']")
        raise SystemExit(f"unknown task {run.task!r}")
    print("config:", config_to_dict(run.trainer))
    trainer, batch = build_finetune(run, device)
    data = run.data.get("stream") or synthetic_stream(batch, run.model.num_classes)
    trainer.fit(data)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
