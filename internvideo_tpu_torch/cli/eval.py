"""Evaluation CLI of the PyTorch port.

    python -m internvideo_tpu_torch.cli.eval \
        --config configs/torch/eval_classification_1b.py --device cuda

Port of internvideo_tpu/cli/eval.py. The config file defines
`config = EvalRunConfig(...)`; dotlist overrides follow. Two tasks are
ported: `classification` (encoder multi-view softmax ensemble ->
top-1/top-5) and `retrieval` (VideoCLIP ITC + the cross-encoder ITM rerank
-> R@K / mdR / meanR; `options.no_rerank` skips the rerank); the JAX CLI's
other tasks exit with "not yet ported".
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


def run_retrieval(run: EvalRunConfig, device: torch.device) -> dict:
    """`run.data()` -> (videos {"video"}, texts {"input_ids",
    "attention_mask"}, gt text ids per video, gt video id per text), as
    internvideo_tpu/cli/eval.py:71-129."""
    from internvideo_tpu_torch.eval.retrieval import itm_eval, retrieval_evaluation
    from internvideo_tpu_torch.models.videoclip import VideoCLIP

    if run.checkpoint is not None:
        raise NotImplementedError(
            "checkpoint loading is not ported yet (ROADMAP queue 1, item 9)")
    model = VideoCLIP(
        run.model, device=device,
        generator=torch.Generator(device=device).manual_seed(0),
    ).eval()
    videos, texts, gt_v, gt_t = run.data()

    def tensor(x):
        return torch.as_tensor(np.asarray(x), device=device)

    @torch.inference_mode()
    def encode_video(batch):
        tokens, pooled, _, _ = model.encode_vision(tensor(batch["video"]))
        return tokens, model.vision_proj(pooled)

    @torch.inference_mode()
    def encode_text(batch):
        tokens, pooled = model.encode_text(tensor(batch["input_ids"]),
                                           tensor(batch["attention_mask"]))
        return tokens, model.text_proj(pooled)

    @torch.inference_mode()
    def rerank(vis_embeds, txt_embeds, txt_mask):
        fused = model.fusion(txt_embeds, tensor(txt_mask), vis_embeds)
        logits = model.itm_logits(fused.pooled)
        return logits[:, 1] - logits[:, 0]

    opts = dict(run.options)
    s_v2t, s_t2v = retrieval_evaluation(
        encode_video=encode_video, encode_text=encode_text,
        rerank_score=None if opts.pop("no_rerank", False) else rerank,
        videos=videos, texts=texts, **opts,
    )
    return itm_eval(s_v2t, s_t2v, gt_v, gt_t)


TASKS = {"classification": run_classification, "retrieval": run_retrieval}


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
