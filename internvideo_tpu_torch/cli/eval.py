"""Evaluation CLI of the PyTorch port.

    python -m internvideo_tpu_torch.cli.eval \
        --config configs/torch/eval_classification_1b.py --device cuda

Port of internvideo_tpu/cli/eval.py. The config file defines
`config = EvalRunConfig(...)`; dotlist overrides follow. Ported tasks:

  classification  encoder multi-view softmax ensemble -> top-1/top-5
  retrieval       VideoCLIP ITC + the cross-encoder ITM rerank -> R@K /
                  mdR / meanR (`options.no_rerank` skips the rerank)
  zeroshot        prompt-ensembled zero-shot action classification
  mcqa            multiple-choice retrieval accuracy (+ mAP)
  videoqa         generation-based QA accuracy (eval/videoqa.py scorers)
  mcq_benchmark   VideoMME / MVBench-class generation MCQ suites
  grounding       temporal grounding mIoU / R@{0.3,0.5,0.7}

The JAX CLI's other tasks (temporal_detection, openset, spatiotemporal)
exit with "not yet ported". The three generation tasks take their generate
function from `run.data()`, as in JAX; here `data` may also take `model`
and `device` arguments, which get `run.model` and the CLI's device
(configs/torch/chat_videoqa_8b.py builds its VideoChat from them).
`--device` is explicit: `cuda` (the default) with no GPU is an error, not a
CPU run. `checkpoint=None` means the seeded init; loading a checkpoint is
not ported yet (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
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


def _videoclip(run: EvalRunConfig, device: torch.device):
    """The seeded VideoCLIP of `run.model` on `device`, in eval mode."""
    from internvideo_tpu_torch.models.videoclip import VideoCLIP

    if run.checkpoint is not None:
        raise NotImplementedError(
            "checkpoint loading is not ported yet (ROADMAP queue 1, item 9)")
    return VideoCLIP(
        run.model, device=device,
        generator=torch.Generator(device=device).manual_seed(0),
    ).eval()


def _tensor(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), device=device)


def run_retrieval(run: EvalRunConfig, device: torch.device) -> dict:
    """`run.data()` -> (videos {"video"}, texts {"input_ids",
    "attention_mask"}, gt text ids per video, gt video id per text), as
    internvideo_tpu/cli/eval.py:71-129."""
    from internvideo_tpu_torch.eval.retrieval import itm_eval, retrieval_evaluation

    model = _videoclip(run, device)
    videos, texts, gt_v, gt_t = run.data()

    @torch.inference_mode()
    def encode_video(batch):
        tokens, pooled, _, _ = model.encode_vision(_tensor(batch["video"], device))
        return tokens, model.vision_proj(pooled)

    @torch.inference_mode()
    def encode_text(batch):
        tokens, pooled = model.encode_text(_tensor(batch["input_ids"], device),
                                           _tensor(batch["attention_mask"], device))
        return tokens, model.text_proj(pooled)

    @torch.inference_mode()
    def rerank(vis_embeds, txt_embeds, txt_mask):
        fused = model.fusion(txt_embeds, _tensor(txt_mask, device), vis_embeds)
        logits = model.itm_logits(fused.pooled)
        return logits[:, 1] - logits[:, 0]

    opts = dict(run.options)
    s_v2t, s_t2v = retrieval_evaluation(
        encode_video=encode_video, encode_text=encode_text,
        rerank_score=None if opts.pop("no_rerank", False) else rerank,
        videos=videos, texts=texts, **opts,
    )
    return itm_eval(s_v2t, s_t2v, gt_v, gt_t)


def run_zeroshot(run: EvalRunConfig, device: torch.device) -> dict:
    """Zero-shot action classification against a stage-2 VideoCLIP:
    `run.data()` -> (class_names, tokenize_fn, batches of {"video",
    "label"}); tokenize_fn(texts) -> {"input_ids", "attention_mask"}, as
    internvideo_tpu/cli/eval.py:132-187."""
    from internvideo_tpu_torch.eval.zeroshot import build_zero_shot_classifier, zero_shot_eval

    model = _videoclip(run, device)
    class_names, tokenize_fn, batches = run.data()

    @torch.inference_mode()
    def encode_texts(texts):
        t = tokenize_fn(texts)
        _, pooled = model.encode_text(_tensor(t["input_ids"], device),
                                      _tensor(t["attention_mask"], device))
        return model.text_proj(pooled)

    @torch.inference_mode()
    def encode_video(video):
        _, pooled, _, _ = model.encode_vision(_tensor(video, device))
        return model.vision_proj(pooled)

    classifier = build_zero_shot_classifier(
        encode_texts, class_names,
        **{k: v for k, v in run.options.items() if k == "templates"})
    return zero_shot_eval(encode_video, classifier, batches)


def run_mcqa(run: EvalRunConfig, device: torch.device) -> dict:
    """Multiple-choice QA: `run.data()` -> batches of {"video", "choice_ids"
    (B, K, L), "answer" (B,)}; the choices are encoded with an all-ones
    mask, as internvideo_tpu/cli/eval.py:210-249."""
    from internvideo_tpu_torch.eval.mcqa import mcqa_accuracy

    model = _videoclip(run, device)

    @torch.inference_mode()
    def encode_video(video):
        _, pooled, _, _ = model.encode_vision(_tensor(video, device))
        return model.vision_proj(pooled)

    @torch.inference_mode()
    def encode_choices(ids):
        ids = _tensor(ids, device)
        _, pooled = model.encode_text(ids, torch.ones_like(ids))
        return model.text_proj(pooled)

    return mcqa_accuracy(encode_video, encode_choices, run.data(), **run.options)


def _task_data(run: EvalRunConfig, device: torch.device):
    """`run.data()`, given `model=run.model` and `device=device` where its
    signature names them."""
    params = inspect.signature(run.data).parameters
    return run.data(**{k: v for k, v in (("model", run.model), ("device", device))
                       if k in params})


def run_videoqa(run: EvalRunConfig, device: torch.device) -> dict:
    """`run.data()` -> (generate_answer(batch) -> list[str], batches)."""
    from internvideo_tpu_torch.eval.videoqa import evaluate_videoqa

    generate_answer, data = _task_data(run, device)
    return evaluate_videoqa(generate_answer, data, **run.options)


def run_mcq_benchmark(run: EvalRunConfig, device: torch.device) -> dict:
    """VideoMME / MVBench-class MCQ suites: `run.data()` -> (items,
    generate_fn(prompt, video) -> str)."""
    from internvideo_tpu_torch.eval.mllm_benchmark import run_mcq_benchmark as _run

    items, generate_fn = _task_data(run, device)
    return _run(items, generate_fn, **run.options)


def run_grounding(run: EvalRunConfig, device: torch.device) -> dict:
    """Temporal grounding: `run.data()` -> (queries, generate_fn(prompt,
    video) -> str)."""
    from internvideo_tpu_torch.eval.grounding import run_grounding_eval

    queries, generate_fn = _task_data(run, device)
    return run_grounding_eval(queries, generate_fn, **run.options)


TASKS = {"classification": run_classification, "retrieval": run_retrieval,
         "zeroshot": run_zeroshot, "mcqa": run_mcqa, "videoqa": run_videoqa,
         "mcq_benchmark": run_mcq_benchmark, "grounding": run_grounding}


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
