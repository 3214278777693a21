"""Evaluation CLI of the PyTorch port.

    python -m internvideo_tpu_torch.cli.eval \
        --config configs/torch/eval_classification_1b.py --device cuda

Port of internvideo_tpu/cli/eval.py, with all ten of its tasks. The config
file defines `config = EvalRunConfig(...)`; dotlist overrides follow. Tasks:

  classification      encoder multi-view softmax ensemble -> top-1/top-5
  retrieval           VideoCLIP ITC + the cross-encoder ITM rerank -> R@K /
                      mdR / meanR (`options.no_rerank` skips the rerank)
  zeroshot            prompt-ensembled zero-shot action classification
  mcqa                multiple-choice retrieval accuracy (+ mAP)
  videoqa             generation-based QA accuracy (eval/videoqa.py scorers)
  mcq_benchmark       VideoMME / MVBench-class generation MCQ suites
  grounding           temporal grounding mIoU / R@{0.3,0.5,0.7}
  temporal_detection  TAL decode + per-class NMS (C++) -> mAP@tIoU
  openset             OpenMax recalibration (C++ libMR) -> open-set accuracy
  spatiotemporal      ROIAlign3D on the device + an ROI head -> AVA frame mAP

An unknown task exits with an error. The three generation tasks take their
generate function from `run.data()`, as in JAX; here `data` may also take
`model` and `device` arguments, which get `run.model` and the CLI's device
(configs/torch/chat_videoqa_8b.py builds its VideoChat from them).
temporal_detection and openset are host work whatever the device;
spatiotemporal sends the feature maps and ROIs to the device and hands
`apply_head` a tensor there. `--device` is explicit: `cuda` (the default)
with no GPU is an error, not a CPU run.

`checkpoint=` (classification, retrieval, zeroshot, mcqa; `None` is the
seeded init) is dispatched by `load_weights`:

  * a directory with `step_*.pt` files (the port's CheckpointManager): the
    latest step's model weights;
  * a directory with `*.safetensors` files (an HF directory, sharded with
    an index or a single `model.safetensors`) or a `.safetensors` file: the
    reference state dict through the task's converter
    (`convert_internvideo2_encoder` for classification,
    `convert_internvideo2_stage2` for the VideoCLIP tasks), then
    `params_from_jax`;
  * an `.npz`: a converted tree as the convert CLI writes it
    (tools/convert_cli.py), through `params_from_jax`.

A directory that holds neither raises. JAX sends every directory without
`model.safetensors.index.json` to orbax, so a single-shard HF directory
restores nothing there and the seeded init runs (ROADMAP queue 3). JAX's
mcqa passes the raw state dict through unconverted; the port converts it
as the other VideoCLIP tasks do.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import inspect
import json
import os
from typing import Callable, Optional

import numpy as np
import torch

@dataclasses.dataclass(frozen=True)
class EvalRunConfig:
    task: str = "retrieval"
    model: object = None  # task-appropriate model config
    checkpoint: Optional[str] = None  # None = seeded init
    data: Optional[Callable] = None  # () -> task inputs
    options: dict = dataclasses.field(default_factory=dict)


def load_weights(model: torch.nn.Module, checkpoint: Optional[str], convert: Callable,
                 cfg=None) -> None:
    """Load `checkpoint` into `model` (see the module docstring); `convert`
    maps a reference state dict to the JAX param tree, `cfg` checks the
    tree's depth in `params_from_jax`. None leaves the seeded init."""
    from internvideo_tpu_torch.core.checkpoint import (
        CheckpointManager,
        load_hf_checkpoint,
        read_safetensors,
    )
    from internvideo_tpu_torch.models.convert import params_from_jax
    from internvideo_tpu_torch.tools.convert_cli import load_flat_params

    if checkpoint is None:
        return
    if not os.path.exists(checkpoint):
        raise FileNotFoundError(f"checkpoint {checkpoint!r} does not exist")
    if os.path.isdir(checkpoint):
        if CheckpointManager(checkpoint).restore_model(model) is not None:
            return
        if not glob.glob(os.path.join(checkpoint, "*.safetensors")):
            raise FileNotFoundError(f"checkpoint {checkpoint!r} holds no step_*.pt checkpoint "
                                    "and no *.safetensors file")
        tree = convert(load_hf_checkpoint(checkpoint))
    elif checkpoint.endswith(".safetensors"):
        tree = convert(read_safetensors(checkpoint))
    elif checkpoint.endswith(".npz"):
        tree = load_flat_params(checkpoint)
    else:
        raise ValueError(f"checkpoint {checkpoint!r}: a step directory, an HF directory, a "
                         ".safetensors file or a converted .npz")
    model.load_state_dict(params_from_jax(tree, cfg), strict=True)


def run_classification(run: EvalRunConfig, device: torch.device) -> dict:
    from internvideo_tpu_torch.eval.classification import final_test
    from internvideo_tpu_torch.models.convert import convert_internvideo2_encoder
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2

    model = InternVideo2(
        run.model, device=device,
        generator=torch.Generator(device=device).manual_seed(0),
    ).eval()
    load_weights(model, run.checkpoint,
                 lambda sd: convert_internvideo2_encoder(sd, depth=run.model.depth), run.model)

    @torch.inference_mode()
    def forward(video: np.ndarray) -> torch.Tensor:
        return model(torch.as_tensor(video, device=device)).logits

    return final_test(forward, run.data(), **run.options)


def _videoclip(run: EvalRunConfig, device: torch.device):
    """The VideoCLIP of `run.model` on `device` in eval mode: seeded, or
    loaded from `run.checkpoint` (a stage-2 checkpoint through
    `convert_internvideo2_stage2`)."""
    from internvideo_tpu_torch.models.convert import convert_internvideo2_stage2
    from internvideo_tpu_torch.models.videoclip import VideoCLIP

    model = VideoCLIP(
        run.model, device=device,
        generator=torch.Generator(device=device).manual_seed(0),
    ).eval()
    pre = run.model.pretrain
    load_weights(model, run.checkpoint, lambda sd: convert_internvideo2_stage2(
        sd, depth=run.model.vision.depth,
        clip_return_layers=pre.clip_return_layers if pre is not None else 0,
        text_layers=run.model.text.num_layers), run.model)
    return model


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


def run_temporal_detection(run: EvalRunConfig, device: torch.device) -> dict:
    """TAL suite (ANETdetection protocol): `run.data()` -> (raw_outputs,
    gt); raw_outputs: vid -> (scores (T, C), left (T,), right (T,))
    anchor-free head outputs; decode -> per-class NMS -> mAP@tIoU, on the
    host, as internvideo_tpu/cli/eval.py:280-304."""
    from internvideo_tpu_torch.eval.temporal_detection import (
        decode_proposals,
        detection_map,
        nms_proposals,
    )

    raw, gt = run.data()
    opts = dict(run.options)
    dec = {k: opts.pop(k) for k in
           ("stride", "score_threshold", "max_per_class") if k in opts}
    nms = {k: opts.pop(k) for k in
           ("iou_threshold", "soft", "sigma", "max_keep") if k in opts}
    preds = {}
    for vid, (scores, left, right) in raw.items():
        segs, sc, labs = decode_proposals(
            np.asarray(scores), np.asarray(left), np.asarray(right), **dec)
        preds[vid] = nms_proposals(segs, sc, labs, **nms)
    return detection_map(preds, gt, **opts)


def run_openset(run: EvalRunConfig, device: torch.device) -> dict:
    """Open-set AR (OpenMax over the libMR port): `run.data()` ->
    (train_feats, train_labels, train_logits, test_feats, test_logits,
    test_labels), -1 test labels marking unknown-class samples."""
    from internvideo_tpu_torch.eval.openset import OpenMax, openset_metrics

    tr_f, tr_y, tr_z, te_f, te_z, te_y = run.data()
    om = OpenMax(**run.options).fit(tr_f, tr_y, tr_z)
    return openset_metrics(om.recalibrate(te_f, te_z), te_y)


def run_spatiotemporal(run: EvalRunConfig, device: torch.device) -> dict:
    """STAL frame-mAP (AVA protocol): `run.data()` -> (apply_head,
    features_by_frame, boxes_by_frame, ground_truth); the ROI features are
    computed on `device`."""
    from internvideo_tpu_torch.eval.spatiotemporal import evaluate_action_detector

    apply_head, feats, boxes, gt = _task_data(run, device)
    return evaluate_action_detector(apply_head, feats, boxes, gt, device=device,
                                    **run.options)


TASKS = {"classification": run_classification, "retrieval": run_retrieval,
         "zeroshot": run_zeroshot, "mcqa": run_mcqa, "videoqa": run_videoqa,
         "mcq_benchmark": run_mcq_benchmark, "grounding": run_grounding,
         "temporal_detection": run_temporal_detection, "openset": run_openset,
         "spatiotemporal": run_spatiotemporal}


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
