"""Training CLI of the PyTorch port.

    python -m internvideo_tpu_torch.cli.train \
        --config configs/torch/finetune_k400_1b.py --device cuda \
        trainer.total_steps=3 trainer.log_every=1 trainer.checkpoint_dir=None

    python -m internvideo_tpu_torch.cli.train \
        --config configs/torch/pretrain_1b_umt.py --device cuda

    python -m internvideo_tpu_torch.cli.train \
        --config configs/torch/sft_internvideo3_8b.py --device cuda

    python -m internvideo_tpu_torch.cli.train \
        --config configs/torch/clip_stage2_1b.py --device cuda

    python -m internvideo_tpu_torch.cli.train \
        --config configs/torch/distill_l14_1b.py --device cuda

    python -m internvideo_tpu_torch.cli.train \
        --config configs/torch/clip_av_stage2_1b.py --device cuda

Port of internvideo_tpu/cli/train.py. The config file defines
`config = RunConfig(...)`; dotlist overrides follow. All six of the JAX
CLI's tasks are ported: `finetune` (InternVideo2 + mixup/cutmix +
soft-target CE + AdamW with layer decay), `pretrain` (UMT masked pretraining of
PretrainInternVideo2 with frozen CLIP and MAE teachers), `sft` (packed
multimodal SFT of the InternVideo3 VideoMLLM, on synthetic packs or, with
`data.jsonl`, on a jsonl of conversations and their video files), `clip`
(VideoCLIP stage 2: VTC + VTM + MLM, and UTA against a frozen CLIP teacher
with `engine.uta` > 0), `clip_av` (the audio-visual VideoCLIPAV, one media
type a run from `data.media_type`: "audio_video" by default, "audio" or
"video") and `distill` (a PretrainInternVideo2 student aligned to a frozen
InternVideo2 teacher). `--device` is explicit: `cuda`
(the default) with no GPU is an error, not a CPU run. The model starts
from the seeded init (`trainer.seed`), the teachers from their own
(`trainer.seed` + 1 and + 2), as the JAX CLI does when no teacher
checkpoint is given; the data come from `data["stream"]`, the jsonl, or
synthetic clips (and token ids) made from a fixed seed. The jsonl stream
is moved to the device by `data/loader.py:prefetch_to_device`, two batches
ahead of the step.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch

from internvideo_tpu_torch.core.config import apply_overrides, config_to_dict, load_config
from internvideo_tpu_torch.train.trainer import Trainer, TrainerConfig

@dataclasses.dataclass(frozen=True)
class RunConfig:
    """The JAX RunConfig's fields that the ported task reads."""

    task: str = "finetune"
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    model: object = None  # task-specific model config
    data: object = None  # task-specific data config: batch_size, stream
    engine: object = None  # task-specific engine config
    # pretrain, clip with uta > 0: the CLIP teacher's TeacherConfig; distill:
    # the teacher encoder's InternVideo2Config
    teacher: object = None
    mae_teacher: object = None  # pretrain: the MAE teacher's TeacherConfig

# The JAX CLI's task names (internvideo_tpu/cli/train.py:26), all ported.
_TASKS = ("finetune", "pretrain", "sft", "clip", "clip_av", "distill")


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


def _synthetic_video_stream(shape: tuple, seed: int = 0):
    """Endless standard-normal clips of `shape`, as numpy arrays made from
    `seed` (the JAX CLI's `_synthetic_video_stream`, :268-275)."""
    rng = np.random.default_rng(seed)
    while True:
        yield {"video": rng.normal(size=shape).astype(np.float32)}


def _num_visible_tokens(mask_type: str, mask_ratio: float, t_s: int, n_spatial: int) -> int:
    """The static visible count of the engine's keep indices (:278-284)."""
    from internvideo_tpu_torch.data.masking import num_visible

    if mask_type in ("tube", "attention"):
        return t_s * num_visible(n_spatial, mask_ratio)
    return num_visible(t_s * n_spatial, mask_ratio)


def build_pretrain(run: RunConfig, device: torch.device):
    """(trainer, full-rate video shape, (CLIP teacher, MAE teacher)) for UMT
    dual-teacher masked pretraining on `device` (the JAX `build_pretrain`,
    :287-342). The teachers are frozen (train/state.py `frozen_teacher`) and
    ride the step; with no teacher checkpoint in the repository they start
    from seeded random weights, as the JAX CLI's do without one."""
    from internvideo_tpu_torch.models.pretrain import PretrainInternVideo2
    from internvideo_tpu_torch.models.teachers import CLIPTeacher, MAETeacher
    from internvideo_tpu_torch.train.engines.pretrain import make_pretrain_step
    from internvideo_tpu_torch.train.state import frozen_teacher

    for key in ("clip_teacher_checkpoint", "mae_teacher_checkpoint"):
        if run.data.get(key):
            raise NotImplementedError(
                f"data.{key}: loading the convert-CLI's teacher npz is not ported yet "
                "(ROADMAP queue 1, item 9)")
    seed = run.trainer.seed
    gen = lambda s: torch.Generator(device=device).manual_seed(s)  # noqa: E731
    enc, cfg = run.model.encoder, run.engine
    t_full = enc.num_frames * cfg.td_ratio
    model = PretrainInternVideo2(run.model, device=device, generator=gen(seed))
    clip_teacher = frozen_teacher(CLIPTeacher(run.teacher, device=device, generator=gen(seed + 1)))
    mae_teacher = frozen_teacher(MAETeacher(run.mae_teacher, num_frames=t_full, device=device,
                                            generator=gen(seed + 2)))
    trainer = Trainer(
        run.trainer, model,
        lambda grad_accum=1: make_pretrain_step(cfg, clip_teacher, mae_teacher,
                                                grad_accum=grad_accum))
    shape = (run.data["batch_size"], t_full, enc.img_size, enc.img_size, 3)
    return trainer, shape, (clip_teacher, mae_teacher)


def build_distill(run: RunConfig, device: torch.device):
    """(trainer, video shape, teacher) for distillation of a small student
    from a frozen encoder on `device` (the JAX `build_distill`, :345-388).
    The teacher starts from `trainer.seed` + 1, as the JAX CLI's does
    without a checkpoint, and rides the step frozen."""
    from internvideo_tpu_torch.models.internvideo2 import InternVideo2
    from internvideo_tpu_torch.models.pretrain import PretrainInternVideo2
    from internvideo_tpu_torch.train.engines.distill import make_distill_step
    from internvideo_tpu_torch.train.state import frozen_teacher

    if run.data.get("teacher_checkpoint"):
        raise NotImplementedError(
            "data.teacher_checkpoint: loading the convert-CLI's encoder npz is not ported "
            "yet (ROADMAP queue 1, item 9)")
    seed = run.trainer.seed
    gen = lambda s: torch.Generator(device=device).manual_seed(s)  # noqa: E731
    model = PretrainInternVideo2(run.model, device=device, generator=gen(seed))
    teacher = frozen_teacher(InternVideo2(run.teacher, device=device, generator=gen(seed + 1)))
    trainer = Trainer(
        run.trainer, model,
        lambda grad_accum=1: make_distill_step(teacher, run.engine, grad_accum=grad_accum))
    enc = run.model.encoder
    shape = (run.data["batch_size"], enc.num_frames, enc.img_size, enc.img_size, 3)
    return trainer, shape, teacher


def build_clip(run: RunConfig, device: torch.device):
    """(trainer, example batch shapes, CLIP teacher or None) for VideoCLIP
    stage 2 on `device` (the JAX `build_clip`, :127-181). With `engine.uta`
    > 0 the frozen CLIP teacher starts from `trainer.seed` + 1 and rides the
    step."""
    from internvideo_tpu_torch.models.teachers import CLIPTeacher
    from internvideo_tpu_torch.models.videoclip import VideoCLIP
    from internvideo_tpu_torch.train.engines.clip import make_clip_train_step
    from internvideo_tpu_torch.train.state import frozen_teacher

    for key in ("init_state_dict", "teacher_checkpoint"):
        if run.data.get(key):
            raise NotImplementedError(
                f"data.{key}: the stage-2 checkpoint converters are not ported yet "
                "(ROADMAP queue 1, item 9)")
    seed = run.trainer.seed
    gen = lambda s: torch.Generator(device=device).manual_seed(s)  # noqa: E731
    model = VideoCLIP(run.model, device=device, generator=gen(seed))
    teacher = None
    if run.engine.uta > 0:
        teacher = frozen_teacher(CLIPTeacher(run.teacher, device=device, generator=gen(seed + 1)))
    v, b = run.model.vision, run.data["batch_size"]
    text = (b, run.data.get("text_len", 32))
    batch = {"video": (b, v.num_frames, v.img_size, v.img_size, 3), "input_ids": text,
             "attention_mask": text, "idx": (b,)}
    trainer = Trainer(
        run.trainer, model,
        lambda grad_accum=1: make_clip_train_step(run.engine, teacher, grad_accum=grad_accum))
    return trainer, batch, teacher


def _synthetic_clip_stream(batch: dict, vocab_size: int, seed: int = 0):
    """The JAX CLI's `_synthetic_clip_stream` (:391-406), draw for draw:
    standard-normal clips, token ids in [1, min(1000, vocab)), all-ones
    masks, idx 0..B-1."""
    rng = np.random.default_rng(seed)
    hi = min(1000, vocab_size)
    while True:
        yield {
            "video": rng.normal(size=batch["video"]).astype(np.float32),
            "input_ids": rng.integers(1, hi, size=batch["input_ids"]).astype(np.int32),
            "attention_mask": np.ones(batch["attention_mask"], np.int32),
            "idx": np.arange(batch["idx"][0], dtype=np.int32),
        }


def build_clip_av(run: RunConfig, device: torch.device):
    """(trainer, example batch shapes) for audio-visual stage 2 on `device`
    (the JAX `build_clip_av`, :183-217): the step trains
    run.data["media_type"] ("audio_video" by default, "audio" or "video");
    the batch's audio is (B, audio.max_frames, audio.n_mels) whichever tower
    reads it."""
    from internvideo_tpu_torch.models.videoclip_av import VideoCLIPAV
    from internvideo_tpu_torch.train.engines.clip import make_av_clip_train_step

    model = VideoCLIPAV(run.model, device=device,
                        generator=torch.Generator(device=device).manual_seed(run.trainer.seed))
    v, a, b = run.model.vision, run.model.audio, run.data["batch_size"]
    media_type = run.data.get("media_type", "audio_video")
    text = (b, run.data.get("text_len", 32))
    batch = {"video": (b, v.num_frames, v.img_size, v.img_size, 3),
             "audio": (b, a.max_frames, a.n_mels), "input_ids": text, "attention_mask": text,
             "idx": (b,)}
    trainer = Trainer(
        run.trainer, model,
        lambda grad_accum=1: make_av_clip_train_step(run.engine, media_type,
                                                     grad_accum=grad_accum))
    return trainer, batch


def _synthetic_av_stream(batch: dict, seed: int = 0):
    """The JAX CLI's `_synthetic_av_stream` (:220-235), draw for draw:
    standard-normal clips and fbanks, token ids in [4, 40), all-ones masks,
    idx 0..B-1."""
    rng = np.random.default_rng(seed)
    while True:
        yield {
            "video": rng.normal(size=batch["video"]).astype(np.float32),
            "audio": rng.normal(size=batch["audio"]).astype(np.float32),
            "input_ids": rng.integers(4, 40, batch["input_ids"]).astype(np.int32),
            "attention_mask": np.ones(batch["attention_mask"], np.int32),
            "idx": np.arange(batch["idx"][0], dtype=np.int32),
        }


def build_sft(run: RunConfig, device: torch.device):
    """(trainer, example batch shapes) for packed multimodal SFT of the
    VideoMLLM on `device` (the JAX `build_sft`, :409-465). With `data.jsonl`
    the shapes follow the tokenize config's fixed grid and
    `data.pack_max_length`; otherwise those of the JAX synthetic stream
    (data.seq_len, data.num_frames, data.img_size); a config's own
    data.stream sets its own."""
    from internvideo_tpu_torch.models.mllm import VideoMLLM
    from internvideo_tpu_torch.train.engines.sft import make_sft_step

    model = VideoMLLM(run.model, device=device,
                      generator=torch.Generator(device=device).manual_seed(run.trainer.seed))
    v, b = run.model.vision, run.data["batch_size"]
    if run.data.get("jsonl"):
        tok = run.data["tokenize"]
        gt, gh, gw = tok.fixed_grid
        seq = run.data["pack_max_length"]
        video = (b, gt * tok.temporal_patch_size, gh * tok.patch_size, gw * tok.patch_size, 3)
        pos = (3, b, seq)
    else:
        seq = run.data.get("seq_len", 0)
        img = run.data.get("img_size", 2 * v.patch_size * v.spatial_merge_size)
        video = (b, run.data.get("num_frames", 2), img, img, 3)
        pos = (b, seq)
    batch = {"input_ids": (b, seq), "segment_ids": (b, seq), "position_ids": pos,
             "labels": (b, seq), "video": video}
    trainer = Trainer(
        run.trainer, model,
        lambda grad_accum=1: make_sft_step(run.engine, mesh=run.trainer.mesh,
                                           grad_accum=grad_accum))
    return trainer, batch


def _mllm_jsonl_stream(run: RunConfig):
    """The real SFT data path (the JAX `_mllm_jsonl_stream`, :463-489):
    jsonl + video files -> packed multimodal numpy batches
    (data/mllm_tokenize.py). run.data needs "jsonl", "batch_size",
    "pack_max_length" and "tokenize" (an MLLMTokenizeConfig with a
    fixed_grid); optional "media_root" and "tokenizer" (a local HF
    tokenizer directory; without it, JAX's character-level encoding
    1 + ord(c) % 200)."""
    from internvideo_tpu_torch.data.mllm_tokenize import MLLMTokenizeFunction, mllm_sft_batches

    if run.data.get("tokenizer"):
        from internvideo_tpu_torch.data.tokenizer import load_hf_tokenizer

        hf = load_hf_tokenizer(run.data["tokenizer"]).tokenizer

        def encode(t):
            return hf(t, add_special_tokens=False)["input_ids"]
    else:
        def encode(t):
            return [1 + (ord(c) % 200) for c in t]  # byte fallback
    fn = MLLMTokenizeFunction(encode, run.data["tokenize"])
    return mllm_sft_batches(run.data["jsonl"], fn, pack_max_length=run.data["pack_max_length"],
                            media_root=run.data.get("media_root", ""),
                            batch_size=run.data["batch_size"])


def _synthetic_sft_stream(batch: dict, seed: int = 0):
    """The JAX CLI's `_synthetic_sft_stream` (:492-508), draw for draw:
    standard-normal clips, token ids in [1, 100), labels the ids rolled by
    one, positions 0..L-1, all-zero segments; no placeholders, so the
    tower's output is unused."""
    rng = np.random.default_rng(seed)
    while True:
        out = {k: (np.zeros(shape, np.int32) if k != "video"
                   else rng.normal(size=shape).astype(np.float32))
               for k, shape in batch.items()}
        ids = rng.integers(1, 100, size=batch["input_ids"])
        out["input_ids"] = ids.astype(np.int32)
        out["labels"] = np.roll(ids, -1, axis=1).astype(np.int32)
        out["position_ids"] = np.broadcast_to(
            np.arange(ids.shape[1], dtype=np.int32), ids.shape).copy()
        yield out


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
    if run.task not in _TASKS:
        raise SystemExit(f"unknown task {run.task!r}; one of {list(_TASKS)}")
    print("config:", config_to_dict(run.trainer))
    if run.task == "pretrain":
        trainer, shape, _ = build_pretrain(run, device)
        data = run.data.get("stream") or _synthetic_video_stream(shape)
    elif run.task == "distill":
        trainer, shape, _ = build_distill(run, device)
        data = run.data.get("stream") or _synthetic_video_stream(shape)
    elif run.task == "sft":
        trainer, batch = build_sft(run, device)
        if run.data.get("jsonl"):
            from internvideo_tpu_torch.data.loader import prefetch_to_device

            data = prefetch_to_device(_mllm_jsonl_stream(run), device)
        else:
            data = run.data.get("stream") or _synthetic_sft_stream(batch)
    elif run.task == "clip":
        trainer, batch, _ = build_clip(run, device)
        data = run.data.get("stream") or _synthetic_clip_stream(batch, run.model.text.vocab_size)
    elif run.task == "clip_av":
        trainer, batch = build_clip_av(run, device)
        data = run.data.get("stream") or _synthetic_av_stream(batch)
    else:
        trainer, batch = build_finetune(run, device)
        data = run.data.get("stream") or synthetic_stream(batch, run.model.num_classes)
    trainer.fit(data)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
