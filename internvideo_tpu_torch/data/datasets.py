"""Dataset classes: csv action-recognition clips, jsonl video-text pairs,
open-ended video QA and a weighted concat.

Port of internvideo_tpu/data/datasets.py, with the same batches:
  * CsvVideoDataset: "path<sep>label" rows, train augmentation
    (random-resized crop + flip + optional RandAugment / erasing) or eval
    views (short-side resize + center crop, multi-clip sparse sampling);
  * JsonlVideoTextDataset: jsonl of {"video": path, "caption": str},
    tokenized with an on-disk cache;
  * answers_with_weights / VideoQADataset / WeightedConcatDataset.

Everything is host-side numpy; decode goes through data/video.py, and the
audio rows (media_type "audio" / "audio_video") through data/audio.py.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Iterator, Optional, Sequence

import numpy as np

from internvideo_tpu_torch.data import transforms
from internvideo_tpu_torch.data.loader import StatefulIterator
from internvideo_tpu_torch.data.video import read_video


class CsvVideoDataset:
    """Rows "path<sep>label"; yields {"video": f32, "label": i32} batches."""

    def __init__(
        self,
        csv_path: str,
        *,
        num_frames: int = 8,
        img_size: int = 224,
        train: bool = True,
        sep: str = ",",
        use_rand_augment: bool = False,
        use_erasing: bool = False,
        seed: int = 0,
        media_root: str = "",
    ):
        self.samples = []
        with open(csv_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                path, label = line.rsplit(sep, 1)
                if media_root and not os.path.isabs(path):
                    path = os.path.join(media_root, path)
                self.samples.append((path, int(label)))
        self.num_frames = num_frames
        self.img_size = img_size
        self.train = train
        self.use_rand_augment = use_rand_augment
        self.use_erasing = use_erasing
        self.seed = seed

    def __len__(self):
        return len(self.samples)

    def load_clip(
        self, idx: int, rng: np.random.Generator,
        clip_idx: int = 0, num_clips: int = 1,
    ) -> np.ndarray:
        path, _ = self.samples[idx]
        clip = read_video(
            path, self.num_frames,
            sample="rand" if self.train else "sparse",
            clip_idx=clip_idx, num_clips=num_clips, rng=rng,
        )
        if self.train:
            clip = transforms.random_resized_crop(
                clip, self.img_size, rng, scale=(0.5, 1.0)
            )
            clip = transforms.horizontal_flip(clip, rng)
            if self.use_rand_augment:
                clip = transforms.rand_augment(clip, rng)
        else:
            clip = transforms.resize_short_side(clip, self.img_size)
            clip = transforms.center_crop(clip, self.img_size)
        out = transforms.normalize(np.ascontiguousarray(clip))
        if self.train and self.use_erasing:
            out = transforms.random_erasing(out, rng)
        return out

    def train_batches(self, batch_size: int) -> Iterator[dict]:
        it = iter(StatefulIterator(len(self), seed=self.seed))
        rng = np.random.default_rng(self.seed + 1)
        while True:
            idxs = [next(it) for _ in range(batch_size)]
            yield {
                "video": np.stack([self.load_clip(i, rng) for i in idxs]),
                "label": np.asarray(
                    [self.samples[i][1] for i in idxs], np.int32
                ),
            }

    def eval_views(
        self, batch_size: int, num_clips: int = 4
    ) -> Iterator[dict]:
        """Multi-view test iterator for eval/classification.final_test."""
        rng = np.random.default_rng(0)
        views = [
            (i, c) for i in range(len(self)) for c in range(num_clips)
        ]
        for s in range(0, len(views), batch_size):
            chunk = views[s:s + batch_size]
            yield {
                "video": np.stack([
                    self.load_clip(i, rng, clip_idx=c, num_clips=num_clips)
                    for i, c in chunk
                ]),
                "label": np.asarray(
                    [self.samples[i][1] for i, _ in chunk], np.int32
                ),
                "video_id": [str(i) for i, _ in chunk],
            }


class JsonlVideoTextDataset:
    """jsonl of {"video": path, "caption": str} with tokenize caching.

    media_type extends the row contract (reference av_utils.py +
    pt_dataset.py audio branches):
      "video"/"image":  row needs "video"
      "audio":          row needs "audio" (a wav/container path), or
                        "video" with read_audio_from_video=True (demux)
      "audio_video":    row needs "video"; the audio track is demuxed from
                        it (read_audio_from_video) or read from "audio"
    Audio rows yield "audio" (B, audio_frames, 64) BEATs fbanks plus
    "audio_padding_mask" (data/audio.py `load_fbank`).
    """

    def __init__(
        self,
        jsonl_path: str,
        tokenizer,
        *,
        num_frames: int = 8,
        img_size: int = 224,
        max_length: int = 32,
        cache_dir: Optional[str] = None,
        seed: int = 0,
        media_root: str = "",
        media_type: str = "video",
        read_audio_from_video: bool = False,
        audio_frames: int = 998,
        audio_seconds: int = 10,
    ):
        self.items = []
        with open(jsonl_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    it = json.loads(line)
                    for key in ("video", "audio"):
                        p = it.get(key, "")
                        if media_root and p and not os.path.isabs(p):
                            it[key] = os.path.join(media_root, p)
                    self.items.append(it)
        self.tokenizer = tokenizer
        self.num_frames = num_frames
        self.img_size = img_size
        self.max_length = max_length
        self.seed = seed
        if media_type not in ("video", "image", "audio", "audio_video"):
            raise ValueError(f"unknown media_type {media_type!r}")
        self.media_type = media_type
        self.read_audio_from_video = read_audio_from_video
        self.audio_frames = audio_frames
        self.audio_seconds = audio_seconds

        self._tok_cache = None
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)
            key = hashlib.sha1(
                (jsonl_path + str(max_length)).encode()
            ).hexdigest()[:16]
            cache_file = os.path.join(cache_dir, f"tok_{key}.npz")
            if os.path.exists(cache_file):
                z = np.load(cache_file)
                self._tok_cache = {
                    "input_ids": z["input_ids"],
                    "attention_mask": z["attention_mask"],
                }
            else:
                toks = tokenizer(
                    [it["caption"] for it in self.items],
                    max_length=max_length,
                )
                np.savez(cache_file, **toks)
                self._tok_cache = toks

    def __len__(self):
        return len(self.items)

    def tokens(self, idxs: Sequence[int]) -> dict:
        if self._tok_cache is not None:
            return {
                k: v[np.asarray(idxs)] for k, v in self._tok_cache.items()
            }
        return self.tokenizer(
            [self.items[i]["caption"] for i in idxs],
            max_length=self.max_length,
        )

    def _audio_path(self, item: dict) -> str:
        if "audio" in item and not self.read_audio_from_video:
            return item["audio"]
        if self.read_audio_from_video and "video" in item:
            return item["video"]
        if "audio" in item:
            return item["audio"]
        raise KeyError(
            f"media_type {self.media_type!r} row has neither 'audio' nor a "
            "demuxable 'video'"
        )

    def load_audio(self, i: int, rng: Optional[np.random.Generator]) -> tuple:
        """(fbank (audio_frames, 64), padding mask) of row i: data/audio.py's
        `load_fbank` on its audio path, a random window from `rng` (start 0
        without one)."""
        from internvideo_tpu_torch.data.audio import load_fbank

        return load_fbank(
            self._audio_path(self.items[i]),
            max_audio_length=self.audio_seconds,
            target_frames=self.audio_frames,
            rng=rng,
        )

    def batches(self, batch_size: int, train: bool = True) -> Iterator[dict]:
        it = iter(StatefulIterator(len(self), seed=self.seed, shuffle=train))
        rng = np.random.default_rng(self.seed + 1)
        want_video = self.media_type in ("video", "image", "audio_video")
        want_audio = self.media_type in ("audio", "audio_video")
        while True:
            idxs = [next(it) for _ in range(batch_size)]
            out = {"idx": np.asarray(idxs, np.int32)}
            if want_video:
                clips = []
                for i in idxs:
                    clip = read_video(
                        self.items[i]["video"], self.num_frames,
                        sample="rand" if train else "middle", rng=rng,
                    )
                    clip = (
                        transforms.random_resized_crop(
                            clip, self.img_size, rng, scale=(0.5, 1.0)
                        )
                        if train else transforms.center_crop(
                            transforms.resize_short_side(
                                clip, self.img_size),
                            self.img_size,
                        )
                    )
                    clips.append(
                        transforms.normalize(np.ascontiguousarray(clip))
                    )
                out["video"] = np.stack(clips)
            if want_audio:
                fbanks, masks = zip(*(
                    self.load_audio(i, rng if train else None) for i in idxs
                ))
                out["audio"] = np.stack(fbanks)
                out["audio_padding_mask"] = np.stack(masks)
            toks = self.tokens(idxs)
            out["input_ids"] = toks["input_ids"]
            out["attention_mask"] = toks["attention_mask"]
            yield out


def answers_with_weights(raw_answers, eos: str = "[SEP]"):
    """Open-ended VQA answer aggregation (multi_modality/dataset/
    qa_dataset.py:29-42): duplicate answers fold into weights 1/n each,
    and every answer is suffixed with the eos token."""
    if isinstance(raw_answers, str):
        raw_answers = [raw_answers]
    weight = {}
    for a in raw_answers:
        weight[a] = weight.get(a, 0.0) + 1.0 / len(raw_answers)
    answers = list(weight.keys())
    return [f"{a} {eos}" for a in answers], [weight[a] for a in answers]


class VideoQADataset:
    """Open-ended video QA (multi_modality/dataset/qa_dataset.py:10-90):
    jsonl rows {"video", "question", "answer"(str|list),
    "question_id"(eval)}. Train mode yields per-item (clip, question,
    answers, weights); eval mode (clip, question, question_id) with the
    candidate `answer_list` attached — the shapes `eval/openend_vqa.py`'s
    classifier head consumes.
    """

    def __init__(
        self,
        ann_path: str,
        *,
        num_frames: int = 4,
        img_size: int = 224,
        mode: str = "train",
        eos: str = "[SEP]",
        answer_list: Optional[Sequence[str]] = None,
        seed: int = 0,
    ):
        assert mode in ("train", "eval")
        with open(ann_path) as f:
            self.items = [json.loads(line) for line in f if line.strip()]
        self.num_frames = num_frames
        self.img_size = img_size
        self.mode = mode
        self.eos = eos
        self.answer_list = list(answer_list) if answer_list else None
        self.seed = seed

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int):
        ann = self.items[i]
        rng = np.random.default_rng(self.seed + i)
        clip = read_video(
            ann["video"], self.num_frames,
            sample="rand" if self.mode == "train" else "middle", rng=rng,
        )
        clip = (
            transforms.random_resized_crop(
                clip, self.img_size, rng, scale=(0.5, 1.0))
            if self.mode == "train"
            else transforms.center_crop(
                transforms.resize_short_side(clip, self.img_size),
                self.img_size)
        )
        clip = transforms.normalize(np.ascontiguousarray(clip))
        question = " ".join(str(ann["question"]).strip().split())
        if self.mode == "train":
            answers, weights = answers_with_weights(ann["answer"], self.eos)
            return {
                "video": clip, "question": question,
                "answers": answers, "weights": np.asarray(weights,
                                                          np.float32),
            }
        return {
            "video": clip, "question": question,
            "question_id": ann.get("question_id", i),
        }


class WeightedConcatDataset:
    """Weighted concat of indexable datasets (multi_modality/dataset/
    resample_concat_dataset.py:18-60): each source's length is scaled by
    an integer sample weight, so one epoch resamples hotter sources more
    often. Index math mirrors cumsum_with_sample_weight."""

    def __init__(self, datasets: Sequence, sample_weights: Sequence[int]):
        assert len(datasets) == len(sample_weights) and datasets
        assert all(int(w) == w and w >= 1 for w in sample_weights)
        self.datasets = list(datasets)
        self.weights = [int(w) for w in sample_weights]
        self.cum = np.cumsum(
            [len(d) * w for d, w in zip(self.datasets, self.weights)])

    def __len__(self) -> int:
        return int(self.cum[-1])

    def __getitem__(self, idx: int):
        ds = int(np.searchsorted(self.cum, idx, side="right"))
        base = 0 if ds == 0 else int(self.cum[ds - 1])
        return self.datasets[ds][(idx - base) % len(self.datasets[ds])]
