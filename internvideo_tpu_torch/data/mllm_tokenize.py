"""MLLM data items, 3D mRoPE position grids and packing into SFT batches.

Port of the numpy parts of internvideo_tpu/data/mllm_tokenize.py:
`MediaPlan`, `MLLMDataItem`, `get_rope_index_3d` (:199, the Qwen3-VL
get_rope_index_3), `_pack_one_video_per_row` (:495) and `pack_mllm_items`
(:529), with the same results. The tokenize function, frame sampling and
media decode (`MLLMTokenizeFunction`, `mllm_sft_batches`) wait for a
tokenizer and video files in the repository (ROADMAP queue 1, item 7).

`synthetic_sft_items` / `synthetic_sft_stream` are the port's own: seeded
random items laid out as the tokenize function lays out a chat sample with
one video (per merged frame: vision_start, frame_seqlen placeholders,
vision_end; labels on the answer only, shifted by one), packed with
`pack_mllm_items(..., one_video_per_pack=True)` into rows that carry one
clip each, so that an SFT step on the card trains the vision tower.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np

from internvideo_tpu_torch.data.packing import PackingResult, soft_pack


@dataclasses.dataclass
class MediaPlan:
    """Decode / resize instructions for one video."""

    path: str
    frame_indices: list[int]  # into the source video
    resize_hw: tuple[int, int]  # target (H, W) after smart resize
    grid_thw: tuple[int, int, int]  # (gt, gh, gw) before the spatial merge
    timestamps: list[float]  # one per merged frame (len == gt)
    merge_length: int = 4  # spatial_merge_size ** 2


@dataclasses.dataclass
class MLLMDataItem:
    input_ids: np.ndarray  # (L,) int32
    labels: np.ndarray  # (L,) int32, -100 unsupervised, already shifted by one
    position_ids: np.ndarray  # (3, L) int32 mRoPE grids
    media: list[MediaPlan]

    @property
    def num_tokens(self) -> int:
        return int(self.input_ids.shape[0])


def get_rope_index_3d(
    input_ids: np.ndarray,  # (L,) int
    video_grid_thw: Optional[np.ndarray],  # (n, 3) per vision run (t = 1 rows)
    *,
    image_token_id: int = 151655,
    video_token_id: int = 151656,
    vision_start_token_id: int = 151652,
    spatial_merge_size: int = 2,
) -> np.ndarray:
    """(3, L) position ids: text advances all three axes together; each
    vision run (the placeholders after a vision_start token) gets (t, h, w)
    grid coordinates from the running offset, which then moves past
    max(gt, gh / m, gw / m)."""
    ids = list(input_ids.tolist())
    n_tok = len(ids)
    pos = np.zeros((3, n_tok), np.int64)
    m = spatial_merge_size
    runs = []  # (start, end) of the vision-token runs
    i = 0
    while i < n_tok:
        if (ids[i] == vision_start_token_id and i + 1 < n_tok
                and ids[i + 1] in (image_token_id, video_token_id)):
            j = i + 1
            while j < n_tok and ids[j] in (image_token_id, video_token_id):
                j += 1
            runs.append((i + 1, j))
            i = j
        else:
            i += 1
    if video_grid_thw is None:
        assert not runs, "vision tokens present but no grids given"
        pos[:] = np.arange(n_tok)[None]
        return pos.astype(np.int32)
    assert len(runs) == video_grid_thw.shape[0], (
        f"{len(runs)} vision runs != {video_grid_thw.shape[0]} grid rows")
    cursor = prev_end = 0
    for run_idx, (s, e) in enumerate(runs):
        span = s - prev_end  # the text before the run, its vision_start included
        pos[:, prev_end:s] = cursor + np.arange(span)[None]
        cursor += span
        gt, gh, gw = (int(x) for x in video_grid_thw[run_idx])
        lh, lw = gh // m, gw // m
        assert e - s == gt * lh * lw, f"run length {e - s} != grid tokens {gt * lh * lw}"
        pos[0, s:e] = cursor + np.repeat(np.arange(gt), lh * lw)
        pos[1, s:e] = cursor + np.tile(np.repeat(np.arange(lh), lw), gt)
        pos[2, s:e] = cursor + np.tile(np.arange(lw), gt * lh)
        cursor += int(max(gt, lh, lw))
        prev_end = e
    pos[:, prev_end:] = cursor + np.arange(n_tok - prev_end)[None]
    return pos.astype(np.int32)


def _pack_one_video_per_row(items: Sequence[MLLMDataItem], pack_max_length: int):
    """Greedy packing with at most one video-bearing sample per pack (one
    clip tensor per row); text-only samples fill the rest best-fit."""
    vid = [i for i, it in enumerate(items) if it.media and it.num_tokens <= pack_max_length]
    txt = [i for i, it in enumerate(items) if not it.media and it.num_tokens <= pack_max_length]
    dropped = [i for i, it in enumerate(items) if it.num_tokens > pack_max_length]
    packs = [[i] for i in vid]
    remaining = [pack_max_length - items[i].num_tokens for i in vid]
    for i in sorted(txt, key=lambda i: -items[i].num_tokens):
        n = items[i].num_tokens
        best, best_left = None, None
        for pi in range(len(packs)):
            left = remaining[pi] - n
            if left >= 0 and (best_left is None or left < best_left):
                best, best_left = pi, left
        if best is None:
            packs.append([i])
            remaining.append(pack_max_length - n)
        else:
            packs[best].append(i)
            remaining[best] = best_left
    used = sum(items[i].num_tokens for p in packs for i in p)
    eff = used / max(len(packs) * pack_max_length, 1)
    return PackingResult(packs=packs, efficiency=eff, dropped=dropped)


def pack_mllm_items(items: Sequence[MLLMDataItem], pack_max_length: int, *,
                    pad_token_id: int = 0, one_video_per_pack: bool = False) -> dict:
    """Soft-pack items into static (P, L) arrays for the SFT step:
    {"input_ids", "labels", "segment_ids" (the sample's index in its pack,
    pad -1), "position_ids" (3, P, L), "packs", "efficiency", "dropped"}."""
    if one_video_per_pack:
        res = _pack_one_video_per_row(items, pack_max_length)
    else:
        res = soft_pack([it.num_tokens for it in items], pack_max_length)
    n_packs, n_tok = len(res.packs), pack_max_length
    input_ids = np.full((n_packs, n_tok), pad_token_id, np.int32)
    labels = np.full((n_packs, n_tok), -100, np.int32)
    segment_ids = np.full((n_packs, n_tok), -1, np.int32)
    position_ids = np.zeros((3, n_packs, n_tok), np.int32)
    for pi, pack in enumerate(res.packs):
        off = 0
        for si, idx in enumerate(pack):
            it = items[idx]
            n = it.num_tokens
            input_ids[pi, off:off + n] = it.input_ids
            labels[pi, off:off + n] = it.labels
            segment_ids[pi, off:off + n] = si
            position_ids[:, pi, off:off + n] = it.position_ids
            off += n
    return {"input_ids": input_ids, "labels": labels, "segment_ids": segment_ids,
            "position_ids": position_ids, "packs": res.packs, "efficiency": res.efficiency,
            "dropped": res.dropped}


@dataclasses.dataclass(frozen=True)
class SyntheticSFTConfig:
    """The layout of the synthetic chat samples (token ids of the Qwen3
    family by default; a small vocabulary needs its own)."""

    vocab_size: int = 151936
    im_start_token_id: int = 151644
    im_end_token_id: int = 151645
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    video_token_id: int = 151656
    num_frames: int = 16  # input frames of the clip
    img_size: int = 224
    patch_size: int = 16
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    video_text_tokens: tuple[int, int, int] = (96, 160, 256)  # prompt, question, answer
    text_lengths: tuple[int, int] = (256, 2048)  # text-only sample lengths, inclusive


def _text_ids(rng, n: int, c: SyntheticSFTConfig) -> np.ndarray:
    hi = min(c.vocab_size, c.im_start_token_id, c.vision_start_token_id, c.video_token_id)
    return rng.integers(1, hi, size=n)


def _shifted(input_ids: np.ndarray, supervised: np.ndarray) -> np.ndarray:
    """Labels of the supervised positions, shifted so that position i
    scores token i + 1 (the SFT loss reads hidden[i] against labels[i])."""
    lab = np.where(supervised, input_ids, -100)
    return np.concatenate([lab[1:], [-100]]).astype(np.int32)


def synthetic_video_item(rng, c: SyntheticSFTConfig) -> MLLMDataItem:
    """A chat sample with one clip: im_start + prompt, one vision run per
    merged frame (vision_start, frame_seqlen placeholders, vision_end), the
    question, im_end, then im_start + answer + im_end, supervised."""
    gt = c.num_frames // c.temporal_patch_size
    gh = gw = c.img_size // c.patch_size
    m = c.spatial_merge_size
    per_frame = gh * gw // (m * m)
    n_pre, n_q, n_ans = c.video_text_tokens
    parts = [[c.im_start_token_id], _text_ids(rng, n_pre, c)]
    for _ in range(gt):
        parts += [[c.vision_start_token_id], [c.video_token_id] * per_frame,
                  [c.vision_end_token_id]]
    parts += [_text_ids(rng, n_q, c), [c.im_end_token_id]]
    prompt = np.concatenate([np.asarray(p, np.int64) for p in parts])
    answer = np.concatenate([[c.im_start_token_id], _text_ids(rng, n_ans, c),
                             [c.im_end_token_id]])
    ids = np.concatenate([prompt, answer]).astype(np.int32)
    supervised = np.arange(len(ids)) >= len(prompt) + 1
    grids = np.tile(np.array([[1, gh, gw]]), (gt, 1))
    pos = get_rope_index_3d(ids, grids, video_token_id=c.video_token_id,
                            vision_start_token_id=c.vision_start_token_id,
                            spatial_merge_size=m)
    plan = MediaPlan(path="synthetic", frame_indices=list(range(c.num_frames)),
                     resize_hw=(c.img_size, c.img_size), grid_thw=(gt, gh, gw),
                     timestamps=[float(t) for t in range(gt)], merge_length=m * m)
    return MLLMDataItem(ids, _shifted(ids, supervised), pos, [plan])


def synthetic_text_item(rng, n: int, c: SyntheticSFTConfig) -> MLLMDataItem:
    """A text-only sample of n tokens: im_start + prompt + im_end, then an
    answer (about the last half) that is supervised."""
    ids = _text_ids(rng, n, c).astype(np.int32)
    cut = n // 2
    ids[0], ids[cut - 1], ids[cut], ids[-1] = (c.im_start_token_id, c.im_end_token_id,
                                               c.im_start_token_id, c.im_end_token_id)
    supervised = np.arange(n) > cut
    return MLLMDataItem(ids, _shifted(ids, supervised), get_rope_index_3d(ids, None), [])


def synthetic_sft_items(rng, pack_max_length: int, c: SyntheticSFTConfig) -> list:
    """One video sample, then text samples until the next one drawn would
    not fit the row (the rest of the row is padding)."""
    items = [synthetic_video_item(rng, c)]
    used, (lo, hi) = items[0].num_tokens, c.text_lengths
    while (n := int(rng.integers(lo, hi + 1))) <= pack_max_length - used:
        items.append(synthetic_text_item(rng, n, c))
        used += n
    return items


def synthetic_sft_stream(c: SyntheticSFTConfig, *, batch_size: int, pack_max_length: int,
                         pad_token_id: int = 0, seed: int = 0) -> Iterator[dict]:
    """Endless packed SFT batches, made from `seed`: each of the B rows is
    the video-bearing pack of `pack_mllm_items(synthetic_sft_items(...),
    one_video_per_pack=True)` with its clip, (B, T, H, W, 3) standard-normal
    pixels."""
    rng = np.random.default_rng(seed)
    while True:
        rows = []
        for _ in range(batch_size):
            items = synthetic_sft_items(rng, pack_max_length, c)
            packed = pack_mllm_items(items, pack_max_length, pad_token_id=pad_token_id,
                                     one_video_per_pack=True)
            assert packed["packs"][0][0] == 0 and len(packed["packs"]) == 1, packed["packs"]
            rows.append(packed)
        yield {
            "input_ids": np.concatenate([r["input_ids"] for r in rows]),
            "labels": np.concatenate([r["labels"] for r in rows]),
            "segment_ids": np.concatenate([r["segment_ids"] for r in rows]),
            "position_ids": np.concatenate([r["position_ids"] for r in rows], axis=1),
            "video": rng.standard_normal(
                (batch_size, c.num_frames, c.img_size, c.img_size, 3)).astype(np.float32),
        }
