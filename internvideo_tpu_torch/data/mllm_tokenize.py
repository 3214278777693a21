"""MLLM multimodal tokenize function: jsonl sample -> packed token / video
batch, as numpy.

Port of internvideo_tpu/data/mllm_tokenize.py, with the same results:

  * fps-driven frame sampling with min / max clamps (`sample_frames`), the
    pixel-budget smart resize (`video_smart_resize`) and per-merged-frame
    timestamps (`calculate_timestamps`);
  * `MLLMTokenizeFunction`: each <VIDEO_CONTEXT> marker becomes, per merged
    frame, "<ts> <vision_start> <video_pad> * frame_seqlen <vision_end>";
    only assistant spans (and their <im_end>) carry labels, shifted by one;
    3-D mRoPE position grids (`get_rope_index_3d`, the Qwen3-VL
    get_rope_index_3);
  * `load_media` (decode through data/video.py, a numpy bilinear resize,
    [-1, 1] floats) and `mllm_sft_batches`, which packs the items into
    static (B, L) rows with one clip each (`pack_mllm_items(...,
    one_video_per_pack=True)`) for the SFT step. `fixed_grid` pins the
    device grid: the fps / pixel budget still chooses the frames, then the
    clip is resized to the pinned grid.

`synthetic_sft_items` / `synthetic_sft_stream` are the port's own: seeded
random items laid out as the tokenize function lays out a chat sample with
one video (per merged frame: vision_start, frame_seqlen placeholders,
vision_end; labels on the answer only, shifted by one), packed into rows
that carry one clip each, so that an SFT step on the card trains the
vision tower without data files.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from internvideo_tpu_torch.data.packing import PackingResult, soft_pack


# ---------------------------------------------------------------------------
# Frame sampling, pixel budgets (internvideo_tokenize_fn.py:58-130)
# ---------------------------------------------------------------------------


def video_smart_resize(
    num_frames: int,
    height: int,
    width: int,
    *,
    temporal_factor: int = 2,
    factor: int = 28,  # patch_size * merge_size
    min_pixels: int = 128 * 128,
    max_pixels: int = 16 * 16 * 2 * 2 * 2 * 6144,
) -> tuple[int, int]:
    """Round (H, W) to `factor` multiples, scaled so T * H * W fits the budget."""
    if num_frames < temporal_factor:
        raise ValueError(f"t={num_frames} < temporal_factor={temporal_factor}")
    if height < factor or width < factor:
        raise ValueError(f"height/width must be >= {factor}")
    if max(height, width) / min(height, width) > 200:
        raise ValueError("aspect ratio over 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    t_bar = round(num_frames / temporal_factor) * temporal_factor
    if t_bar * h_bar * w_bar > max_pixels:
        beta = math.sqrt((num_frames * height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif t_bar * h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (num_frames * height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def sample_frames(
    origin_total_num_frames: int,
    origin_fps: float,
    *,
    num_frames: Optional[int] = None,
    fps: float = 2.0,
    min_frames: int = 4,
    max_frames: int = 768,
) -> np.ndarray:
    """Uniform indices at ~`fps` sampled frames a second, clamped to the budgets."""
    total = origin_total_num_frames
    if num_frames is None:
        num_frames = int(total / origin_fps * fps)
        num_frames = min(max(num_frames, min_frames), max_frames, total)
    num_frames = max(num_frames, min_frames)
    return np.linspace(0, total - 1, num_frames).round().astype(int)


def calculate_timestamps(
    indices: Sequence[int],
    video_fps: float,
    *,
    merge_size: int = 2,
    timestamps: Optional[list[float]] = None,
) -> tuple[list[int], list[float]]:
    """Pad indices to a merge multiple; average the timestamps per merge window."""
    indices = list(indices)
    if len(indices) % merge_size != 0:
        pad = merge_size - len(indices) % merge_size
        indices.extend(indices[-1] for _ in range(pad))
        if timestamps is not None:
            timestamps.extend(timestamps[-1] for _ in range(pad))
    if timestamps is None:
        timestamps = [i / video_fps for i in indices]
    assert len(timestamps) == len(indices)
    timestamps = [(timestamps[i] + timestamps[i + merge_size - 1]) / 2
                  for i in range(0, len(timestamps), merge_size)]
    return indices, timestamps


# ---------------------------------------------------------------------------
# Config, data items
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLLMTokenizeConfig:
    """Same fields and defaults as internvideo_tpu's MLLMTokenizeConfig."""

    # vision geometry: must match the VisionTowerConfig in use
    patch_size: int = 16
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    # frame / pixel budgets (internvideo_tokenize_fn.py defaults)
    fps: float = 2.0
    min_frames: int = 4
    max_frames: int = 768
    rand_video_max_frames: int = 512
    video_min_total_pixels: int = 4 * 4 * 32 * 28
    video_max_total_pixels: int = 20480 * 4 * 32 * 28
    # special token ids (the Qwen3 family's)
    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    im_start_token_id: int = 151644
    im_end_token_id: int = 151645
    pad_token_id: int = 0
    max_length: Optional[int] = None
    add_timestamps: bool = True
    # pin the device grid (gt, gh, gw): frames and resolution resized to it.
    # None: the free grid (the reference's budgets; for token counting)
    fixed_grid: Optional[tuple[int, int, int]] = None

    @property
    def merge_length(self) -> int:
        return self.spatial_merge_size ** 2

    @property
    def resize_factor(self) -> int:
        return self.patch_size * self.spatial_merge_size


@dataclasses.dataclass
class MediaPlan:
    """Decode / resize instructions for one video."""

    path: str
    frame_indices: list[int]  # into the source video
    resize_hw: tuple[int, int]  # target (H, W) after smart resize
    grid_thw: tuple[int, int, int]  # (gt, gh, gw) before the spatial merge
    timestamps: list[float]  # one per merged frame (len == gt)
    merge_length: int = 4  # spatial_merge_size ** 2

    @property
    def frame_seqlen(self) -> int:
        _, gh, gw = self.grid_thw
        return gh * gw // self.merge_length

    @property
    def num_llm_tokens(self) -> int:
        return self.grid_thw[0] * self.frame_seqlen


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


# ---------------------------------------------------------------------------
# The tokenize function
# ---------------------------------------------------------------------------

VIDEO_MARKER = "<VIDEO_CONTEXT>"


class MLLMTokenizeFunction:
    """sample dict -> MLLMDataItem.

    sample format (a jsonl row):
      {"messages": [{"role": "system|user|assistant|pretrain",
                     "content": "text possibly containing <VIDEO_CONTEXT>"}],
       "videos": [{"path": ..., "width": W, "height": H,
                   "origin_fps": f, "origin_video_length": n,
                   "frames_timestamp": [...]?}]}

    `text_encode` is any str -> list[int] encoder without special tokens
    (e.g. `lambda t: hf_tok(t, add_special_tokens=False)["input_ids"]`).
    """

    def __init__(self, text_encode: Callable[[str], list[int]], cfg: MLLMTokenizeConfig):
        self.encode = text_encode
        self.cfg = cfg

    # -- planning ------------------------------------------------------------

    def plan_video(self, video_info: dict) -> MediaPlan:
        cfg = self.cfg
        origin_fps = float(video_info.get("origin_fps", 30.0))
        vlen = int(video_info["origin_video_length"])
        height = int(video_info.get("height", 224))
        width = int(video_info.get("width", 224))
        fixed = cfg.fixed_grid is not None
        if fixed:
            n_frames = cfg.fixed_grid[0] * cfg.temporal_patch_size
            indices = sample_frames(vlen, origin_fps, num_frames=n_frames,
                                    min_frames=n_frames, max_frames=n_frames)
        else:
            indices = sample_frames(vlen, origin_fps, fps=cfg.fps,
                                    min_frames=cfg.min_frames, max_frames=cfg.max_frames)
        ts = video_info.get("frames_timestamp")
        if ts is not None:
            ts = [ts[i] for i in indices]
        indices, timestamps = calculate_timestamps(
            indices, origin_fps, merge_size=cfg.temporal_patch_size, timestamps=ts)
        if fixed:
            grid = tuple(cfg.fixed_grid)
            rh, rw = grid[1] * cfg.patch_size, grid[2] * cfg.patch_size
        else:
            rh, rw = video_smart_resize(
                len(indices), height, width, temporal_factor=cfg.temporal_patch_size,
                factor=cfg.resize_factor, min_pixels=cfg.video_min_total_pixels,
                max_pixels=cfg.video_max_total_pixels)
            grid = (len(indices) // cfg.temporal_patch_size, rh // cfg.patch_size,
                    rw // cfg.patch_size)
        return MediaPlan(path=video_info.get("path", ""), frame_indices=indices,
                         resize_hw=(rh, rw), grid_thw=grid, timestamps=timestamps,
                         merge_length=cfg.merge_length)

    # -- rendering -----------------------------------------------------------

    def _render_video_placeholder(self, plan: MediaPlan) -> list[int]:
        """Per merged frame: [ts text] <vision_start> <pad> * seqlen <vision_end>
        (replace_video_token :133-216: each frame wrapped on its own)."""
        cfg = self.cfg
        out: list[int] = []
        for ft in range(plan.grid_thw[0]):
            if cfg.add_timestamps:
                out += self.encode(f"<{plan.timestamps[ft]:.1f} seconds>")
            out.append(cfg.vision_start_token_id)
            out += [cfg.video_token_id] * plan.frame_seqlen
            out.append(cfg.vision_end_token_id)
        return out

    def _render_message(self, role: str, content: str, plans: list[MediaPlan],
                        media_cursor: int) -> tuple[list[int], int, list[tuple[int, int]]]:
        """(ids, the new media cursor, the supervised spans)."""
        cfg = self.cfg
        ids: list[int] = [cfg.im_start_token_id]
        ids += self.encode(role + "\n")
        body_start = len(ids)
        for pi, part in enumerate(content.split(VIDEO_MARKER)):
            if pi > 0:
                ids += self._render_video_placeholder(plans[media_cursor])
                media_cursor += 1
            if part:
                ids += self.encode(part)
        ids.append(cfg.im_end_token_id)
        spans = [(body_start, len(ids))] if role == "assistant" else []  # content + im_end
        return ids, media_cursor, spans

    def __call__(self, sample: dict) -> MLLMDataItem:
        cfg = self.cfg
        plans = [self.plan_video(v) for v in sample.get("videos", [])]
        ids: list[int] = []
        label_spans: list[tuple[int, int]] = []
        cursor = 0
        for msg in sample["messages"]:
            base = len(ids)
            mids, cursor, spans = self._render_message(msg["role"], msg["content"], plans,
                                                       cursor)
            ids += mids
            label_spans += [(base + a, base + b) for a, b in spans]
        assert cursor == len(plans), f"{len(plans)} videos but {cursor} markers consumed"

        input_ids = np.asarray(ids, np.int32)
        if cfg.max_length is not None and len(ids) > cfg.max_length:
            input_ids = input_ids[:cfg.max_length]
            # a truncated vision run would desync placeholders and pixels
            n_expected = sum(p.num_llm_tokens for p in plans)
            if int((input_ids == cfg.video_token_id).sum()) != n_expected:
                raise ValueError("max_length truncation cut a vision run; drop this sample")
        labels = np.full_like(input_ids, -100)
        for a, b in label_spans:
            labels[a:min(b, len(labels))] = input_ids[a:min(b, len(labels))]
        # next-token targets, shifted per item before packing so that no
        # target leaks across segments (the loss scores hidden[i] against
        # labels[i])
        labels = np.concatenate([labels[1:], [-100]]).astype(labels.dtype)

        # one (1, gh, gw) grid row per merged frame: every frame is its own
        # vision_start / end run
        grid_rows = []
        for p in plans:
            gt, gh, gw = p.grid_thw
            grid_rows += [(1, gh, gw)] * gt
        grids = np.asarray(grid_rows, np.int32).reshape(-1, 3) if grid_rows else None
        position_ids = get_rope_index_3d(
            input_ids, grids, image_token_id=cfg.image_token_id,
            video_token_id=cfg.video_token_id, vision_start_token_id=cfg.vision_start_token_id,
            spatial_merge_size=cfg.spatial_merge_size)
        return MLLMDataItem(input_ids=input_ids, labels=labels, position_ids=position_ids,
                            media=plans)


# ---------------------------------------------------------------------------
# Media loading, packing
# ---------------------------------------------------------------------------


def load_media(plan: MediaPlan, reader=None) -> np.ndarray:
    """Execute a MediaPlan: decode the frames, bilinear-resize them,
    normalise to float32 in [-1, 1]. Returns (T, H, W, 3)."""
    if reader is None:
        from internvideo_tpu_torch.data.video import read_frames as reader
    frames = reader(plan.path, np.asarray(plan.frame_indices))
    rh, rw = plan.resize_hw
    if frames.shape[1:3] != (rh, rw):
        frames = _bilinear_resize_batch(frames, rh, rw)
    return frames.astype(np.float32) / 127.5 - 1.0


def _bilinear_resize_batch(frames: np.ndarray, rh: int, rw: int) -> np.ndarray:
    """Vectorised bilinear resize, (T, H, W, C) uint8 / float -> (T, rh, rw, C) f32."""
    _, h, w, _ = frames.shape
    ys = (np.arange(rh) + 0.5) * h / rh - 0.5
    xs = (np.arange(rw) + 0.5) * w / rw - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[None, :, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, None, :, None]
    f = frames.astype(np.float32)
    top = f[:, y0][:, :, x0] * (1 - wx) + f[:, y0][:, :, x1] * wx
    bot = f[:, y1][:, :, x0] * (1 - wx) + f[:, y1][:, :, x1] * wx
    return top * (1 - wy) + bot * wy


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


def mllm_sft_batches(jsonl_path: str, tokenize_fn: MLLMTokenizeFunction, *,
                     pack_max_length: int, media_root: str = "", reader=None,
                     loop: bool = True, batch_size: Optional[int] = None):
    """(jsonl + video files) -> packed multimodal batches, streaming.

    Needs cfg.fixed_grid, so that every pack row carries one clip of one
    static shape; text-only rows ride with a zero clip. Yields dicts of the
    SFT engine's batch contract ("input_ids", "labels", "segment_ids",
    "position_ids" (3, B, L), "video"). With batch_size set, rows are
    re-chunked into fixed-size batches across packing rounds.
    """
    cfg = tokenize_fn.cfg
    assert cfg.fixed_grid is not None, "device batching needs a fixed grid"
    with open(jsonl_path) as f:
        rows = [json.loads(line) for line in f if line.strip()]

    # tokenize once: the items are deterministic, only packing and media
    # decode run again each round; malformed rows (marker / video counts
    # raise AssertionError / IndexError, truncation ValueError) are skipped
    items = []
    for row in rows:
        for v in row.get("videos", []):
            if media_root and not os.path.isabs(v.get("path", "")):
                v["path"] = os.path.join(media_root, v["path"])
        try:
            items.append(tokenize_fn(row))
        except (ValueError, IndexError, AssertionError):
            continue

    def round_rows():
        """One packing round -> a list of per-row dicts."""
        packed = pack_mllm_items(items, pack_max_length, pad_token_id=cfg.pad_token_id,
                                 one_video_per_pack=True)
        gt, gh, gw = cfg.fixed_grid
        dummy_shape = (gt * cfg.temporal_patch_size, gh * cfg.patch_size,
                       gw * cfg.patch_size, 3)
        out = []
        for pi, pack in enumerate(packed["packs"]):
            plans = [p for idx in pack for p in items[idx].media]
            if len(plans) > 1:
                continue  # the video-aware packer prevents this
            # a text-only row has no placeholders: its clip's tokens go nowhere
            video = (load_media(plans[0], reader=reader) if plans
                     else np.zeros(dummy_shape, np.float32))
            out.append({"input_ids": packed["input_ids"][pi], "labels": packed["labels"][pi],
                        "segment_ids": packed["segment_ids"][pi],
                        "position_ids": packed["position_ids"][:, pi], "video": video})
        if not out:
            raise ValueError("no usable pack rows (every sample longer than "
                             f"pack_max_length={pack_max_length}?)")
        return out

    def stack(buf):
        return {"input_ids": np.stack([b["input_ids"] for b in buf]),
                "labels": np.stack([b["labels"] for b in buf]),
                "segment_ids": np.stack([b["segment_ids"] for b in buf]),
                "position_ids": np.stack([b["position_ids"] for b in buf], axis=1),
                "video": np.stack([b["video"] for b in buf])}

    buf: list[dict] = []
    while True:
        for r in round_rows():
            buf.append(r)
            if batch_size is not None and len(buf) == batch_size:
                yield stack(buf)
                buf = []
        if batch_size is None and buf:
            yield stack(buf)
            buf = []
        if not loop:
            if buf:  # flush the final partial batch
                yield stack(buf)
            return


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
