"""Host-side video decode and frame sampling, as numpy.

Port of internvideo_tpu/data/video.py, with the same results: the frame
samplers are index math on a `np.random.Generator` (rand: a uniform index
inside each of `num_frames` equal bins; middle: the bin centres; dense: a
fixed-fps window with multi-clip offsets; sparse: TSN segments), and the
readers return uint8 (T, H, W, 3) RGB from raw `.npy` clips, image
directories, GIFs and containers (PyAV first, OpenCV otherwise).

cv2, PIL and PyAV are imported inside the branch that needs them, so that
a `.npy` path needs none of them. PyAV is optional: without it a container
goes to cv2, as in the JAX package.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np

_IMAGE_EXTS = (".jpg", ".jpeg", ".png")


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------


def sample_frame_indices(
    num_frames: int,
    vlen: int,
    *,
    sample: str = "rand",
    fix_start: Optional[int] = None,
    input_fps: float = 30.0,
    max_num_frames: int = -1,
    clip_idx: int = 0,
    num_clips: int = 1,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    rng = rng or np.random.default_rng()
    if sample in ("rand", "middle"):
        acc_samples = min(num_frames, vlen)
        # split [0, vlen) into acc_samples bins, pick an in-bin position
        edges = np.linspace(0, vlen, acc_samples + 1).astype(int)
        starts, ends = edges[:-1], np.maximum(edges[1:], edges[:-1] + 1)
        if sample == "rand":
            idx = np.array([rng.integers(s, e) for s, e in zip(starts, ends)])
        elif fix_start is not None:
            idx = np.minimum(starts + fix_start, vlen - 1)
        else:
            idx = (starts + ends) // 2
        idx = np.minimum(idx, vlen - 1)
        if len(idx) < num_frames:  # loop-pad short videos
            idx = np.resize(idx, num_frames)
        return idx
    if sample == "dense":
        # a fixed-duration window at one of `num_clips` temporal offsets
        span = min(vlen, int(num_frames * input_fps / 30.0 * 2))
        max_start = max(vlen - span, 0)
        start = (
            int(max_start * clip_idx / max(num_clips - 1, 1))
            if num_clips > 1
            else (rng.integers(0, max_start + 1) if max_start else 0)
        )
        return np.linspace(start, start + span - 1, num_frames).astype(int)
    if sample == "sparse":
        # TSN segments; a deterministic offset per clip at test time
        edges = np.linspace(0, vlen, num_frames + 1)
        if num_clips > 1:
            frac = clip_idx / max(num_clips - 1, 1)
            idx = edges[:-1] + (edges[1:] - edges[:-1] - 1) * frac
            return idx.astype(int)
        return np.array(
            [rng.integers(int(s), max(int(e), int(s) + 1))
             for s, e in zip(edges[:-1], edges[1:])]
        ).clip(0, vlen - 1)
    raise ValueError(f"unknown sampling {sample!r}")


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _pyav():
    """The PyAV module, or None where it is not installed."""
    try:
        import av
    except ImportError:
        return None
    return av


def read_frames_npy(path: str, indices: np.ndarray) -> np.ndarray:
    arr = np.load(path, mmap_mode="r")
    return np.asarray(arr[indices])


def read_frames_av(path: str, indices: np.ndarray) -> np.ndarray:
    """PyAV sequential decode of explicit `indices` (frame-accurate): one
    pass collecting the wanted frames, stopping at the last of them."""
    av = _pyav()
    if av is None:
        raise ImportError("PyAV is not installed")
    want = set(int(i) for i in indices)
    last_want = max(want)
    frames = {}
    with av.open(path) as container:
        stream = container.streams.video[0]
        stream.thread_type = "AUTO"  # frame and slice threading in ffmpeg
        for i, frame in enumerate(container.decode(stream)):
            if i in want:
                frames[i] = frame.to_ndarray(format="rgb24")
            if i >= last_want:
                break
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    last = frames[max(frames)]
    return np.stack([frames.get(int(i), last) for i in indices])


def _av_video_length(path: str) -> int:
    with _pyav().open(path) as container:
        stream = container.streams.video[0]
        if stream.frames:  # container metadata when present
            return int(stream.frames)
        return sum(1 for _ in container.decode(stream))


def read_frames_cv2(path: str, indices: np.ndarray) -> np.ndarray:
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    frames = {}
    want = sorted(set(int(i) for i in indices))
    pos = 0
    for target in want:
        if target != pos:
            cap.set(cv2.CAP_PROP_POS_FRAMES, target)
            pos = target
        ok, frame = cap.read()
        pos += 1
        if not ok:
            break
        frames[target] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    last = frames[max(frames)]
    return np.stack([frames.get(int(i), last) for i in indices])


def read_frames_gif(path: str, indices: np.ndarray) -> np.ndarray:
    from PIL import Image, ImageSequence

    img = Image.open(path)
    all_frames = [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(img)]
    return np.stack([all_frames[min(int(i), len(all_frames) - 1)] for i in indices])


def _image_files(path: str) -> list[str]:
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if f.lower().endswith(_IMAGE_EXTS))


def read_frames_imgdir(path: str, indices: np.ndarray) -> np.ndarray:
    from PIL import Image

    files = _image_files(path)
    return np.stack([
        np.asarray(Image.open(files[min(int(i), len(files) - 1)]).convert("RGB"))
        for i in indices
    ])


def video_length(path: str) -> int:
    if path.endswith(".npy"):
        return np.load(path, mmap_mode="r").shape[0]
    if os.path.isdir(path):
        return len(_image_files(path))
    if path.lower().endswith(".gif"):
        from PIL import Image, ImageSequence

        return sum(1 for _ in ImageSequence.Iterator(Image.open(path)))
    if _pyav() is not None:
        try:
            return _av_video_length(path)
        except Exception:  # noqa: BLE001 - a corrupt container: try cv2
            pass
    import cv2

    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


def read_frames(path: str, indices: np.ndarray) -> np.ndarray:
    """Decode explicit frame `indices` as (T, H, W, 3) uint8 RGB (the
    tokenize function's path, where the frame plan precedes the decode)."""
    indices = np.asarray(indices)
    if path.endswith(".npy"):
        return read_frames_npy(path, indices)
    if os.path.isdir(path):
        return read_frames_imgdir(path, indices)
    if path.lower().endswith(".gif"):
        return read_frames_gif(path, indices)
    # containers: PyAV (frame-accurate) first, the cv2 seek otherwise
    if _pyav() is not None:
        try:
            return read_frames_av(path, indices)
        except Exception:  # noqa: BLE001
            pass
    return read_frames_cv2(path, indices)


def read_video(
    path: str,
    num_frames: int,
    *,
    sample: str = "rand",
    clip_idx: int = 0,
    num_clips: int = 1,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Decode `num_frames` RGB frames (T, H, W, 3) uint8 from any source."""
    vlen = video_length(path)
    idx = sample_frame_indices(num_frames, vlen, sample=sample, clip_idx=clip_idx,
                               num_clips=num_clips, rng=rng)
    return read_frames(path, idx)
