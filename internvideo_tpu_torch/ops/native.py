"""ctypes bindings for the C++ host ops, with their plain numpy versions.

Port of internvideo_tpu/ops/native.py: temporal NMS and soft-NMS
(`native/temporal_nms.cpp`, the reference's nms_cpu) and libMR's Weibull
meta-recognition (`native/weibull_mr.cpp`). Sequential, data-dependent
host work: it runs on the CPU whatever device the model is on.

The two sources are compiled as they are, with the host `g++`, into
`build/internvideo_tpu_torch/libivt_native-<hash>.so` at first use (the
hash covers the sources and the flags, so an edited source never loads a
stale build); nothing is written under `native/`. A failed build or load
raises: unlike the JAX package (:33-40), nothing falls back to numpy. The
numpy versions (`_temporal_nms_np`, `_soft_temporal_nms_np`,
`MetaRecognition._fit_high_np`, `_w_score_np`) are the plain versions the
tests hold the library against; no entry point calls them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from internvideo_tpu_torch.ops._build import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCES = ("temporal_nms.cpp", "weibull_mr.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")  # native/Makefile's


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libivt_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile native/*.cpp with the host C++ compiler unless a library for
    these sources exists; return its path. Raises if the compiler is
    missing or fails."""
    out = _library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found; the native host ops cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(
        [cxx, *CXX_FLAGS, *(str(NATIVE_DIR / s) for s in SOURCES), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {SOURCES}:\n{res.stdout}")
    os.replace(tmp, out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the native library, with its C signatures."""
    lib = ctypes.CDLL(str(build()))
    i, f, d, p = ctypes.c_int, ctypes.c_float, ctypes.c_double, ctypes.c_void_p
    lib.temporal_nms.argtypes = [p, p, i, f, i, p]  # segs, scores, n, iou thr, max_keep, keep
    lib.temporal_nms.restype = i
    lib.soft_temporal_nms.argtypes = [p, p, i, f, f, f, i, p, p]  # ..., method, scores, order
    lib.soft_temporal_nms.restype = i
    lib.mr_fit_high.argtypes = [p, i, i, p, p, p]  # data, n, tail, shape, scale, translate
    lib.mr_fit_high.restype = i
    lib.mr_w_score.argtypes = [p, i, d, d, d, p]  # x, n, shape, scale, translate, out
    lib.mr_w_score.restype = None
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# ---------------------------------------------------------------------------
# Temporal NMS
# ---------------------------------------------------------------------------


def temporal_nms(
    segments: np.ndarray,  # (N, 2) [start, end]
    scores: np.ndarray,  # (N,)
    iou_threshold: float = 0.5,
    max_keep: Optional[int] = None,
) -> np.ndarray:
    """Indices of kept segments, score-descending."""
    segments = np.ascontiguousarray(segments, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    n = len(scores)
    keep = np.empty(n, np.int32)
    m = load_library().temporal_nms(_ptr(segments), _ptr(scores), n, iou_threshold,
                                    max_keep or n, _ptr(keep))
    return keep[:m].copy()


def _temporal_nms_np(segments, scores, iou_threshold, max_keep):
    """Plain version of `temporal_nms` (JAX :84)."""
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(len(scores), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        if len(keep) >= max_keep:
            break
        s1, e1 = segments[i]
        s2, e2 = segments[:, 0], segments[:, 1]
        inter = np.maximum(0, np.minimum(e1, e2) - np.maximum(s1, s2))
        union = (e1 - s1) + (e2 - s2) - inter
        iou = np.where(union > 0, inter / union, 0)
        suppressed |= iou > iou_threshold
        suppressed[i] = True
    return np.asarray(keep, np.int32)


def soft_temporal_nms(
    segments: np.ndarray,
    scores: np.ndarray,
    iou_threshold: float = 0.5,
    sigma: float = 0.5,
    min_score: float = 1e-3,
    method: str = "gaussian",
) -> tuple[np.ndarray, np.ndarray]:
    """(kept_indices, decayed_scores)."""
    segments = np.ascontiguousarray(segments, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    n = len(scores)
    out_s = np.empty(n, np.float32)
    out_i = np.empty(n, np.int32)
    m = load_library().soft_temporal_nms(
        _ptr(segments), _ptr(scores), n, iou_threshold, sigma, min_score,
        1 if method == "gaussian" else 0, _ptr(out_s), _ptr(out_i))
    return out_i[:m].copy(), out_s[:m].copy()


def _soft_temporal_nms_np(segments, scores, iou_threshold=0.5, sigma=0.5, min_score=1e-3,
                          method="gaussian"):
    """Plain version of `soft_temporal_nms` (JAX :128)."""
    segments = np.ascontiguousarray(segments, np.float32)
    s = np.array(scores, np.float32)
    n = len(s)
    done = np.zeros(n, bool)
    idxs, vals = [], []
    for _ in range(n):
        cand = np.where(~done & (s > min_score))[0]
        if len(cand) == 0:
            break
        best = cand[np.argmax(s[cand])]
        done[best] = True
        idxs.append(best)
        vals.append(s[best])
        s1, e1 = segments[best]
        s2, e2 = segments[:, 0], segments[:, 1]
        inter = np.maximum(0, np.minimum(e1, e2) - np.maximum(s1, s2))
        union = (e1 - s1) + (e2 - s2) - inter
        iou = np.where(union > 0, inter / union, 0)
        live = ~done
        if method == "gaussian":
            s[live] *= np.exp(-iou[live] ** 2 / sigma)
        else:
            dec = iou > iou_threshold
            s[live & dec] *= 1 - iou[live & dec]
    return np.asarray(idxs, np.int32), np.asarray(vals, np.float32)


# ---------------------------------------------------------------------------
# libMR Weibull meta-recognition
# ---------------------------------------------------------------------------


def _w_score_np(x, shape, scale, translate):
    """Plain version of `MetaRecognition.w_score` (the Weibull CDF)."""
    v = np.asarray(x, np.float64) + translate
    return np.where(v <= 0, 0.0, 1.0 - np.exp(-((np.maximum(v, 0) / scale) ** shape)))


class MetaRecognition:
    """Extreme-value Weibull model over tail distances (libMR equivalent)."""

    def __init__(self):
        self.shape = None
        self.scale = None
        self.translate = 0.0

    def fit_high(self, data: np.ndarray, tail_size: int = 20) -> bool:
        data = np.ascontiguousarray(data, np.float64)
        shape, scale, trans = ctypes.c_double(), ctypes.c_double(), ctypes.c_double()
        ok = load_library().mr_fit_high(
            _ptr(data), len(data), tail_size, ctypes.addressof(shape),
            ctypes.addressof(scale), ctypes.addressof(trans))
        if ok:
            self.shape, self.scale, self.translate = shape.value, scale.value, trans.value
        return bool(ok)

    def _fit_high_np(self, data, tail_size):
        """Plain version of `fit_high` (JAX :184)."""
        tail = np.sort(data)[-tail_size:]
        t = 1.0 - tail[0] if tail[0] <= 0 else 0.0
        tail = tail + t
        # Newton on the Weibull profile likelihood
        lx = np.log(tail)
        k = 1.0
        for _ in range(100):
            xk = tail ** k
            a, b, c = (xk * lx).sum(), xk.sum(), (xk * lx * lx).sum()
            f = a / b - 1.0 / k - lx.mean()
            fp = (c * b - a * a) / (b * b) + 1.0 / k**2
            step = f / fp
            k -= step
            k = max(k, 1e-6)
            if abs(step) < 1e-10:
                break
        self.shape = k
        self.scale = float((tail**k).mean() ** (1.0 / k))
        self.translate = t
        return np.isfinite(k)

    def w_score(self, x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, np.float64)
        out = np.empty_like(x)
        load_library().mr_w_score(_ptr(x), len(x), self.shape, self.scale, self.translate,
                                  _ptr(out))
        return out
