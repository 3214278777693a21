"""Builds the port's CUDA kernels and binds them with ctypes.

Every `internvideo_tpu_torch/csrc/*.cu` file is compiled by its own `nvcc`
process, all started together, and the objects are linked into one shared
library with a plain C interface, at first use, into
`build/internvideo_tpu_torch/` beside the package. The library's file name
carries a hash of the sources and the flags, so an edited source never loads
a stale build. Nothing is downloaded and no PyTorch header is compiled, which
keeps the build to seconds.

Only a CUDA tensor reaches this module: on a machine without `nvcc` the
build raises, and the caller raises with it (there is no fallback).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parents[1]
CSRC_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "internvideo_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills per kernel, into the log
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built"
    )


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def _library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libivt_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them exists; return its path.

    One nvcc per source runs in parallel (`-c` to an object), then one link.
    The compilers' output (ptxas register and spill counts) is kept beside
    the library as `<name>.log`.
    """
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in jobs:
        text = proc.communicate()[0]
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(log))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(log))
    os.replace(tmp, out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with its C signatures."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ivt_flash_fwd.argtypes = [
        i, p, p, p, p, p,            # dtype, q, k, v, o, lse
        i, i, i, i, i,               # B, Sq, Sk, H, D
        ctypes.POINTER(ctypes.c_longlong),  # 12 element strides
        ctypes.c_float, p,           # softmax scale, stream
    ]
    lib.ivt_flash_fwd.restype = i
    lib.ivt_small_s_fwd.argtypes = lib.ivt_flash_fwd.argtypes
    lib.ivt_small_s_fwd.restype = i
    lib.ivt_flash_fwd_causal.argtypes = [
        i, p, p, p, p, p,            # dtype, q, k, v, o, lse
        p, p,                        # q / kv segment ids (or null)
        i, i, i, i, i, i,            # B, Sq, Sk, H, D_qk, D_v
        ctypes.POINTER(ctypes.c_longlong),  # 12 element strides
        ctypes.c_float, i, i,        # softmax scale, causal, q position offset
        i, i, p,                     # K/V heads, window (<= 0: none), stream
    ]
    lib.ivt_flash_fwd_causal.restype = i
    lib.ivt_paged_decode.argtypes = [
        i, p, p, p, p, p,            # dtype, q_lat, q_pe, pages, block tables, seq lens
        p, p, p,                     # split partials (acc, m/l), out
        i, i, i, i,                  # B, H, R, P
        i, i, i, i,                  # page size, max pages, split length, splits
        ctypes.c_float, p,           # softmax scale, stream
    ]
    lib.ivt_paged_decode.restype = i
    lib.ivt_int8_gemm.argtypes = [
        i, i, p, p, i, p,            # x dtype, out dtype, x, w_q, w_q row pitch, w_scale
        p, p, i, p,                  # x codes / scales scratch, codes row pitch, out
        i, i, i, p,                  # M, N, K, stream
    ]
    lib.ivt_int8_gemm.restype = i
    ll, f = ctypes.c_longlong, ctypes.c_float
    lib.ivt_fused_qkv_rstd.argtypes = [
        i, p, p, p,                  # dtype, qkv, q_rstd, k_rstd
        i, i, i, ll, ll,             # B, S, W, qkv batch / seq strides
        f, p,                        # eps, stream
    ]
    lib.ivt_fused_qkv_rstd.restype = i
    lib.ivt_fused_qkv_fwd.argtypes = [
        i, p, p, p, p, p, p,         # dtype, qkv, q_rstd, k_rstd, q_w, k_w, o
        i, i, i, i,                  # B, S, H, D
        ll, ll, ll, ll, ll,          # qkv batch / seq strides, o batch / seq / head strides
        f, p,                        # softmax scale, stream
    ]
    lib.ivt_fused_qkv_fwd.restype = i
    lib.ivt_fused_qkv_rstd_normed_k.argtypes = [
        p, p, p, p, p,               # qkv (bf16), q_rstd, k_rstd, k_w, normed k out
        i, i, i, ll, ll,             # B, S, W, qkv batch / seq strides
        f, p,                        # eps, stream
    ]
    lib.ivt_fused_qkv_rstd_normed_k.restype = i
    lib.ivt_fused_qkv_large_fwd.argtypes = [
        i, p, p, p, p, p, p, p,      # dtype, qkv, normed k, q_rstd, k_rstd, q_w, k_w, o
        i, i, i, i,                  # B, S, H, D
        ll, ll, ll, ll, ll,          # qkv batch / seq strides, o batch / seq / head strides
        f, p,                        # softmax scale, stream
    ]
    lib.ivt_fused_qkv_large_fwd.restype = i
    lib.ivt_fused_add_rms_norm.argtypes = [
        i, i, i, p, p, p,            # x / residual / weight dtypes, x, residual, weight
        p, p, ll, i, f, p,           # y, newres, rows, D, eps, stream
    ]
    lib.ivt_fused_add_rms_norm.restype = i
    lib.ivt_fused_ls_add_rms_norm.argtypes = [
        i, i, i, i, p, p, p, p,      # h / residual / gamma / weight dtypes, h, residual, gamma, weight
        p, p, ll, i, f, p,           # y, newres, rows, D, eps, stream
    ]
    lib.ivt_fused_ls_add_rms_norm.restype = i
    for name, outs in (("ivt_flash_bwd_dq", [p]), ("ivt_flash_bwd_dkv", [p, p]),
                       ("ivt_small_s_bwd_dq", [p]), ("ivt_small_s_bwd_dkv", [p, p])):
        fn = getattr(lib, name)
        fn.argtypes = [
            i, p, p, p, p, p, p,     # dtype, q, k, v, dO, lse, delta
            *outs,                   # dq | dk, dv
            i, i, i, i, i,           # B, Sq, Sk, H, D
            ctypes.POINTER(ctypes.c_longlong),  # 18 element strides
            ctypes.c_float, p,       # softmax scale, stream
        ]
        fn.restype = i
    for name in ("ivt_flash_bwd_causal_dq", "ivt_flash_bwd_causal_dkv"):
        fn = getattr(lib, name)
        fn.argtypes = [
            i, p, p, p, p, p, p,     # dtype, q, k, v, dO, lse, delta
            p, p, p, p, p,           # q / kv segment ids (or null), dq, dk, dv
            i, i, i, i, i, i,        # B, Sq, Sk, H, D_qk, D_v
            ctypes.POINTER(ctypes.c_longlong),  # 21 element strides
            ctypes.c_float, i, i,    # softmax scale, causal, q position offset
            i, i, p,                 # K/V heads, window (<= 0: none), stream
        ]
        fn.restype = i
    return lib
