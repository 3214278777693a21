"""Prober: per-module activation capture for numeric cross-checking.

Port of internvideo_tpu/utils/prober.py (xtuner's Prober): dump chosen
modules' outputs at chosen steps and diff them against another
implementation. JAX captures flax intermediates; here forward hooks do,
and a module's key is its JAX scope path: `blocks.0.attn` becomes
`blocks_0/attn/__call__`, the root `__call__` (models/convert.py's
index renaming), so that a dump of either package compares with the other
through `compare_dumps` where the module trees coincide. `filter_patterns`
are regexes searched in the scope path (`blocks_0/attn`). A module that
returns a tuple or list of tensors gives one key per item (`#i`); outputs
that are not tensors are listed under `__dropped__`. bf16 outputs are
stored as float32 (numpy has no bf16). The dump layout (step_<n>/<tag>_rank
<r>.npz + a manifest.jsonl of summary stats) and the comparisons are
JAX's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Optional, Sequence

import numpy as np
import torch


def _scope_path(name: str) -> str:
    from internvideo_tpu_torch.models.convert import _jax_path

    return "/".join(_jax_path(name)) if name else ""


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def capture_activations(model: torch.nn.Module, *args,
                        filter_patterns: Optional[Sequence[str]] = None, **kwargs):
    """Run `model(*args, **kwargs)` with the outputs of the modules whose
    scope path matches a pattern captured. Returns (output, {path:
    ndarray})."""
    pats = [re.compile(p) for p in (filter_patterns or [".*"])]
    flat: dict = {}
    dropped: list = []

    def hook_for(path: str):
        key = f"{path}/__call__" if path else "__call__"

        def hook(module, inputs, out):
            items = out if isinstance(out, (tuple, list)) else (out,)
            for i, v in enumerate(items):
                k = key if len(items) == 1 else f"{key}#{i}"
                if isinstance(v, torch.Tensor):
                    flat[k] = _to_numpy(v)
                else:
                    # a parity tool must not pass vacuously: record what it
                    # could not capture so compare_activations can flag it
                    dropped.append(k)

        return hook

    handles = []
    for name, module in model.named_modules():
        path = _scope_path(name)
        if any(p.search(path or "__call__") for p in pats):
            handles.append(module.register_forward_hook(hook_for(path)))
    try:
        out = model(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    if dropped:
        flat["__dropped__"] = np.asarray(dropped)
    return out, flat


def dump_activations(acts: dict, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: v for k, v in acts.items()})


def compare_activations(a: dict, b: dict, *, rtol: float = 1e-2, atol: float = 1e-4) -> dict:
    """Per-tensor max relative error between two dumps; flags mismatches."""
    report = {}
    for k in sorted(set(a) & set(b)):
        x, y = np.asarray(a[k], np.float32), np.asarray(b[k], np.float32)
        if x.shape != y.shape:
            report[k] = {"shape_mismatch": (x.shape, y.shape)}
            continue
        denom = np.maximum(np.abs(y), atol)
        rel = float(np.max(np.abs(x - y) / denom)) if x.size else 0.0
        report[k] = {"max_rel_err": rel, "ok": rel <= rtol}
    report["__missing__"] = sorted(set(a) ^ set(b))
    return report


# Step-scoped dump-to-disk workflow: capture chosen steps / micro-batches,
# write per-rank npz dumps and a manifest.jsonl of summary stats, diff whole
# dump trees across implementations without holding every layer in memory.


@dataclasses.dataclass(frozen=True)
class ProberConfig:
    dump_dir: str
    steps: Sequence[int] = ()  # global steps to capture (empty = never)
    filter_patterns: Optional[Sequence[str]] = None
    rank: int = 0  # process index in multi-process runs
    save_tensors: bool = True  # False: manifest stats only (cheap sweeps)


class Prober:
    """The numeric-debug workflow:

        prober = Prober(ProberConfig("/dumps/torch", steps=(0, 100)))
        if prober.should_capture(step):
            prober.capture(model, batch["video"], step=step, tag="micro0")
        # later: compare_dumps("/dumps/jax", "/dumps/torch", step=100)
    """

    def __init__(self, config: ProberConfig):
        self.config = config

    def should_capture(self, step: int) -> bool:
        return step in set(self.config.steps)

    def capture(self, model: torch.nn.Module, *args, step: int, tag: str = "fwd", **kwargs):
        """Run the forward with activations captured and dump them; returns
        the model output, so the caller's control flow is unchanged."""
        out, acts = capture_activations(model, *args,
                                        filter_patterns=self.config.filter_patterns, **kwargs)
        self.dump(step, tag, acts)
        return out

    def dump(self, step: int, tag: str, acts: dict) -> str:
        cfg = self.config
        step_dir = os.path.join(cfg.dump_dir, f"step_{step:06d}")
        os.makedirs(step_dir, exist_ok=True)
        base = f"{tag}_rank{cfg.rank}"
        entries = []
        for k, v in acts.items():
            arr = np.asarray(v)
            ent = {"path": k, "shape": list(arr.shape), "dtype": str(arr.dtype)}
            if arr.dtype != object and np.issubdtype(arr.dtype, np.number):
                f = arr.astype(np.float64)
                ent.update(
                    mean=float(f.mean()) if f.size else 0.0,
                    std=float(f.std()) if f.size else 0.0,
                    absmax=float(np.abs(f).max()) if f.size else 0.0,
                    nan=int(np.isnan(f).sum()),
                    inf=int(np.isinf(f).sum()),
                )
            entries.append(ent)
        if cfg.save_tensors:
            np.savez(os.path.join(step_dir, base + ".npz"), **acts)
        manifest = os.path.join(step_dir, base + "_manifest.jsonl")
        with open(manifest, "w") as fh:
            for ent in entries:
                fh.write(json.dumps(ent) + "\n")
        return manifest


def load_dump(dump_dir: str, step: int, tag: str = "fwd", rank: int = 0) -> dict:
    path = os.path.join(dump_dir, f"step_{step:06d}", f"{tag}_rank{rank}.npz")
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def load_manifest(dump_dir: str, step: int, tag: str = "fwd", rank: int = 0) -> list:
    path = os.path.join(dump_dir, f"step_{step:06d}", f"{tag}_rank{rank}_manifest.jsonl")
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def compare_dumps(dir_a: str, dir_b: str, *, step: int, tag: str = "fwd", rank: int = 0,
                  rtol: float = 1e-2, atol: float = 1e-4) -> dict:
    """Diff two implementations' dumps of the same step / tag / rank:
    tensor by tensor when both saved tensors, else by the manifests'
    mean / std / absmax within rtol (the report then has 'stats_only')."""
    try:
        a, b = load_dump(dir_a, step, tag, rank), load_dump(dir_b, step, tag, rank)
        return compare_activations(a, b, rtol=rtol, atol=atol)
    except FileNotFoundError:
        ma = {e["path"]: e for e in load_manifest(dir_a, step, tag, rank)}
        mb = {e["path"]: e for e in load_manifest(dir_b, step, tag, rank)}
        report: dict = {"stats_only": True}
        for k in sorted(set(ma) & set(mb)):
            ea, eb = ma[k], mb[k]
            if ea["shape"] != eb["shape"]:
                report[k] = {"shape_mismatch": (ea["shape"], eb["shape"])}
                continue
            errs = {}
            for stat in ("mean", "std", "absmax"):
                if stat in ea and stat in eb:
                    errs[stat] = abs(ea[stat] - eb[stat]) / max(abs(eb[stat]), atol)
            report[k] = {
                "stat_rel_err": errs,
                "ok": all(e <= rtol for e in errs.values()),
                "nan": ea.get("nan", 0) + eb.get("nan", 0),
            }
        report["__missing__"] = sorted(set(ma) ^ set(mb))
        return report
