"""Checkpointing: step-tagged torch.save files with retention, and the
safetensors / HF bridge.

The torch-native counterpart of internvideo_tpu/core/checkpoint.py
`CheckpointManager` (same API: save(step, state, force), restore,
latest_step, wait, max_to_keep, save_interval_steps). A checkpoint is one
`torch.save` file `step_<step>.pt` holding the model's state_dict, the
optimizer's, the step, the state's generator and any EMA params, written
to a temporary name and renamed, so a crash never leaves a partial file.
Saves are synchronous, so `wait` has nothing to wait for. Orbax
compatibility is not a goal. `restore_model` reads a step file and loads
only the model's weights (the eval CLI's checkpoint path); `restore` loads
the optimizer, generator and EMA of its payload on top.

The save policy is orbax's default: a step is saved when it is past the
latest saved one and either no checkpoint exists yet or it is a multiple
of `save_interval_steps`; `force` saves regardless of the interval.

The safetensors bridge is the counterpart of internvideo_tpu/core/
checkpoint.py:74-251 on torch tensors: `read_safetensors` /
`write_safetensors` (header + raw little-endian buffers), the index-aware
`load_hf_checkpoint`, `save_hf_checkpoint` (single `model.safetensors` or
`model-0000i-of-0000n.safetensors` shards + index, stale shards and index
removed first) and `flatten_params` / `unflatten_params`. numpy cannot
hold bf16 or fp8 without ml_dtypes, so tensors stay torch: BF16 is
torch.bfloat16, F8_E4M3 / F8_E5M2 are torch.float8_e4m3fn / float8_e5m2.
A file either package writes reads back bit for bit in the other, and the
same tensors give the same bytes, except that a 0-d tensor keeps the
format's shape [] where JAX's writer makes it [1].
"""

from __future__ import annotations

import json
import os
import re
import sys
from typing import Mapping, Optional

import numpy as np
import torch

from internvideo_tpu_torch.train.state import TrainState

_FILE = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _FILE.match(f)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def save(self, step: int, state: TrainState, *, force: bool = False) -> bool:
        """Save `state` as step `step` if the policy says so; True if saved."""
        latest = self.latest_step()
        if not force:
            if latest is not None and latest >= step:
                return False
            if latest is not None and step % self.save_interval_steps:
                return False
        payload = {
            "step": state.step,
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "generator": state.generator.get_state(),
            "ema_params": state.ema_params,
        }
        tmp = self._path(step) + f".{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        return True

    def restore(self, state: TrainState, step: Optional[int] = None) -> Optional[TrainState]:
        """Load step `step` (default: the latest) into `state` in place and
        return it; None when there is no checkpoint."""
        payload = self.restore_model(state.model, step)
        if payload is None:
            return None
        state.optimizer.load_state_dict(payload["optimizer"])
        state.generator.set_state(payload["generator"].cpu())
        state.step = int(payload["step"])
        if payload["ema_params"] is not None:
            state.ema_params = payload["ema_params"]
        return state

    def restore_model(self, model: torch.nn.Module, step: Optional[int] = None) -> Optional[dict]:
        """Load step `step`'s (default: the latest) model weights into
        `model` and return the step's whole payload; None when there is no
        checkpoint. The one reader of the step files."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        dev = next(model.parameters()).device
        payload = torch.load(self._path(step), map_location=dev, weights_only=False)
        model.load_state_dict(payload["model"])
        return payload

    def wait(self) -> None:
        """Saves are synchronous; nothing is in flight."""


# ---------------------------------------------------------------------------
# safetensors / HF bridge
# ---------------------------------------------------------------------------

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "U16": torch.uint16, "U32": torch.uint32, "U64": torch.uint64,
    "BOOL": torch.bool,
}
_TAGS = {v: k for k, v in _DTYPES.items()}
# numpy dtypes that only ml_dtypes provides, by name -> their torch dtype
_NUMPY_EXTRA = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
                "float8_e5m2": torch.float8_e5m2}


def as_tensor(a) -> torch.Tensor:
    """A torch tensor of `a` (a tensor, or a numpy array, bf16 / fp8
    ml_dtypes arrays reinterpreted bit for bit); a tensor is returned as
    it is."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name in _NUMPY_EXTRA:
        bits = np.ascontiguousarray(a).view(np.uint16 if a.dtype.itemsize == 2 else np.uint8)
        return torch.from_numpy(bits.copy()).view(_NUMPY_EXTRA[a.dtype.name])
    return torch.from_numpy(np.array(a, copy=True))


def _check_byteorder() -> None:
    if sys.byteorder != "little":
        raise RuntimeError("safetensors files are little-endian; this host is not")


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """safetensors file -> {name: CPU tensor}, in the header's order. The
    data region is read once into one uint8 buffer; a tensor whose offset
    is a multiple of its element size is a view of it, another a copy."""
    _check_byteorder()
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size - 8 - n
        buf = torch.empty(size, dtype=torch.uint8)  # not zero-filled, unlike a bytearray
        if size and f.readinto(memoryview(buf.numpy())) != size:
            raise ValueError(f"{path}: truncated safetensors file")
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype = _DTYPES[meta["dtype"]]
        except KeyError:
            raise ValueError(f"unsupported safetensors dtype {meta['dtype']!r} for tensor "
                             f"{name!r}") from None
        start, end = meta["data_offsets"]
        seg = buf[start:end]
        itemsize = torch.empty((), dtype=dtype).element_size()
        if start % itemsize:
            seg = seg.clone()
        out[name] = seg.view(dtype).reshape(meta["shape"])
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor]) -> None:
    """{name: tensor or numpy array} -> one safetensors file, the header
    written as internvideo_tpu's writer writes it (json.dumps, tensors in
    the given order, no padding), so the same tensors give the same bytes."""
    _check_byteorder()
    header, items, offset = {}, [], 0
    for name, a in tensors.items():
        t = as_tensor(a).detach()
        try:
            tag = _TAGS[t.dtype]
        except KeyError:
            raise ValueError(f"cannot serialize dtype {t.dtype} of tensor {name!r} to "
                             "safetensors") from None
        nb = _nbytes(t)
        header[name] = {"dtype": tag, "shape": list(t.shape), "data_offsets": [offset, offset + nb]}
        offset += nb
        items.append(t)
    hdr = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(hdr).to_bytes(8, "little"))
        f.write(hdr)
        for t in items:
            if t.numel():
                f.write(t.cpu().contiguous().reshape(-1).view(torch.uint8).numpy().data)


def load_hf_checkpoint(directory: str) -> dict[str, torch.Tensor]:
    """All safetensors shards of an HF checkpoint directory: the shards the
    index names when `model.safetensors.index.json` exists, else every
    `*.safetensors` file, in name order."""
    index = os.path.join(directory, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            files = sorted(set(json.load(f)["weight_map"].values()))
    else:
        files = sorted(fn for fn in os.listdir(directory) if fn.endswith(".safetensors"))
    tensors: dict[str, torch.Tensor] = {}
    for fn in files:
        tensors.update(read_safetensors(os.path.join(directory, fn)))
    return tensors


def save_hf_checkpoint(directory: str, tensors: Mapping[str, torch.Tensor], *,
                       shard_size_bytes: int = 4 * 1024**3) -> list[str]:
    """Write tensors as HF-layout safetensors: one `model.safetensors`, or
    shards of at most `shard_size_bytes` (a tensor larger than that gets a
    shard of its own) named `model-0000i-of-0000n.safetensors` with
    `model.safetensors.index.json`. The index and model shards of an
    earlier export are removed first: the loader prefers the index, so a
    leftover one would shadow a fresh single-file export. Returns the file
    names written."""
    os.makedirs(directory, exist_ok=True)
    for fn in os.listdir(directory):
        if fn == "model.safetensors.index.json" or (
                fn.startswith("model") and fn.endswith(".safetensors")):
            os.remove(os.path.join(directory, fn))
    shards: list[dict] = [{}]
    sizes = [0]
    for name, a in tensors.items():
        nb = _nbytes(as_tensor(a))
        if sizes[-1] + nb > shard_size_bytes and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][name] = a
        sizes[-1] += nb
    total = len(shards)
    weight_map, files = {}, []
    for i, shard in enumerate(shards):
        fn = ("model.safetensors" if total == 1
              else f"model-{i + 1:05d}-of-{total:05d}.safetensors")
        write_safetensors(os.path.join(directory, fn), shard)
        files.append(fn)
        for k in shard:
            weight_map[k] = fn
    if total > 1:
        with open(os.path.join(directory, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": int(sum(sizes))}, "weight_map": weight_map}, f)
    return files


def flatten_params(params: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    """Nested param tree -> flat {dotted.name: CPU tensor} (for HF export)."""
    out = {}
    for k, v in params.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(flatten_params(v, name))
        else:
            out[name] = as_tensor(v).detach().cpu()
    return out


def unflatten_params(flat: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of `flatten_params`."""
    out: dict = {}
    for name, a in flat.items():
        parts = name.split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    return out
