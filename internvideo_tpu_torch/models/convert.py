"""Weight bridge: the JAX package's InternVideo2 param tree -> this port's
state_dict.

Input is the nested dict `InternVideo2.init` gives in the JAX package,
unboxed (`flax.linen.unbox`) and turned into numpy arrays; a top-level
`{"params": ...}` wrapper is accepted. Translations:

  * flax Dense `kernel` (in, out)     -> torch `weight` (out, in) [transpose]
  * `blocks_{i}`                      -> `blocks.{i}`
  * LayerNorm `scale` / `bias`        -> `weight` / `bias`
  * RMSNorm `weight`, LayerScale `gamma`, `cls_token`, `pos_embed` and
    biases go across as they are.

numpy bfloat16 arrays (ml_dtypes) are reinterpreted bit for bit, so bf16
weights load exactly. `InternVideo2.load_state_dict(sd, strict=True)` then
accepts the result.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_BLOCK = re.compile(r"^blocks_(\d+)$")


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(params: Mapping, cfg) -> dict[str, torch.Tensor]:
    """JAX InternVideo2 params -> state_dict for `InternVideo2(cfg, ...)`."""
    if "params" in params:
        params = params["params"]
    blocks = sorted(int(m.group(1)) for k in params if (m := _BLOCK.match(k)))
    if blocks != list(range(cfg.depth)):
        raise ValueError(f"param tree has blocks {blocks}, config depth {cfg.depth}")
    sd: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for name, child in node.items():
            m = _BLOCK.match(name)
            key = f"blocks.{m.group(1)}" if m else name
            path = f"{prefix}{key}"
            if isinstance(child, Mapping):
                walk(child, path + ".")
                continue
            t = _to_tensor(child)
            if name == "kernel":
                sd[f"{prefix}weight"] = t.t().contiguous()
            elif name == "scale":
                sd[f"{prefix}weight"] = t
            else:
                sd[path] = t

    walk(params, "")
    return sd
