"""Device mesh configuration.

Port of internvideo_tpu/core/mesh.py `MeshConfig` (same axes, same
`resolve`). The JAX package lays every run on a named-axis mesh; the port
runs on one device so far, so `single_device` accepts only a mesh that
resolves to one device and raises NotImplementedError for anything larger
(torch.distributed / FSDP2: ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import dataclasses
import math

MESH_AXES = ("replica", "fsdp", "seq", "tensor", "expert")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each mesh axis. -1 means "absorb all remaining devices"."""

    replica: int = 1
    fsdp: int = -1
    seq: int = 1
    tensor: int = 1
    expert: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = {a: getattr(self, a) for a in MESH_AXES}
        fixed = math.prod(v for v in sizes.values() if v != -1)
        free = [a for a, v in sizes.items() if v == -1]
        if len(free) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {free}")
        if free:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}")
            sizes[free[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh sizes {sizes} != {n_devices} devices")
        return sizes


def single_device(config: MeshConfig) -> dict[str, int]:
    """`config` resolved on one device, or NotImplementedError."""
    try:
        return config.resolve(1)
    except ValueError as e:
        raise NotImplementedError(
            f"mesh {config} needs more than one device; multi-device training is not "
            f"ported yet (ROADMAP queue 1, item 8)") from e
