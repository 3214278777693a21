"""Model-FLOPs estimators (for MFU logging and perf accounting).

Port of internvideo_tpu/utils/flops.py: tensor-core work (GEMMs and the
attention products) counted the standard way, 2 M N K per matmul and
4 S^2 D per layer for attention, the backward about twice the forward.
Elementwise work is not counted (MFU does not measure it).
"""

from __future__ import annotations


def encoder_forward_flops(cfg, batch: int = 1) -> float:
    """InternVideo2Config -> dense forward FLOPs for `batch` clips."""
    t = cfg.num_frames // cfg.tubelet_size
    s = t * (cfg.img_size // cfg.patch_size) ** 2 + 1  # + cls
    d = cfg.embed_dim
    hidden = int(d * cfg.mlp_ratio)
    patch_in = cfg.tubelet_size * cfg.patch_size ** 2 * 3
    per_layer = (
        2 * s * d * 3 * d          # qkv
        + 4 * s * s * d            # QK^T + PV
        + 2 * s * d * d            # proj
        + 2 * 2 * s * d * hidden   # fc1 + fc2
    )
    total = 2 * s * patch_in * d + cfg.depth * per_layer
    return float(batch) * total


def train_step_flops(forward_flops: float) -> float:
    """Forward + backward (~2x forward); full rematerialization adds one
    more forward, which this does not count."""
    return 3.0 * forward_flops
