"""Training metrics: smoothed values, structured step logs, jsonl and
tensorboard sinks, MFU.

Port of internvideo_tpu/utils/metrics.py: SmoothedValue's windowed
average, MetricLogger.update / add_tokens / add_flops / log_step / close,
the jsonl sink and the tensorboard sink (`torch.utils.tensorboard`,
imported when a directory is given: a missing `tensorboard` package is an
ImportError naming it). A window with tokens logs `tokens_per_sec`; one
with FLOPs logs `tflops_per_sec`, and `mfu` when the device's peak is
known: the achieved FLOPs over the peak of one device times the number of
devices in use (the torch.distributed world size, 1 without a process
group). The peak table holds only the card this port is measured
on (`_PEAK_BF16`: bf16 dense tensor-core peak by `torch.cuda.
get_device_name`); on any other device `mfu` is left out, as JAX leaves
it out on a chip its table lacks.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Optional

import torch

# bf16 dense tensor-core peak, FLOP/s, by device name (the card's public
# spec; PERF.md's bounds use the same figure)
_PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989e12}


def device_peak_flops(device=None) -> Optional[float]:
    """The bf16 peak of `device` (default: the current CUDA device), or
    None for a device the table lacks (and for the CPU)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return _PEAK_BF16.get(torch.cuda.get_device_name(device))


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class SmoothedValue:
    def __init__(self, window: int = 20):
        self.window = collections.deque(maxlen=window)

    def update(self, value: float):
        self.window.append(value)

    @property
    def avg(self) -> float:
        return sum(self.window) / max(len(self.window), 1)


class MetricLogger:
    def __init__(self, jsonl_path: Optional[str] = None, log_every: int = 10,
                 print_fn=print, tensorboard_dir: Optional[str] = None):
        self.meters: dict[str, SmoothedValue] = collections.defaultdict(SmoothedValue)
        self.log_every = log_every
        self.print_fn = print_fn
        self._jsonl = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._jsonl = open(jsonl_path, "a")
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise ImportError(f"tensorboard_dir={tensorboard_dir!r} needs the `tensorboard` "
                                  f"package: {e}") from e
            self._tb = SummaryWriter(tensorboard_dir)
        self._t_last = time.perf_counter()
        self._tokens_since = 0
        self._flops_since = 0.0
        self._peak_flops: Optional[float] = None

    def set_peak_flops(self, peak: Optional[float] = None, *, device=None):
        """Turn on MFU: `peak` FLOP/s of one device (None: looked up for
        `device`). Without a peak only tflops_per_sec is logged."""
        self._peak_flops = peak if peak is not None else device_peak_flops(device)

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def add_tokens(self, n: int):
        self._tokens_since += int(n)

    def add_flops(self, n: float):
        """Model FLOPs spent this window (e.g. flops_per_batch each step)."""
        self._flops_since += float(n)

    def log_step(self, step: int, extra: Optional[dict] = None, *,
                 window_steps: Optional[int] = None) -> dict:
        """`window_steps` = steps covered since the last log (defaults to
        log_every; the final window can be partial)."""
        now = time.perf_counter()
        dt = now - self._t_last
        record = {
            "step": step,
            "time_per_step": dt / max(window_steps or self.log_every, 1),
            **{k: m.avg for k, m in self.meters.items()},
        }
        if self._tokens_since:
            record["tokens_per_sec"] = self._tokens_since / dt
            self._tokens_since = 0
        if self._flops_since:
            achieved = self._flops_since / dt
            record["tflops_per_sec"] = achieved / 1e12
            if self._peak_flops:
                record["mfu"] = achieved / (self._peak_flops * _world_size())
            self._flops_since = 0.0
        if extra:
            record.update(extra)
        self._t_last = now
        if self._jsonl:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            for k, v in record.items():
                if k != "step" and isinstance(v, (int, float)):
                    self._tb.add_scalar(k, float(v), step)
        self.print_fn("  ".join(
            f"{k}: {v:.5g}" if isinstance(v, float) else f"{k}: {v}" for k, v in record.items()))
        return record

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
