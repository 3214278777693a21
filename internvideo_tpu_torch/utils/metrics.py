"""Training metrics: smoothed values, structured step logs, jsonl tracker.

Port of the parts of internvideo_tpu/utils/metrics.py that the Trainer
uses: SmoothedValue's windowed average, MetricLogger.update / log_step /
close and the jsonl sink. The JAX logger's MFU carries a table of TPU peaks; the
port carries none, so `flops_per_batch` reporting and the tensorboard sink
raise NotImplementedError (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Optional


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
        if tensorboard_dir:
            raise NotImplementedError(
                "the tensorboard sink is not ported yet (ROADMAP queue 1, item 9)")
        self.meters: dict[str, SmoothedValue] = collections.defaultdict(SmoothedValue)
        self.log_every = log_every
        self.print_fn = print_fn
        self._jsonl = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._jsonl = open(jsonl_path, "a")
        self._t_last = time.perf_counter()

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

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
        if extra:
            record.update(extra)
        self._t_last = now
        if self._jsonl:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        self.print_fn("  ".join(
            f"{k}: {v:.5g}" if isinstance(v, float) else f"{k}: {v}" for k, v in record.items()))
        return record

    def close(self):
        if self._jsonl:
            self._jsonl.close()
