"""Profiling helpers: torch.profiler traces, NVTX-named regions, wall
timing with a device sync.

Port of internvideo_tpu/utils/profiling.py: `trace()` records a
torch.profiler trace (CPU and, on a CUDA machine, the device) of a block
into `logdir` as a Chrome trace; `annotate()` names a region in that trace
(`record_function`) and, on a CUDA machine, as an NVTX range; `timed()`
measures a block's wall time after synchronizing the device it was given;
`StepProfiler` traces exactly steps [start, stop) of a loop.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _start(logdir: str) -> torch.profiler.profile:
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities(),
                                  on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    prof.start()
    return prof


@contextlib.contextmanager
def trace(logdir: str):
    """Record a trace of the block into `logdir` (`*.pt.trace.json`);
    yields the profiler (e.g. for `key_averages()`)."""
    prof = _start(logdir)
    try:
        yield prof
    finally:
        prof.stop()


@contextlib.contextmanager
def annotate(name: str):
    """A named region: a `record_function` span in the trace, and an NVTX
    range when CUDA is available."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def timed(name: str, results: Optional[dict] = None, device=None):
    """Wall-clock a block; a CUDA `device` is synchronized before the clock
    stops. Seconds go to `results[name]`, or are printed in ms."""
    device = None if device is None else torch.device(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        if results is not None:
            results[name] = dt
        else:
            print(f"[timed] {name}: {dt * 1000:.2f} ms")


class StepProfiler:
    """Trace exactly steps [start, stop) of a training loop: call
    `step(i)` at the top of step i, and `close()` after the loop."""

    def __init__(self, logdir: str, start: int, stop: int):
        self.logdir = logdir
        self.start, self.stop = start, stop
        self._prof: Optional[torch.profiler.profile] = None

    def step(self, i: int):
        if i == self.start and self._prof is None:
            self._prof = _start(self.logdir)
        elif i == self.stop and self._prof is not None:
            self.close()

    def close(self):
        if self._prof is not None:
            self._prof.stop()
            self._prof = None
