"""Checkpointing: step-tagged torch.save files with retention.

The torch-native counterpart of internvideo_tpu/core/checkpoint.py
`CheckpointManager` (same API: save(step, state, force), restore,
latest_step, wait, max_to_keep, save_interval_steps). A checkpoint is one
`torch.save` file `step_<step>.pt` holding the model's state_dict, the
optimizer's, the step, the state's generator and any EMA params, written
to a temporary name and renamed, so a crash never leaves a partial file.
Saves are synchronous, so `wait` has nothing to wait for. Orbax
compatibility is not a goal; the safetensors export bridge is not ported
yet (ROADMAP queue 1, item 9).

The save policy is orbax's default: a step is saved when it is past the
latest saved one and either no checkpoint exists yet or it is a multiple
of `save_interval_steps`; `force` saves regardless of the interval.
"""

from __future__ import annotations

import os
import re
from typing import Optional

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
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        dev = next(state.model.parameters()).device
        payload = torch.load(self._path(step), map_location=dev, weights_only=False)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.generator.set_state(payload["generator"].cpu())
        state.step = int(payload["step"])
        if payload["ema_params"] is not None:
            state.ema_params = payload["ema_params"]
        return state

    def wait(self) -> None:
        """Saves are synchronous; nothing is in flight."""
