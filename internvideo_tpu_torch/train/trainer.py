"""Trainer: state + step loop + checkpoints + metrics, on one device.

Port of internvideo_tpu/train/trainer.py (TrainerConfig, Trainer.fit):

  * the step loop keeps each step's metrics on the device and reads a whole
    window with one host transfer every `log_every` steps, never once per
    step (:257-285);
  * `halt_on_nan` raises FloatingPointError on any non-finite loss in the
    window;
  * `grad_accum` reshapes each batch into (accum, micro, ...);
  * checkpoints: interval saves, auto-resume, and fast-forward of the data
    iterator past the batches already trained on;
  * `save_on_preemption`: SIGTERM / SIGINT save the current step and stop
    at the next step boundary;
  * `ema_decay` and `load_params`;
  * `hf_export_every` keeps JAX's contract (:93-95, :326-332): a given
    `export_fn(state, step)` runs every N steps, and without one the
    setting does nothing. `hf_export_fn` builds one: the model's
    state_dict through `params_to_jax`, a `to_hf` export (e.g.
    `export_mla_llm_hf`) and `save_hf_checkpoint` into `<dir>/step_<N>`;
  * `flops_per_batch` > 0 logs tflops_per_sec, and MFU against the
    device's bf16 peak where utils/metrics.py knows it; a step's
    `tokens` metric logs tokens_per_sec; `tensorboard_dir` adds the
    tensorboard sink.

The mesh must resolve to one device (core/mesh.py); `health_check_every`
raises NotImplementedError (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import dataclasses
import os
import signal
from typing import Callable, Iterable, Optional

import torch

from internvideo_tpu_torch.core.checkpoint import CheckpointManager
from internvideo_tpu_torch.core.mesh import MeshConfig, single_device
from internvideo_tpu_torch.train.optim import OptimizerConfig, build_optimizer
from internvideo_tpu_torch.train.state import TrainState
from internvideo_tpu_torch.utils.metrics import MetricLogger


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    total_steps: int = 1000
    seed: int = 0
    log_every: int = 10
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 500
    max_checkpoints: int = 3
    auto_resume: bool = True
    halt_on_nan: bool = True
    # on auto-resume, skip the batches already trained on
    resume_fast_forward: bool = True
    hf_export_every: int = 0
    save_on_preemption: bool = True
    # batches of size B are reshaped to (grad_accum, B // grad_accum, ...)
    grad_accum: int = 1
    tensorboard_dir: Optional[str] = None
    health_check_every: int = 0
    flops_per_batch: float = 0.0
    ema_decay: float = 0.0
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)


def hf_export_fn(directory: str, to_hf: Callable[[dict], dict], *,
                 shard_size_bytes: int = 4 * 1024**3) -> Callable:
    """An `export_fn(state, step)` for `hf_export_every`: writes the model's
    weights as an HF checkpoint in `<directory>/step_<step>`. `to_hf` maps
    the JAX param tree (`{"params": ...}` from `params_to_jax`) to the HF
    state dict, e.g. `lambda t: export_mla_llm_hf(t, cfg)`."""
    from internvideo_tpu_torch.core.checkpoint import save_hf_checkpoint
    from internvideo_tpu_torch.models.convert import params_to_jax

    def export(state: TrainState, step: int) -> None:
        tree = params_to_jax(state.model.state_dict(), state.model)
        save_hf_checkpoint(os.path.join(directory, f"step_{step}"), to_hf(tree),
                           shard_size_bytes=shard_size_bytes)

    return export


class Trainer:
    def __init__(self, config: TrainerConfig, model: torch.nn.Module,
                 step_builder: Callable, *, jsonl_path: Optional[str] = None,
                 export_fn: Optional[Callable] = None):
        """`model` is built on its device; `step_builder(grad_accum=n)`
        returns step(state, batch) -> metrics (train/step.py);
        `export_fn(state, step)` runs every `hf_export_every` steps."""
        if config.health_check_every > 0:
            raise NotImplementedError("Trainer: health_check_every > 0 (ROADMAP queue 1, "
                                      "item 8) is not ported yet")
        single_device(config.mesh)
        self.export_fn = export_fn
        self.config = config
        self.model = model
        self.device = next(model.parameters()).device
        self._preempted = False
        optimizer, self.lr_schedule = build_optimizer(config.optimizer, model)
        self.state = TrainState.create(model, optimizer, seed=config.seed,
                                       ema_decay=config.ema_decay)
        self._step = step_builder(grad_accum=config.grad_accum)
        self.ckpt = None
        if config.checkpoint_dir:
            self.ckpt = CheckpointManager(
                config.checkpoint_dir, max_to_keep=config.max_checkpoints,
                save_interval_steps=config.checkpoint_every)
            if config.auto_resume and self.ckpt.latest_step() is not None:
                self.ckpt.restore(self.state)
        self.metrics = MetricLogger(jsonl_path=jsonl_path, log_every=config.log_every,
                                    tensorboard_dir=config.tensorboard_dir)
        if config.flops_per_batch:
            self.metrics.set_peak_flops(device=self.device)

    def load_params(self, state_dict: dict) -> None:
        """Replace the model's parameters with a converted checkpoint (e.g.
        models/convert.py:params_from_jax), cast to each parameter's dtype;
        the names must match the model's exactly."""
        self.model.load_state_dict(state_dict, strict=True)

    def put_batch(self, batch: dict) -> dict:
        """Host batch -> device tensors, reshaped to (accum, micro, ...)
        when grad_accum > 1; mRoPE position_ids (3, B, L) split along their
        batch axis into (accum, 3, micro, L), as the JAX Trainer does
        (:203-229)."""
        ga = self.config.grad_accum
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if ga > 1:
                mrope = k == "position_ids" and t.dim() == 3 and t.shape[0] == 3
                rows = t.shape[1] if mrope else t.shape[0]
                if rows % ga:
                    raise ValueError(f"batch leaf {k!r} of {rows} rows does not "
                                     f"split into grad_accum={ga} micro-batches")
                if mrope:
                    t = t.reshape(3, ga, rows // ga, *t.shape[2:]).transpose(0, 1).contiguous()
                else:
                    t = t.reshape((ga, rows // ga) + tuple(t.shape[1:]))
            if self.device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def _install_preemption_handler(self):
        def _handler(signum, frame):
            self._preempted = True

        old = {}
        try:  # signal.signal only works on the main thread
            for sig in (signal.SIGTERM, signal.SIGINT):
                old[sig] = signal.signal(sig, _handler)
        except ValueError:
            pass
        return old

    def _flush_metrics(self, pending: list, *, halt_on_nan: bool) -> None:
        """One host transfer for the whole window of device metrics."""
        if not pending:
            return
        keys = sorted(pending[0][1])
        host = torch.stack([torch.stack([m[k].float() for k in keys])
                            for _, m in pending]).tolist()
        steps = [st for st, _ in pending]
        pending.clear()
        bad = None
        for st, row in zip(steps, host):
            scalars = dict(zip(keys, row))
            self.metrics.update(**{k: v for k, v in scalars.items() if k != "finite"})
            if "tokens" in scalars:
                self.metrics.add_tokens(int(scalars["tokens"]))
            if self.config.flops_per_batch:
                self.metrics.add_flops(self.config.flops_per_batch)
            if bad is None and not scalars.get("finite", 1.0):
                bad = (st, scalars)
        if halt_on_nan and bad is not None:
            raise FloatingPointError(f"non-finite loss at step {bad[0]}: {bad[1]}")

    def fit(self, data: Iterable[dict], steps: Optional[int] = None) -> TrainState:
        cfg = self.config
        steps = steps or cfg.total_steps
        start = self.state.step
        it = iter(data)
        if start and cfg.resume_fast_forward:
            for _ in range(start):
                next(it)
        old_handlers = self._install_preemption_handler() if cfg.save_on_preemption else {}
        pending: list[tuple[int, dict]] = []  # (step, device metrics)
        try:
            for step in range(start, steps):
                if self._preempted:
                    if self.ckpt is not None:
                        self.ckpt.save(step, self.state, force=True)
                    break
                m = self._step(self.state, self.put_batch(next(it)))
                pending.append((step, m))
                if (step + 1) % cfg.log_every == 0:
                    self._flush_metrics(pending, halt_on_nan=cfg.halt_on_nan)
                    self.metrics.log_step(step + 1, extra={"lr": self.lr_schedule(step)})
                if self.ckpt is not None:
                    self.ckpt.save(step + 1, self.state)
                if (self.export_fn is not None and cfg.hf_export_every
                        and (step + 1) % cfg.hf_export_every == 0):
                    self.export_fn(self.state, step + 1)
            if pending:  # the final partial window
                last, n = pending[-1][0], len(pending)
                self._flush_metrics(pending, halt_on_nan=cfg.halt_on_nan)
                self.metrics.log_step(last + 1, extra={"lr": self.lr_schedule(last)},
                                      window_steps=n)
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
        if self.ckpt is not None:
            if not self._preempted and self.ckpt.latest_step() != steps:
                self.ckpt.save(steps, self.state, force=True)
            self.ckpt.wait()
        return self.state
