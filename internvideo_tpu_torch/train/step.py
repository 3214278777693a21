"""The shared train-step mechanics: micro-batch loop, grad, global norm,
optimizer apply.

Port of internvideo_tpu/train/step.py `make_accum_step` (:81-133). Each engine supplies a loss function; with
`grad_accum` > 1 the batch leaves arrive shaped (accum, micro, ...) (the
Trainer reshapes) and the gradients are the mean over the micro-batches, as
the JAX lax.scan computes them: each micro-batch's loss is scaled by
1 / accum before its backward, so the parameters' .grad sums to the mean.
Metrics stay on the device: the step never syncs with the host.
"""

from __future__ import annotations

from typing import Callable

import torch

from internvideo_tpu_torch.train.optim import global_norm
from internvideo_tpu_torch.train.state import TrainState


def make_accum_step(loss_fn: Callable, *, grad_accum: int = 1):
    """loss_fn(model, batch, seed) -> (loss, aux_metrics); returns
    step(state, batch) -> metrics, which updates `state` in place.

    metrics: the mean loss, `grad_norm` (fp32 global norm of the averaged
    gradients of every parameter, before clipping), `finite` (1.0 when the
    loss is finite) and the mean of each aux metric, all 0-dim device
    tensors.
    """

    def step(state: TrainState, batch: dict) -> dict:
        model = state.model
        model.train()
        state.optimizer.zero_grad()
        micro = [batch] if grad_accum == 1 else [
            {k: v[i] for k, v in batch.items()} for i in range(grad_accum)]
        loss_sum, aux_sum = 0.0, {}
        for mb in micro:
            loss, aux = loss_fn(model, mb, state.next_seed())
            (loss / grad_accum).backward()
            loss_sum = loss_sum + loss.detach()
            for k, v in aux.items():
                aux_sum[k] = aux_sum.get(k, 0.0) + v.detach()
        loss = loss_sum / grad_accum
        grad_norm = global_norm([p.grad for p in model.parameters() if p.grad is not None])
        state.apply_gradients()
        return {
            "loss": loss,
            "grad_norm": grad_norm,
            "finite": torch.isfinite(loss).float(),
            **{k: v / grad_accum for k, v in aux_sum.items()},
        }

    return step
