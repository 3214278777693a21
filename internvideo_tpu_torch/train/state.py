"""Train state: the model, its optimizer, the update count and the random
stream of the step; and the frozen teachers beside it.

Port of internvideo_tpu/train/state.py `TrainState` (:23-48) and of
`sharded_frozen_variables` (:126) as `frozen_teacher`. The JAX state
is an immutable pytree of params and optimizer state; here the model and
the optimizer are updated in place and the state holds them. `generator`
is a CPU torch.Generator from which each step draws its seeds (mixup and
DropPath), the counterpart of the Trainer's JAX key folded with the step;
it is part of the state so that a checkpoint resumes the same stream. The
sharded creation (`create_sharded_state`) is the JAX package's
multi-device path and is not ported (ROADMAP queue 1, item 8).

A frozen teacher is a module built on its device from its own seeded
generator, with every parameter's requires_grad off and in eval mode. It is
held by the step, never by the student, so it is in no optimizer group, in
no global norm and in no checkpoint of the student.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from internvideo_tpu_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: Optimizer
    generator: torch.Generator
    # model EMA (timm ModelEma): fp32 copies updated as
    # ema = decay * ema + (1 - decay) * params after every step
    ema_params: Optional[dict[str, torch.Tensor]] = None
    ema_decay: float = 0.0

    @classmethod
    def create(cls, model: torch.nn.Module, optimizer: Optimizer, *, seed: int = 0,
               ema_decay: float = 0.0) -> "TrainState":
        ema = None
        if ema_decay > 0:
            ema = {n: p.detach().float().clone() for n, p in model.named_parameters()}
        return cls(step=0, model=model, optimizer=optimizer,
                   generator=torch.Generator().manual_seed(seed),
                   ema_params=ema, ema_decay=ema_decay)

    def apply_gradients(self) -> None:
        """One optimizer update from the parameters' .grad, then the EMA."""
        self.optimizer.step()
        if self.ema_params is not None:
            with torch.no_grad():
                d = self.ema_decay
                params = dict(self.model.named_parameters())
                ema = list(self.ema_params.values())
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, [params[n].float() for n in self.ema_params],
                                    alpha=1.0 - d)
        self.step += 1

    def next_seed(self) -> int:
        """A seed for one micro-batch's random draws, from `generator`
        (host only: no device sync)."""
        return int(torch.randint(0, 2**62, (), generator=self.generator))


def frozen_teacher(module: torch.nn.Module) -> torch.nn.Module:
    """Freeze `module` in place: requires_grad off on every parameter, eval
    mode."""
    return module.requires_grad_(False).eval()
