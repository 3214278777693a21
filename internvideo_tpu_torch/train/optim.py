"""Optimizer: AdamW + cosine schedule + ViT layer-wise LR decay.

Port of internvideo_tpu/train/optim.py. The JAX package builds one optax
chain over the param tree:

    clip_by_global_norm -> scale_by_adam -> add_decayed_weights(mask)
      -> layer-decay scales -> lr_mult scales -> scale_by_learning_rate

Here the same update is `torch.optim.AdamW` over parameter groups, one per
(layer-decay scale x lr multiplier, decays or not): AdamW's decoupled decay
p -= lr * wd * p followed by p -= lr * adam equals -lr * (adam + wd * p)
with the pre-update p, and its bias-corrected Adam keeps eps outside the
square root as optax does. Before each AdamW step `Optimizer.step`

  * clips as optax does: g * max / ||g|| when the global fp32 norm of the
    trainable gradients is >= max (not `clip_grad_norm_`, which adds 1e-6),
    on the device with no host sync;
  * sets every group's lr to schedule(count) * group scale, where count is
    the 0-based number of updates so far: optax evaluates the schedule at
    the update count, so with warmup the first update uses lr(0) = 0.

Parameter names are the port's dotted state_dict names
(`blocks.3.attn.qkv.weight`); the no-decay regex, the layer id regex
`blocks[._](\\d+)` and user patterns match them as the JAX package's match
its `blocks_3/attn/qkv/kernel` paths. Parameters that `trainable_patterns`
leaves out are not in any group: they never move and carry no Adam state
(optax.set_to_zero). A parameter in a group that the loss does not reach
(the stage-2 CLIP-align decoders with `uta=0`) steps on a zero gradient,
as optax's does: its weight decay still applies.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1e-4
    min_lr: float = 1e-6
    warmup_steps: int = 0
    total_steps: int = 10_000
    weight_decay: float = 0.05
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip_grad_norm: Optional[float] = 3.0
    layer_decay: Optional[float] = None  # e.g. 0.75 for finetune
    num_layers: Optional[int] = None  # required when layer_decay is set
    # only params whose name matches one of these regexes are updated
    trainable_patterns: Optional[tuple[str, ...]] = None
    # (regex, mult) pairs, first match wins, default multiplier 1.0
    lr_mult_patterns: Optional[tuple[tuple[str, float], ...]] = None


def cosine_schedule(base: float, final: float, warmup_steps: int,
                    total_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, base, warmup, total, final), or
    optax.cosine_decay_schedule(base, total, final / base) with no warmup."""

    def cosine(count, peak, decay_steps, alpha):
        count = min(count, decay_steps)
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / decay_steps)) + alpha)

    if warmup_steps > 0:
        alpha = 0.0 if base == 0.0 else final / base

        def schedule(count: int) -> float:
            if count < warmup_steps:
                return base * min(max(count, 0), warmup_steps) / warmup_steps
            return cosine(count - warmup_steps, base, total_steps - warmup_steps, alpha)

        return schedule
    alpha = final / max(base, 1e-30)
    return lambda count: cosine(count, base, total_steps, alpha)


_NO_DECAY_PAT = re.compile(
    r"(bias|scale|gamma|cls_token|pos_embed|norm|ls1|ls2|logit_scale|temp)"
)


def decays(name: str, param: torch.Tensor) -> bool:
    """Weight decay applies to 2D+ params outside the no-decay set."""
    return param.ndim >= 2 and not _NO_DECAY_PAT.search(name.lower())


def layer_id(name: str, num_layers: int) -> int:
    """ViT layer id: embeddings -> 0, block i -> i+1, head/pooler -> last."""
    low = name.lower()
    if any(t in low for t in ("cls_token", "pos_embed", "patch_embed")):
        return 0
    m = re.search(r"blocks[._](\d+)", low)
    if m:
        return int(m.group(1)) + 1
    return num_layers + 1


def _lr_scale(name: str, config: OptimizerConfig, mults) -> float:
    scale = 1.0
    if config.layer_decay:
        if config.num_layers is None:
            raise ValueError("layer_decay needs num_layers")
        max_id = config.num_layers + 1
        scale = config.layer_decay ** (max_id - layer_id(name, config.num_layers))
    for pat, mult in mults:
        if pat.search(name):
            return scale * mult
    return scale


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) in fp32 over a list of tensors, on their device
    (the JAX package's `optax_global_norm`, train/step.py:136). Each norm
    accumulates in fp32 without an fp32 copy of its tensor (bf16 gradients
    of an 8B model would need 28 GB of copies)."""
    if not tensors:
        return torch.zeros(())
    norms = torch._foreach_norm(list(tensors), 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


class Optimizer:
    """The optax chain of OptimizerConfig over a module's named parameters."""

    def __init__(self, config: OptimizerConfig, named_params):
        self.config = config
        self.schedule = cosine_schedule(config.lr, config.min_lr, config.warmup_steps,
                                        config.total_steps)
        trainable = ([re.compile(p) for p in config.trainable_patterns]
                     if config.trainable_patterns else None)
        mults = [(re.compile(p), float(m)) for p, m in (config.lr_mult_patterns or ())]
        groups: dict[tuple[float, bool], list] = {}
        for name, p in named_params:
            if trainable is not None and not any(t.search(name) for t in trainable):
                continue
            key = (_lr_scale(name, config, mults), decays(name, p))
            groups.setdefault(key, []).append(p)
        self.params = [p for ps in groups.values() for p in ps]
        # torch's fused AdamW on the card and on the CPU: one pass over each
        # parameter's p, g, m, v (the default multi-tensor update allocates
        # temporaries the size of a whole group: a second copy of v, 14 GB
        # for the 8B SFT's bf16 moments). It does the update's arithmetic in
        # fp32 and stores p, m and v in the parameters' dtype, so a bf16
        # step rounds once per tensor; optax's chain (and torch's unfused
        # update) round after every op. Both routes hold to the fused
        # behaviour (tests/test_torch_adamw_bf16.py).
        self.adamw = torch.optim.AdamW(
            [{"params": ps, "lr_scale": scale,
              "weight_decay": config.weight_decay if decay else 0.0}
             for (scale, decay), ps in groups.items()],
            lr=0.0, betas=(config.b1, config.b2), eps=config.eps,
            fused=bool(self.params) or None)
        self.count = 0  # updates applied so far (optax's schedule count)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        # a trainable parameter the loss did not reach has a zero gradient
        # in optax, which still decays it; torch's AdamW would skip it
        for p in self.params:
            if p.grad is None and p.requires_grad:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.config.clip_grad_norm and grads:
            norm = global_norm(grads)
            max_norm = self.config.clip_grad_norm
            factor = torch.where(norm < max_norm, 1.0, max_norm / norm)
            torch._foreach_mul_(grads, factor.to(grads[0].dtype))
        lr = self.schedule(self.count)
        for group in self.adamw.param_groups:
            group["lr"] = lr * group["lr_scale"]
        self.adamw.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "adamw": self.adamw.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = state["count"]
        self.adamw.load_state_dict(state["adamw"])


def build_optimizer(config: OptimizerConfig,
                    model: torch.nn.Module) -> tuple[Optimizer, Callable[[int], float]]:
    """(optimizer, lr schedule) for `model`'s parameters."""
    opt = Optimizer(config, model.named_parameters())
    return opt, opt.schedule
