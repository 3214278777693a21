"""GRPO reinforcement learning: group-relative policy optimization.

Port of internvideo_tpu/train/rl.py (the counterpart of xtuner's
xtuner/v1/rl/grpo/loss.py:20): the policy loss with clipped importance
ratios, group-normalised advantages (the responses to one prompt form a
group) and a k3 KL penalty against a frozen reference policy. The rollouts
that feed it are `train/rl_trainer.py`'s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class GRPOConfig:
    clip_eps_low: float = 0.2
    clip_eps_high: float = 0.2
    kl_beta: float = 0.0  # 0 disables the reference-policy KL term
    group_size: int = 8  # responses per prompt
    adv_eps: float = 1e-4


def group_relative_advantages(rewards: torch.Tensor, group_size: int,
                              eps: float = 1e-4) -> torch.Tensor:
    """A_i = (r_i - mean_group) / (std_group + eps) over (P * G,) rewards,
    with the population std (`jnp.std`'s)."""
    g = rewards.reshape(-1, group_size)
    mean = g.mean(dim=1, keepdim=True)
    std = g.std(dim=1, keepdim=True, unbiased=False)
    return ((g - mean) / (std + eps)).reshape(-1)


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(B, L, V) logits, (B, L) sampled tokens -> (B, L) fp32 log-probs; the
    full-vocab logits are upcast to fp32 first, as JAX does (:44)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(logp, -1, tokens.long()[..., None])[..., 0]


def grpo_policy_loss(
    logp: torch.Tensor,  # (B, L) current-policy log-probs of the sampled tokens
    logp_old: torch.Tensor,  # (B, L) behaviour-policy log-probs (rollout time)
    advantages: torch.Tensor,  # (B,) group-relative advantages
    mask: torch.Tensor,  # (B, L) 1 on response tokens
    cfg: GRPOConfig,
    logp_ref: Optional[torch.Tensor] = None,  # (B, L) frozen reference policy
):
    """Returns (loss, metrics): the token-mean over the batch's response
    tokens, and `ratio_mean`, `clip_frac`, `kl` as 0-d tensors."""
    ratio = torch.exp(logp - logp_old.detach())
    adv = advantages[:, None]
    lo, hi = 1.0 - cfg.clip_eps_low, 1.0 + cfg.clip_eps_high
    obj = torch.minimum(ratio * adv, ratio.clamp(lo, hi) * adv)
    kl = torch.zeros_like(logp)
    if cfg.kl_beta > 0.0 and logp_ref is not None:
        # k3 estimator: unbiased, always >= 0
        d = logp_ref.detach() - logp
        kl = torch.exp(d) - d - 1.0
        obj = obj - cfg.kl_beta * kl
    denom = mask.sum().clamp(min=1.0)
    loss = -(obj * mask).sum() / denom
    metrics = {
        "ratio_mean": (ratio * mask).sum() / denom,
        "clip_frac": (((ratio < lo) | (ratio > hi)) * mask).sum() / denom,
        "kl": (kl * mask).sum() / denom,
    }
    return loss, metrics
