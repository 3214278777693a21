"""Chunked cross-entropy: CE over a large vocabulary without holding every
position's logits.

Port of internvideo_tpu/train/chunked_ce.py (:24-72), the counterpart of
xtuner's chunked LM-head loss. The (L, V) logits of an 8192-token pack at a
151,936 vocabulary would be 5 GB in fp32; instead the lm_head product and
the CE run per chunk of `chunk_size` positions, each chunk under
`torch.utils.checkpoint` (the JAX `jax.checkpoint` inside its `lax.scan`),
so its (B, C, V) logits are freed after the forward and recomputed in the
backward: one chunk's logits are alive at a time.

Numerics: the product runs in the hidden's dtype with fp32 accumulation
(cuBLAS; in bf16 its output is rounded to bf16, as xtuner's `F.linear`
logits are, where JAX keeps them fp32 with preferred_element_type); the log
softmax, the picked log-probabilities and the sums are fp32. Normalisation
is global: the caller may pass the total valid-token count (the full
batch's under gradient accumulation); otherwise it is this call's count.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint


def _chunk_loss(h: torch.Tensor, weight: torch.Tensor, y: torch.Tensor):
    """(summed -log p of the valid labels, their count) for one chunk:
    h (B, C, D), weight (V, D), y (B, C) with -100 = ignore."""
    logits = F.linear(h, weight.to(h.dtype)).float()
    logp = torch.log_softmax(logits, dim=-1)
    valid = y != -100
    picked = logp.gather(-1, y.clamp(min=0)[..., None])[..., 0]
    return -torch.where(valid, picked, 0.0).sum(), valid.sum()


def chunked_cross_entropy(
    hidden: torch.Tensor,  # (B, L, D)
    lm_head_weight: torch.Tensor,  # (V, D): the lm_head's weight or the tied embedding table
    labels: torch.Tensor,  # (B, L) int; -100 = ignore
    *,
    chunk_size: int = 2048,
    total_valid: Optional[torch.Tensor] = None,  # global denominator
) -> torch.Tensor:
    """Mean next-token CE over the valid labels (fp32 0-dim tensor)."""
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for c0 in range(0, hidden.shape[1], chunk_size):
        h, y = hidden[:, c0:c0 + chunk_size], labels[:, c0:c0 + chunk_size]
        if torch.is_grad_enabled():
            loss, cnt = torch.utils.checkpoint.checkpoint(_chunk_loss, h, lm_head_weight, y,
                                                          use_reentrant=False)
        else:
            loss, cnt = _chunk_loss(h, lm_head_weight, y)
        loss_sum = loss_sum + loss
        count = count + cnt
    denom = total_valid if total_valid is not None else count.clamp(min=1)
    return loss_sum / denom
