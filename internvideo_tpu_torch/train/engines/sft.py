"""SFT engine: packed multimodal next-token training of the VideoMLLM.

Port of internvideo_tpu/train/engines/sft.py (:21-80), the xtuner fit
step: a packed batch {"input_ids", "segment_ids", "position_ids",
"labels", "video" (optional)} -> VideoMLLM forward (vision tower, mergers,
M2LA LLM with the segments' block-diagonal causal attention) -> chunked CE
over the lm_head (or the tied embedding table) with a global token
denominator -> the optimizer (train/step.py).

With `grad_accum` > 1 the wrapper counts the valid labels of the whole
batch and hands that count to every micro-batch, so that the micro-batch
losses add up to the batch's token mean (xtuner's global denominator,
loss/ce_loss.py). Sequence parallelism (`sp_impl` under a mesh whose `seq`
axis is > 1) is not ported yet (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import dataclasses

import torch

from internvideo_tpu_torch.train.chunked_ce import chunked_cross_entropy
from internvideo_tpu_torch.train.step import make_accum_step


@dataclasses.dataclass(frozen=True)
class SFTConfig:
    ce_chunk_size: int = 2048
    # sequence-parallel attention over the mesh's `seq` axis: "ulysses" or "ring"
    sp_impl: str = "ulysses"


def make_sft_step(cfg: SFTConfig, mesh=None, *, grad_accum: int = 1):
    """step(state, batch) -> metrics (loss, grad_norm, finite, tokens);
    `mesh` is the trainer's MeshConfig."""
    if mesh is not None and mesh.seq > 1:
        raise NotImplementedError(
            f"sequence-parallel SFT (sp_impl={cfg.sp_impl!r} over seq={mesh.seq}) is not ported "
            "yet (ROADMAP queue 1, item 8)")

    def loss_fn(model, batch, seed: int):
        out = model(batch["input_ids"], batch.get("video"),
                    position_ids=batch.get("position_ids"), segment_ids=batch["segment_ids"],
                    with_logits=False)
        lm = model.language_model
        head = lm.embed_tokens.weight if lm.cfg.tie_word_embeddings else lm.lm_head.weight
        labels = batch["labels"]
        total = batch.get("total_valid")
        loss = chunked_cross_entropy(
            out.hidden, head, labels, chunk_size=cfg.ce_chunk_size,
            total_valid=(total / grad_accum if total is not None else None))
        return loss, {"tokens": (labels != -100).sum()}

    inner = make_accum_step(loss_fn, grad_accum=grad_accum)
    if grad_accum == 1:
        return inner

    def step(state, batch):
        total = (batch["labels"] != -100).sum().float()
        return inner(state, dict(batch, total_valid=total.expand(grad_accum)))

    return step
