"""Autoregressive generation with the latent (M2LA) KV cache.

Port of internvideo_tpu/models/generation.py: prefill once, then a decode
loop (the JAX `lax.scan` becomes a Python loop) with greedy, temperature,
top-k and top-p sampling; eos is handled by a finished mask, so the output
is always (B, max_new_tokens), eos-padded. Two cache regimes:

  * dense (default): per-layer (B, max_len, R + P) latent caches;
  * `paged=True`: per-layer page pools, decoded by K6 on the kernel route
    (ops/paged_decode.py); token-identical to dense.

Sampling draws from an explicit `torch.Generator`; its draws differ from
`jax.random`'s, greedy tokens do not. The mRoPE `position_ids` and `video`
branches wait for the MLLM slice (ROADMAP queue 1, item 6).
"""

from __future__ import annotations

from typing import Optional

import torch


def _sample(logits, *, temperature: float, top_k: Optional[int], top_p: Optional[float],
            generator: Optional[torch.Generator]):
    """(B, V) logits -> (B,) int64 token ids."""
    logits = logits.float()
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k is not None and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        if top_p <= 0.0:
            raise ValueError(f"top_p={top_p} masks every token (NaN softmax); "
                             "use top_p in (0, 1]")
        # nucleus: keep the smallest prefix of sorted probs summing to top_p
        # (the first token is always kept)
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = probs.cumsum(dim=-1) - probs < top_p
        cutoff = torch.where(keep, sorted_logits, float("inf")).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(
    model,
    input_ids: torch.Tensor,  # (B, L) prompt, no padding
    *,
    video=None,
    position_ids=None,
    max_new_tokens: int = 64,
    eos_token_id: Optional[int] = None,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    cache_dtype: torch.dtype = torch.float32,
    paged: bool = False,
    page_size: int = 64,
    decode_impl: Optional[str] = None,  # paged: auto | kernel | plain (pallas | xla)
) -> torch.Tensor:
    """Returns (B, max_new_tokens) generated ids (int64, eos-padded)."""
    if video is not None or position_ids is not None:
        raise NotImplementedError(
            "video prompts and explicit (mRoPE) position_ids wait for the MLLM slice "
            "(ROADMAP queue 1, item 6)")
    cfg = model.cfg
    dev = model.device
    input_ids = input_ids.to(dev)
    b, prompt_len = input_ids.shape
    max_len = prompt_len + max_new_tokens
    if generator is None and temperature > 0.0:
        generator = torch.Generator(dev).manual_seed(0)
    sample = lambda logits: _sample(logits[:, -1], temperature=temperature,  # noqa: E731
                                    top_k=top_k, top_p=top_p, generator=generator)

    if paged:
        if not hasattr(cfg, "mla"):
            raise ValueError("paged generate drives the latent (M2LA) page pools")
        from internvideo_tpu_torch.models.llm import init_paged_cache

        caches, tables = init_paged_cache(cfg, b, max_len, page_size, cache_dtype, dev)
        out = model.prefill_paged(input_ids, caches, tables, page_size)
    else:
        caches = model.init_cache(b, max_len, cache_dtype)
        out = model.prefill(model.embed_tokens(input_ids), caches)

    token = sample(out.logits)
    finished = (token == eos_token_id if eos_token_id is not None
                else torch.zeros(b, dtype=torch.bool, device=dev))
    tokens = [token]
    for step in range(max_new_tokens - 1):
        if paged:
            seq_lens = torch.full((b,), prompt_len + step, dtype=torch.int32, device=dev)
            out = model.decode_step_paged(token[:, None], caches, tables, seq_lens, page_size,
                                          impl=decode_impl)
        else:
            out = model.decode_step(token[:, None], caches, prompt_len + step)
        nxt = sample(out.logits)
        if eos_token_id is not None:
            nxt = torch.where(finished, eos_token_id, nxt)
            finished = finished | (nxt == eos_token_id)
        tokens.append(nxt)
        token = nxt
    return torch.stack(tokens, dim=1)
