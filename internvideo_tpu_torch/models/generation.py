"""Autoregressive generation over the model's KV cache.

Port of internvideo_tpu/models/generation.py: prefill once, then a decode
loop (the JAX `lax.scan` becomes a Python loop) with greedy, temperature,
top-k and top-p sampling; eos is handled by a finished mask, so the output
is always (B, max_new_tokens), eos-padded. Two cache regimes:

  * dense (default): the model's own caches, per-layer (B, max_len, R + P)
    latents for M2LA, (B, max_len, Hkv, D) K and V for dense GQA;
  * `paged=True`: per-layer latent page pools, decoded by K6 on the kernel
    route (ops/paged_decode.py); token-identical to dense. M2LA only.

The model is a bare LLM (prefill(input_embeds, caches)), a VideoMLLM or a
VideoChat (prefill(input_ids, video, caches)), told apart by the prefill's
signature as in JAX; the text config is `model.cfg`, `model.config.text`
(VideoMLLM) or `model.config.llm` (VideoChat).

Here alone the port departs from JAX on purpose. A model's prefill may
write cache entries ahead of the prompt: VideoChat's writes its
num_queries video queries first, and says so by `cache_prefix_len` (0 when
a model has none). The dense cache is sized prefix + prompt_len +
max_new_tokens and decode step s runs at cache_len prefix + prompt_len + s.
JAX's generate sizes it prompt_len + max_new_tokens and decodes at
prompt_len + s (internvideo_tpu/models/generation.py:47, 176), so on a
VideoChat it decodes over the wrong slots and overwrites the queries'
latents (tests/test_torch_chat.py states that offset).

Explicit `position_ids` ((B, L), or (3, B, L) mRoPE grids) run on the dense
path; decode positions continue from the prompt's max + 1 per batch row.
Sampling draws from an explicit `torch.Generator`; its draws differ from
`jax.random`'s, greedy tokens do not.
"""

from __future__ import annotations

import inspect
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
    # the text model's config: bare LMs carry `cfg`, a VideoMLLM
    # `config.text`, a VideoChat `config.llm`
    if hasattr(model, "cfg"):
        cfg = model.cfg
    else:
        cfg = model.config.text if hasattr(model.config, "text") else model.config.llm
    dev = model.device
    input_ids = input_ids.to(dev)
    b, prompt_len = input_ids.shape
    # cache entries the prefill writes ahead of the prompt (VideoChat's queries)
    prefix = getattr(model, "cache_prefix_len", 0)
    max_len = prefix + prompt_len + max_new_tokens
    if generator is None and temperature > 0.0:
        generator = torch.Generator(dev).manual_seed(0)
    sample = lambda logits: _sample(logits[:, -1], temperature=temperature,  # noqa: E731
                                    top_k=top_k, top_p=top_p, generator=generator)

    if video is not None:
        video = video.to(dev)
    if paged:
        if prefix:
            raise ValueError("paged generate serves prompts whose prefill writes no cache "
                             "entries ahead of them; this model's writes "
                             f"{prefix}: run paged=False")
        if position_ids is not None:
            raise NotImplementedError(
                "explicit position_ids (mRoPE serving) run on the dense-cache path; the paged "
                "decode derives positions from seq_lens")
        if not hasattr(cfg, "mla"):
            raise ValueError(
                "paged generate drives the latent (M2LA) page pools; the dense-GQA flavour uses "
                "its (B, L, Hkv, D) cache - run paged=False")
        from internvideo_tpu_torch.models.llm import init_paged_cache

        caches, tables = init_paged_cache(cfg, b, max_len, page_size, cache_dtype, dev)
        if "video" in inspect.signature(model.prefill_paged).parameters:
            out = model.prefill_paged(input_ids, video, caches, tables, page_size)
        elif video is not None:
            raise ValueError("this model's paged path is text-only")
        else:
            out = model.prefill_paged(input_ids, caches, tables, page_size)
    else:
        caches = model.init_cache(b, max_len, cache_dtype)
        sig = inspect.signature(model.prefill).parameters
        pos_kw = {} if position_ids is None else {"position_ids": position_ids.to(dev)}
        if pos_kw and "position_ids" not in sig:
            raise ValueError("this model's prefill does not accept position_ids")
        if "video" in sig:  # MLLM: prefill(input_ids, video, caches)
            out = model.prefill(input_ids, video, caches, **pos_kw)
        elif video is not None:
            raise ValueError("this model's prefill is text-only")
        else:  # bare LLM: prefill(input_embeds, caches)
            out = model.prefill(model.embed_tokens(input_ids), caches, **pos_kw)
    # decode positions: mRoPE rows advance together from the prompt's max
    # position + 1, per batch row (the Qwen-VL convention)
    next_pos = None
    if position_ids is not None:
        dims = (0, -1) if position_ids.dim() == 3 else (-1,)
        next_pos = position_ids.to(dev).amax(dim=dims) + 1  # (B,)

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
            kw = {}
            if next_pos is not None:
                pos = (next_pos + step)[:, None]  # (B, 1)
                kw["position_ids"] = pos.expand(3, b, 1) if position_ids.dim() == 3 else pos
            out = model.decode_step(token[:, None], caches, prefix + prompt_len + step, **kw)
        nxt = sample(out.logits)
        if eos_token_id is not None:
            nxt = torch.where(finished, eos_token_id, nxt)
            finished = finished | (nxt == eos_token_id)
        tokens.append(nxt)
        token = nxt
    return torch.stack(tokens, dim=1)
