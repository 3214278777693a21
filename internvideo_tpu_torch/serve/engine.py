"""Continuous-batching serving engine over the paged M2LA decode path.

Port of internvideo_tpu/serve/engine.py: a page allocator + slot scheduler
that admits requests into a fixed decode batch as earlier sequences finish,
so the card always decodes a full batch.

  * One decode shape: (max_batch, 1) tokens through every layer and the
    paged decode (K6 on the kernel route), ragged `seq_lens` per slot. Idle
    slots still compute but write into a reserved trash page, so they can
    never corrupt pages recycled to live sequences.
  * Prompt lengths are padded to buckets (K5 prefill at the bucket
    length). Pad positions write entries beyond the real length, which are
    never attended (attention is bounded by seq_lens) and are overwritten
    as decode advances; first-token logits are taken at the true last
    prompt index.
  * Page tables grow lazily (PageAllocator.ensure) and recycle on finish;
    admission is FIFO, gated on each request's worst-case pages.
  * `decode_horizon` decode steps per `step()`; tokens a request emits past
    its eos / budget inside a chunk are discarded.
  * One host sync per `step()`: the chunk's tokens and the admitted
    requests' first tokens come back in one `.cpu()`.
  * A multimodal model (one whose `prefill_paged` takes `video`, i.e.
    models/mllm.VideoMLLM) serves video prompts: `submit(..., video=)`
    keeps the pixels and admission runs the video prefill on the
    bucket-padded ids. A text-only model refuses `video=`.

The page pools are written in place (the JAX engine donates them). Greedy
by default; `temperature > 0` samples from a `torch.Generator` seeded with
`seed`. Mesh serving is not ported (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Optional

import numpy as np
import torch

from internvideo_tpu_torch.nn.paged_cache import PageAllocator


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (L,) int32
    max_new_tokens: int
    video: Optional[torch.Tensor] = None  # (T, H, W, 3) pixels of a video prompt
    tokens: list = dataclasses.field(default_factory=list)  # generated
    finished: bool = False


@dataclasses.dataclass
class _Slot:
    rid: Optional[int] = None  # None = free
    seq_len: int = 0  # tokens in cache (prompt + generated so far)
    budget: int = 0  # max_new_tokens remaining
    last_token: int = 0  # next decode input


class ServingEngine:
    """Fixed-batch continuous scheduler for an MLATransformer or a VideoMLLM
    with an M2LA text model.

    Args:
      model: the model (prefill_paged / decode_step_paged / _head), on its
        device; its parameters are the served weights.
      max_batch: decode batch width (slots).
      num_pages: page-pool size shared by all slots (+1 trash page is
        allocated internally).
      max_len: cap on prompt + generation length per sequence (sets the
        block-table width).
      prompt_buckets: padded prefill lengths.
      decode_horizon: decode steps per `step()`.
      temperature: 0 = greedy (generate()-parity); > 0 = categorical
        sampling at that temperature (RL rollouts).
      seed: sampling stream seed (ignored when temperature == 0).
    """

    def __init__(self, model, *, max_batch: int = 4, page_size: int = 16,
                 num_pages: int = 256, max_len: int = 512,
                 prompt_buckets: tuple = (32, 128, 512), eos_token_id: Optional[int] = None,
                 impl: Optional[str] = None, decode_horizon: int = 1,
                 temperature: float = 0.0, seed: int = 0, mesh=None, rules=None):
        if mesh is not None or rules is not None:
            raise NotImplementedError(
                "mesh serving (head-parallel decode, sharded GEMMs) is not ported yet "
                "(ROADMAP queue 1, item 8)")
        # the text model's config: bare LMs carry `cfg`, a VideoMLLM nests it
        # under `config.text` (the page pool is the text model's latent cache)
        cfg = model.cfg if hasattr(model, "cfg") else model.config.text
        if not hasattr(cfg, "mla"):
            raise ValueError("the engine drives latent (M2LA) page pools; a dense-GQA model "
                             "serves through generate(paged=False)")
        self.model = model
        self.device = model.device
        self.max_batch, self.page_size = max_batch, page_size
        self.max_len = max_len
        self.buckets = tuple(sorted(prompt_buckets))
        if self.buckets[-1] > max_len:
            raise ValueError("largest prompt bucket exceeds max_len")
        self.eos = eos_token_id
        if decode_horizon < 1:
            raise ValueError("decode_horizon must be >= 1")
        self.horizon = decode_horizon
        self.impl = impl
        # the table width absorbs up to horizon - 1 overshoot tokens a
        # finishing request decodes past its budget inside a chunk: columns
        # never allocated stay on the trash page
        self.max_pages = -(-(max_len + decode_horizon) // page_size)
        self.num_pages = num_pages
        self.alloc = PageAllocator(num_pages, page_size)
        self.trash_page = num_pages  # reserved: writes from idle slots
        # worst-case page reservation per slot: admission is gated so that
        # PageAllocator.ensure can never fail mid-run
        self._worst_pages = [0] * max_batch
        cache_dtype = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32
        # zeros, not torch.empty: the pool starts as defined values
        self.pages = [torch.zeros((num_pages + 1, page_size, cfg.mla.cache_dim),
                                  dtype=cache_dtype, device=self.device)
                      for _ in range(cfg.num_layers)]
        self.tables = np.full((max_batch, self.max_pages), self.trash_page, np.int32)
        self.slots = [_Slot() for _ in range(max_batch)]
        self.pending: list[Request] = []
        self.requests: dict[int, Request] = {}
        self._next_rid = 0
        self.temperature = float(temperature)
        self._gen = torch.Generator(self.device).manual_seed(seed)
        # multimodal iff the paged prompt pass takes pixels
        self._multimodal = "video" in inspect.signature(model.prefill_paged).parameters

    def _sample(self, logits):
        logits = logits.float()
        if self.temperature > 0:
            probs = torch.softmax(logits / self.temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return logits.argmax(dim=-1)

    # -- public API ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *, video=None) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if video is not None and not self._multimodal:
            raise ValueError("video prompts need a multimodal model (prefill_paged with a "
                             "`video` operand, e.g. models/mllm.VideoMLLM)")
        if len(prompt) > self.buckets[-1]:
            raise ValueError(f"prompt ({len(prompt)}) exceeds the largest bucket "
                             f"({self.buckets[-1]})")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError("prompt + max_new_tokens exceeds max_len")
        need = self._request_worst_pages(prompt, max_new_tokens)
        if need > self.num_pages:
            raise ValueError(f"request needs up to {need} pages but the pool has only "
                             f"{self.num_pages}; raise num_pages")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, max_new_tokens,
                      video=None if video is None else torch.as_tensor(video))
        self.requests[rid] = req
        self.pending.append(req)
        return rid

    def has_work(self) -> bool:
        return bool(self.pending) or any(s.rid is not None for s in self.slots)

    @torch.no_grad()
    def step(self) -> list[tuple[int, int, bool]]:
        """Admit what fits, run `decode_horizon` decode steps. Returns
        [(rid, token, finished)] events emitted this step.

        Invariant: slot.seq_len == latent entries in the cache. A decode
        step writes its input token's entry at position seq_len and returns
        the next token, which stays outside the cache until it is decoded.
        First tokens of admissions stay on the card until the step's single
        host sync."""
        events = []
        admitted = []  # (slot, first-token tensor (1,) on the card)
        for i in range(self.max_batch):
            if self.slots[i].rid is None and self.pending:
                # page-gated FIFO admission (no skip-ahead)
                need = self._request_worst_pages(self.pending[0].prompt,
                                                 self.pending[0].max_new_tokens)
                if need > self._unreserved_free_pages():
                    break
                self._worst_pages[i] = need
                admitted.append((i, self._admit(i, self.pending.pop(0))))
        active = [i for i, s in enumerate(self.slots) if s.rid is not None]
        if not active:
            return events
        for i in active:
            self._sync_table(i, min(self.slots[i].seq_len + self.horizon, self.max_len))
        tok = torch.tensor([s.last_token for s in self.slots], dtype=torch.int64,
                           device=self.device)
        for i, first in admitted:  # on the card: no fetch before decode
            tok[i] = first[0]
        seq_lens = torch.tensor([s.seq_len for s in self.slots], dtype=torch.int32,
                                device=self.device)
        tables = torch.from_numpy(self.tables).to(self.device)
        toks = []
        for _ in range(self.horizon):
            out = self.model.decode_step_paged(tok[:, None], self.pages, tables, seq_lens,
                                               self.page_size, impl=self.impl)
            tok = self._sample(out.logits[:, -1])
            toks.append(tok)
            seq_lens = seq_lens + 1
        # the step's single host sync
        fetched = torch.cat([torch.stack(toks, 1).flatten()]
                            + [f for _, f in admitted]).cpu().numpy()
        nxt = fetched[:self.max_batch * self.horizon].reshape(self.max_batch, self.horizon)
        firsts = fetched[self.max_batch * self.horizon:]
        for (i, _), fv in zip(admitted, firsts):
            events.append(self._emit(i, int(fv)))
        for i in active:
            s = self.slots[i]
            if s.rid is None:  # admitted request finished on its first token
                continue
            for k in range(self.horizon):
                if self.slots[i] is not s:  # finished mid-chunk: the rest is
                    break  # discarded
                s.seq_len += 1  # the step's input-token entry landed
                events.append(self._emit(i, int(nxt[i, k])))
        return events

    def run(self) -> dict[int, np.ndarray]:
        """Drain all submitted requests; returns rid -> generated ids."""
        while self.has_work():
            self.step()
        return {rid: np.asarray(r.tokens, np.int32) for rid, r in self.requests.items()}

    def reset(self, seed: Optional[int] = None):
        """Clear all scheduling state but keep the page pool; `seed`
        restarts the sampling stream, None keeps it running."""
        if seed is not None:
            self._gen.manual_seed(seed)
        self.alloc = PageAllocator(self.num_pages, self.page_size)
        self.tables[:] = self.trash_page
        self.slots = [_Slot() for _ in range(self.max_batch)]
        self._worst_pages = [0] * self.max_batch
        self.pending, self.requests = [], {}

    # -- internals ----------------------------------------------------------

    def _request_worst_pages(self, prompt, max_new_tokens: int) -> int:
        """Worst-case pages a request can ever hold: its table is grown to
        the prefill bucket at admission, then to min(seq_len + horizon,
        max_len) each chunk."""
        bucket = self._bucket(len(prompt))
        worst = min(max(bucket, len(prompt) + max_new_tokens + self.horizon), self.max_len)
        return -(-worst // self.page_size)

    def _unreserved_free_pages(self) -> int:
        """Free pages not spoken for by running sequences' worst cases."""
        outstanding = 0
        for i, s in enumerate(self.slots):
            if s.rid is not None:
                held = len(self.alloc.tables.get(i, ()))
                outstanding += max(0, self._worst_pages[i] - held)
        return len(self.alloc.free) - outstanding

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds buckets")

    def _sync_table(self, slot: int, new_len: int):
        table = self.alloc.ensure(slot, new_len)
        self.tables[slot, :len(table)] = table

    def _admit(self, slot: int, req: Request):
        """Prefill `req` (with its video on a multimodal model) into `slot`,
        padded to its bucket; returns the first generated token as a (1,)
        tensor on the card."""
        bucket = self._bucket(len(req.prompt))
        real = len(req.prompt)
        self._sync_table(slot, bucket)  # pad entries must land in-table
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :real] = req.prompt
        table = torch.from_numpy(self.tables[slot:slot + 1]).to(self.device)
        ids = torch.from_numpy(ids).to(self.device)
        if self._multimodal:
            video = None if req.video is None else req.video.to(self.device)[None]
            out = self.model.prefill_paged(ids, video, self.pages, table, self.page_size)
        else:
            out = self.model.prefill_paged(ids, self.pages, table, self.page_size)
        # logits at the true last prompt token, not the padded tail
        first = self._sample(self.model._head(out.hidden[:, real - 1:real])[:, -1])
        s = self.slots[slot]
        s.rid, s.seq_len, s.budget = req.rid, real, req.max_new_tokens
        return first

    def _emit(self, slot: int, token: int) -> tuple[int, int, bool]:
        s = self.slots[slot]
        req = self.requests[s.rid]
        req.tokens.append(token)
        s.last_token = token
        s.budget -= 1
        done = s.budget <= 0 or (self.eos is not None and token == self.eos)
        if done:
            req.finished = True
            self.alloc.release(slot)
            self.tables[slot] = self.trash_page
            self.slots[slot] = _Slot()
            self._worst_pages[slot] = 0
        return (req.rid, token, done)
