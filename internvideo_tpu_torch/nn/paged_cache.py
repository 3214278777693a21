"""Paged latent cache: block-table memory management for batched serving.

Port of internvideo_tpu/nn/paged_cache.py. The pool is one device tensor of
fixed-size pages per layer, (num_pages, page_size, R + P) M2LA latent
entries; each sequence owns a block table of page ids, so sequences grow
without reallocation and freed pages recycle. Host-side allocation
(`PageAllocator`) is plain Python.

Unlike JAX, where the serving engine donates the pool to each step, the
port writes entries in place (`paged_write` is an `index_put_`), so a step
copies none of the 36 pools.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


class PageAllocator:
    """Host-side page bookkeeping: alloc/free page ids per sequence."""

    def __init__(self, num_pages: int, page_size: int):
        self.page_size = page_size
        self.free = list(range(num_pages - 1, -1, -1))
        self.tables: dict[int, list[int]] = {}
        self.lengths: dict[int, int] = {}

    def ensure(self, seq_id: int, new_len: int) -> list[int]:
        """Grow seq to new_len tokens; returns its page table."""
        table = self.tables.setdefault(seq_id, [])
        need = -(-new_len // self.page_size)  # ceil
        while len(table) < need:
            if not self.free:
                raise RuntimeError("paged cache out of pages")
            table.append(self.free.pop())
        self.lengths[seq_id] = new_len
        return table

    def release(self, seq_id: int):
        for p in self.tables.pop(seq_id, []):
            self.free.append(p)
        self.lengths.pop(seq_id, None)


@dataclasses.dataclass
class PagedCacheState:
    pages: torch.Tensor  # (num_pages, page_size, cache_dim)

    @classmethod
    def create(cls, num_pages, page_size, cache_dim, dtype=torch.bfloat16, device=None):
        # zeros, never torch.empty: slots past a sequence's length are masked,
        # but the pool starts as defined values, as in JAX
        return cls(torch.zeros((num_pages, page_size, cache_dim), dtype=dtype, device=device))


def paged_write(
    pages: torch.Tensor,  # (P, page_size, C)
    entries: torch.Tensor,  # (n, C) new token entries
    page_ids: torch.Tensor,  # (n,) destination page per token
    offsets: torch.Tensor,  # (n,) slot within the page
) -> torch.Tensor:
    """Write `entries` into `pages` in place; returns `pages`."""
    pages.index_put_((page_ids.long(), offsets.long()), entries.to(pages.dtype))
    return pages


def positions_to_slots(start: int, count: int, table: list[int], page_size: int):
    """Host helper: token positions [start, start+count) -> (page_ids, offsets)."""
    pos = np.arange(start, start + count)
    page_idx = pos // page_size
    return (
        np.asarray([table[i] for i in page_idx], np.int32),
        (pos % page_size).astype(np.int32),
    )


def paged_gather(pages: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """-> (max_pages * page_size, C) contiguous copy of a sequence's cache."""
    g = pages[block_table.long()]  # (max_pages, page_size, C)
    return g.reshape(-1, g.shape[-1])


def batched_paged_gather(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """-> (B, max_pages * page_size, C)."""
    g = pages[block_tables.long()]  # (B, max_pages, page_size, C)
    b, mp, ps, c = g.shape
    return g.reshape(b, mp * ps, c)
