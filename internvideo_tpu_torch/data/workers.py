"""Multiprocess host decode workers.

Port of internvideo_tpu/data/workers.py: a bounded pool that maps
`dataset[i]` + collate across worker processes and yields ordered,
ready-to-ship numpy batches; `loader.prefetch_to_device` or the Trainer's
`put_batch` turns them into tensors in the parent.

  * fork start method by default: workers inherit the dataset without
    pickling. Workers return numpy and never touch CUDA; a forked child
    of a process that has initialised CUDA cannot use it;
  * bounded look-ahead (`prefetch` outstanding batches): decode stays
    ahead of the step without hoarding host memory;
  * deterministic: batch order is the index order; shuffling is the
    caller's (StatefulIterator), so iteration stays resumable.
"""

from __future__ import annotations

import collections
import multiprocessing as mp
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

_WORKER_STATE: dict = {}


def default_collate(items: Sequence) -> dict:
    """Stack dict-of-array samples into batch arrays."""
    first = items[0]
    if isinstance(first, dict):
        return {k: default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        cols = [default_collate([it[j] for it in items]) for j in range(len(first))]
        if hasattr(first, "_fields"):  # namedtuple: positional constructor
            return type(first)(*cols)
        return type(first)(cols)
    if isinstance(first, np.ndarray):
        return np.stack(items)
    return np.asarray(items)


def _init_worker(dataset, collate):
    _WORKER_STATE["dataset"] = dataset
    _WORKER_STATE["collate"] = collate


def _load_batch(indices):
    ds = _WORKER_STATE["dataset"]
    return _WORKER_STATE["collate"]([ds[i] for i in indices])


class WorkerPool:
    """Ordered multiprocess batch loader over an indexable dataset.

    >>> pool = WorkerPool(ds, batch_size=8, num_workers=4)
    >>> for batch in pool.iterate(index_iter):  # or iterate() for range(len)
    ...     step(batch)
    """

    def __init__(self, dataset, batch_size: int, num_workers: int = 4, *,
                 collate_fn: Callable = default_collate, prefetch: int = 4,
                 drop_last: bool = True, start_method: str = "fork"):
        assert num_workers >= 0
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.collate_fn = collate_fn
        self.prefetch = max(prefetch, 1)
        self.drop_last = drop_last
        self.start_method = start_method

    def _batches(self, indices: Iterable[int]) -> Iterator[list[int]]:
        buf: list[int] = []
        for i in indices:
            buf.append(i)
            if len(buf) == self.batch_size:
                yield buf
                buf = []
        if buf and not self.drop_last:
            yield buf

    def iterate(self, indices: Optional[Iterable[int]] = None) -> Iterator:
        if indices is None:
            indices = range(len(self.dataset))
        if self.num_workers == 0:  # in-process (debugging, tests)
            # no module-global state here: two interleaved in-process pools
            # must not share a dataset
            for b in self._batches(indices):
                yield self.collate_fn([self.dataset[i] for i in b])
            return
        ctx = mp.get_context(self.start_method)
        with ctx.Pool(self.num_workers, initializer=_init_worker,
                      initargs=(self.dataset, self.collate_fn)) as pool:
            pending: collections.deque = collections.deque()
            for b in self._batches(indices):
                pending.append(pool.apply_async(_load_batch, (b,)))
                if len(pending) >= self.prefetch:
                    yield pending.popleft().get()
            while pending:
                yield pending.popleft().get()
