"""Multi-source scheduling, resumable iteration, device prefetch.

Port of internvideo_tpu/data/loader.py:

  * MetaLoader: deterministic weighted interleave of several sources, the
    order shuffled from `seed + epoch` so that every host computes it alike;
  * StatefulIterator: a step-resumable index iterator that rebuilds the
    permutation from (seed, epoch) and jumps to the step offset, with
    per-host strided shards;
  * prefetch_to_device: a background thread that moves batches to the
    device `size` batches ahead. On a CUDA device each host leaf is pinned
    and copied with `non_blocking=True` on a side stream; the consumer's
    stream waits on an event recorded after the copies, and every tensor
    is marked as used by the consumer's stream (`record_stream`), so that a
    step never reads a half-copied batch and the allocator never hands the
    batch's memory to the side stream while the step still reads it.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch


class MetaLoader:
    """Interleave iterators from several sources in a seeded random order.

    Each epoch: a schedule listing source s exactly counts[s] times (by
    default len(s)), shuffled with `seed + epoch`, then consumed in order.
    """

    def __init__(self, sources: dict[str, Iterable], *, counts: Optional[dict[str, int]] = None,
                 seed: int = 0, epoch: int = 0):
        self.sources = sources
        self.counts = counts or {k: len(v) for k, v in sources.items()}
        self.seed = seed
        self.epoch = epoch

    def schedule(self) -> list[str]:
        names = []
        for k, n in self.counts.items():
            names += [k] * n
        rng = np.random.default_rng(self.seed + self.epoch)
        rng.shuffle(names)
        return names

    def __len__(self):
        return sum(self.counts.values())

    def __iter__(self):
        its = {k: iter(v) for k, v in self.sources.items()}
        for name in self.schedule():
            try:
                item = next(its[name])
            except StopIteration:
                its[name] = iter(self.sources[name])
                try:
                    item = next(its[name])
                except StopIteration:
                    # a bare re-raise would leave the generator as PEP 479's
                    # opaque RuntimeError
                    raise ValueError(f"MetaLoader source {name!r} is empty") from None
            yield name, item


class StatefulIterator:
    """Seeded, epoch-aware, step-resumable index iterator over a dataset.

    `num_shards` / `shard_id` give per-host sharding: every host computes
    the same epoch permutation from the seed and takes its strided slice.
    """

    def __init__(self, n: int, *, seed: int = 0, shuffle: bool = True, num_shards: int = 1,
                 shard_id: int = 0):
        self.n = n
        self.seed = seed
        self.shuffle = shuffle
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.epoch = 0
        self.step = 0  # position inside this shard's epoch slice

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "step": self.step}

    def load_state_dict(self, s: dict):
        self.epoch, self.step = s["epoch"], s["step"]

    def _perm(self) -> np.ndarray:
        if self.shuffle:
            perm = np.random.default_rng(self.seed + self.epoch).permutation(self.n)
        else:
            perm = np.arange(self.n)
        return perm[self.shard_id::self.num_shards]

    def __iter__(self) -> Iterator[int]:
        while True:
            perm = self._perm()
            while self.step < len(perm):
                idx = int(perm[self.step])
                self.step += 1
                yield idx
            self.epoch += 1
            self.step = 0


def _map_leaves(fn, tree):
    """`fn` on every array leaf (numpy array or scalar, tensor) of nested
    dicts / lists / tuples; other leaves (strings, ids) pass through."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_leaves(fn, v) for v in tree]
        if hasattr(tree, "_fields"):  # namedtuple: positional constructor
            return type(tree)(*out)
        return type(tree)(out)
    if isinstance(tree, (np.ndarray, np.generic, torch.Tensor)):
        return fn(tree)
    return tree


def _cuda_copy(x, device: torch.device) -> torch.Tensor:
    """Pinned host tensor -> `device`, asynchronously on the current stream."""
    t = torch.as_tensor(x)
    if t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def prefetch_to_device(it: Iterable, device, *, size: int = 2, sharding=None) -> Iterator:
    """Yield the batches of `it` as tensors on `device`, moved by a
    background thread `size` batches ahead.

    Producer errors (corrupt media, an out-of-memory copy) re-raise in the
    consumer instead of ending the data; closing the generator early (break,
    close) stops the producer at its next batch and drops the queued ones.
    """
    if sharding is not None:
        raise NotImplementedError(
            "prefetch_to_device(sharding=...): sharded batches are not ported yet "
            "(ROADMAP queue 1, item 8)")
    device = torch.device(device)
    on_cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if on_cuda else None
    q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    end = object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def producer():
        try:
            for batch in it:
                if on_cuda:
                    with torch.cuda.stream(side):
                        batch = _map_leaves(lambda x: _cuda_copy(x, device), batch)
                        ready = torch.cuda.Event()
                        ready.record(side)
                else:
                    batch = _map_leaves(lambda x: torch.as_tensor(x).to(device), batch)
                    ready = None
                if not _put((batch, ready)):
                    return
        except BaseException as e:  # surface it in the consumer
            _put(e)
            return
        _put(end)

    thread = threading.Thread(target=producer, name="prefetch_to_device", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            batch, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                _map_leaves(lambda t: t.record_stream(consumer), batch)
            yield batch
    finally:
        stop.set()
        while not q.empty():  # drop the queued device batches
            try:
                q.get_nowait()
            except queue_mod.Empty:
                break
