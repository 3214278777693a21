"""Sample packing: fill fixed-length token budgets with whole samples.

Port of internvideo_tpu/data/packing.py (pure Python + numpy, the same
functions and results). Host-side counterpart of xtuner's soft/hard packing
(InternVideo3_sft/xtuner/v1/datasets/packing.py:24-474): soft packing keeps
a buffer of pending samples and greedily closes the pack whose remaining
space best matches the next sample ("closest-sum" buffer packing); hard
packing additionally splits over-long samples.

Output is a list of packs (lists of sample indices); `SequenceContext.
from_segments` turns a pack into the padded device batch. Packing
efficiency Σlᵢ/(P·L) is returned for logging (the reference logs the
related Σlᵢ²/(Σlᵢ)² attention-efficiency ratio every step —
train_engine.py:268-288).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class PackingResult:
    packs: list[list[int]]  # sample indices per pack
    efficiency: float  # fraction of budget filled with real tokens
    dropped: list[int]  # samples longer than the budget (soft mode)


def soft_pack(
    lengths: Sequence[int],
    pack_max_length: int,
    *,
    buffer_size: int = 512,
) -> PackingResult:
    """Greedy closest-fit packing with a look-ahead buffer."""
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    dropped = [i for i in order if lengths[i] > pack_max_length]
    pending = [i for i in order if lengths[i] <= pack_max_length]

    packs: list[list[int]] = []
    remaining: list[int] = []
    for idx in pending:
        n = lengths[idx]
        # best-fit: the open pack with the least leftover after adding
        best, best_left = None, None
        for pi in range(max(0, len(packs) - buffer_size), len(packs)):
            left = remaining[pi] - n
            if left >= 0 and (best_left is None or left < best_left):
                best, best_left = pi, left
        if best is None:
            packs.append([idx])
            remaining.append(pack_max_length - n)
        else:
            packs[best].append(idx)
            remaining[best] = best_left
    used = sum(lengths[i] for p in packs for i in p)
    eff = used / max(len(packs) * pack_max_length, 1)
    return PackingResult(packs=packs, efficiency=eff, dropped=dropped)


@dataclasses.dataclass
class HardPackResult:
    # per pack: (sample_idx, start, end) token ranges — full split bookkeeping
    packs: list[list[tuple[int, int, int]]]
    efficiency: float


def hard_pack(
    lengths: Sequence[int], pack_max_length: int
) -> HardPackResult:
    """Stream-concatenate samples, splitting across pack boundaries.

    Every pack except possibly the last is exactly full; each entry records
    which token range [start, end) of which sample fills it, so the caller
    (or `hard_pack_streams`) can slice real token arrays.
    """
    packs: list[list[tuple[int, int, int]]] = []
    cur: list[tuple[int, int, int]] = []
    space = pack_max_length
    for i, n in enumerate(lengths):
        pos = 0
        while pos < n:
            take = min(n - pos, space)
            cur.append((i, pos, pos + take))
            space -= take
            pos += take
            if space == 0:
                packs.append(cur)
                cur, space = [], pack_max_length
    if cur:
        packs.append(cur)
    total = sum(lengths)
    eff = total / max(
        ((total + pack_max_length - 1) // pack_max_length) * pack_max_length, 1
    )
    return HardPackResult(packs=packs, efficiency=eff)


def hard_pack_streams(
    streams: Sequence, pack_max_length: int, *, pad_value: int = 0
):
    """Materialize hard packs from per-sample token arrays.

    Returns (tokens (P, L) int array, segment_ids (P, L) — sample index per
    token, -1 on the final pack's padding). The actual token-stream
    splitting the reference's hard packing performs (packing.py:24-474).
    """
    lengths = [len(s) for s in streams]
    res = hard_pack(lengths, pack_max_length)
    p = len(res.packs)
    tokens = np.full((p, pack_max_length), pad_value, np.int64)
    segs = np.full((p, pack_max_length), -1, np.int32)
    for pi, chunks in enumerate(res.packs):
        off = 0
        for idx, start, end in chunks:
            n = end - start
            tokens[pi, off : off + n] = np.asarray(streams[idx][start:end])
            segs[pi, off : off + n] = idx
            off += n
    return tokens, segs, res


def attention_efficiency(lengths: Sequence[int]) -> float:
    """Σlᵢ² / (Σlᵢ)² — quadratic-cost efficiency of a pack
    (xtuner train_engine.py:268-288)."""
    s = sum(lengths)
    return sum(l * l for l in lengths) / max(s * s, 1)
