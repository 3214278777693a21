"""The paged absorbed-MLA decode (K6's plain version) and the paged cache of
the PyTorch port vs the JAX package.

On the CPU `paged_mla_decode` runs its plain version; it is held against
the JAX Pallas kernel in interpret mode with ragged lengths, a partial last
page, shuffled page ownership and every page grouping of
tests/test_quant_rl_paged.py:162,243, at that file's 1e-4. The CUDA kernel
is held against the plain version on the card by
test_torch_paged_decode_kernel_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internvideo_tpu.nn import paged_cache as jpc
from internvideo_tpu.ops.paged_decode import paged_mla_decode as jax_paged_decode
from internvideo_tpu_torch.nn import paged_cache as pc
from internvideo_tpu_torch.ops import _build
from internvideo_tpu_torch.ops import paged_decode as pd


def _inputs(b, h, r, p_dim, page_size, max_pages, seed):
    rng = np.random.default_rng(seed)
    num_pages = b * max_pages
    q_lat = rng.standard_normal((b, h, r)).astype(np.float32)
    q_pe = rng.standard_normal((b, h, p_dim)).astype(np.float32)
    pages = rng.standard_normal((num_pages, page_size, r + p_dim)).astype(np.float32)
    return rng, q_lat, q_pe, pages


def _tables(rng, seq_lens, max_pages, page_size, shuffle):
    tables = np.zeros((len(seq_lens), max_pages), np.int32)
    for s, n_tok in enumerate(seq_lens):
        n = -(-int(n_tok) // page_size)
        own = rng.permutation(max_pages)[:n] if shuffle else np.arange(n)
        tables[s, :n] = s * max_pages + own
    return tables


def test_plain_matches_jax_kernel_ragged_lengths():
    """tests/test_quant_rl_paged.py:162: 1, 3 and 5 pages, a partial last page."""
    rng, q_lat, q_pe, pages = _inputs(3, 4, 32, 16, 4, 5, seed=0)
    seq_lens = np.array([3, 9, 17], np.int32)
    tables = _tables(rng, seq_lens, 5, 4, shuffle=False)
    ref = jax_paged_decode(*(jnp.asarray(x) for x in (q_lat, q_pe, pages, tables, seq_lens)),
                           softmax_scale=0.17, interpret=True)
    out = pd.paged_mla_decode(*(torch.from_numpy(x) for x in (q_lat, q_pe, pages, tables,
                                                              seq_lens)), softmax_scale=0.17)
    assert out.shape == (3, 4, 32) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("trial", range(3))
def test_plain_matches_jax_kernel_page_groups(trial):
    """tests/test_quant_rl_paged.py:243: fuzzed lengths over shuffled pages
    against the JAX kernel at every page grouping G (the port accepts
    `pages_per_block` for signature parity and has no grouping)."""
    rng, q_lat, q_pe, pages = _inputs(4, 4, 16, 8, 4, 11, seed=7)
    for _ in range(trial + 1):
        seq_lens = rng.integers(1, 11 * 4 + 1, 4).astype(np.int32)
    tables = _tables(rng, seq_lens, 11, 4, shuffle=True)
    args = (q_lat, q_pe, pages, tables, seq_lens)
    out = pd.paged_mla_decode(*(torch.from_numpy(x) for x in args), softmax_scale=0.25,
                              pages_per_block=3)
    for g in (1, 3, 4, 16):
        ref = jax_paged_decode(*(jnp.asarray(x) for x in args), softmax_scale=0.25,
                               pages_per_block=g, interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_masked_slots_never_reach_the_sum():
    """Table columns past ceil(seq_len / page_size) point at a trash page and
    the slots past seq_len inside the last page hold garbage: the output
    equals the clean pool's. The plain version multiplies the masked slots
    by a probability of 0, so its garbage is finite (1e4); the kernel, which
    never loads them, is held on a NaN trash page by
    test_torch_paged_decode_kernel_cuda.py."""
    rng, q_lat, q_pe, pages = _inputs(2, 4, 16, 8, 4, 4, seed=3)
    seq_lens = np.array([5, 10], np.int32)
    tables = _tables(rng, seq_lens, 4, 4, shuffle=True)
    clean = pd.paged_mla_decode(*(torch.from_numpy(x) for x in (q_lat, q_pe, pages, tables,
                                                                seq_lens)), softmax_scale=0.3)
    dirty = np.concatenate([pages, np.full((1,) + pages.shape[1:], 1e4, np.float32)])
    for s, n_tok in enumerate(seq_lens):
        n = -(-int(n_tok) // 4)
        tables[s, n:] = len(pages)
        dirty[tables[s, n - 1], n_tok - (n - 1) * 4:] = 1e4
    out = pd.paged_mla_decode(*(torch.from_numpy(x) for x in (q_lat, q_pe, dirty, tables,
                                                              seq_lens)), softmax_scale=0.3)
    np.testing.assert_allclose(out.numpy(), clean.numpy(), atol=1e-6, rtol=0)


def test_page_allocator_and_cache_helpers_match_jax():
    a, ja = pc.PageAllocator(6, 4), jpc.PageAllocator(6, 4)
    for op in [("ensure", 0, 5), ("ensure", 1, 3), ("ensure", 0, 9), ("release", 1),
               ("ensure", 2, 8), ("release", 0), ("ensure", 3, 4)]:
        getattr(a, op[0])(*op[1:])
        getattr(ja, op[0])(*op[1:])
        assert (a.free, a.tables, a.lengths) == (ja.free, ja.tables, ja.lengths), op
    with pytest.raises(RuntimeError, match="out of pages"):
        a.ensure(4, 100)
    for got, want in zip(pc.positions_to_slots(3, 6, [5, 2, 7], 4),
                         jpc.positions_to_slots(3, 6, [5, 2, 7], 4)):
        np.testing.assert_array_equal(got, want)

    rng = np.random.default_rng(5)
    pool = rng.standard_normal((6, 4, 3)).astype(np.float32)
    entries = rng.standard_normal((5, 3)).astype(np.float32)
    pids, offs = np.array([1, 1, 4, 0, 5], np.int32), np.array([0, 3, 2, 1, 3], np.int32)
    want = np.asarray(jpc.paged_write(jnp.asarray(pool), jnp.asarray(entries),
                                      jnp.asarray(pids), jnp.asarray(offs)))
    tpool = torch.from_numpy(pool.copy())
    got = pc.paged_write(tpool, torch.from_numpy(entries), torch.from_numpy(pids),
                         torch.from_numpy(offs))
    assert got is tpool  # in place
    np.testing.assert_array_equal(got.numpy(), want)
    tables = np.array([[2, 0], [5, 1]], np.int32)
    np.testing.assert_array_equal(
        pc.batched_paged_gather(tpool, torch.from_numpy(tables)).numpy(),
        np.asarray(jpc.batched_paged_gather(jnp.asarray(want), jnp.asarray(tables))))
    np.testing.assert_array_equal(
        pc.paged_gather(tpool, torch.from_numpy(tables[1])).numpy(),
        np.asarray(jpc.paged_gather(jnp.asarray(want), jnp.asarray(tables[1]))))
    state = pc.PagedCacheState.create(3, 4, 5, dtype=torch.float32)
    assert state.pages.shape == (3, 4, 5) and not state.pages.any()


def test_cpu_paged_decode_never_builds_or_launches(monkeypatch):
    def no_build():
        raise AssertionError("the CUDA library was requested for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    pd.reset_launch_count()
    rng, q_lat, q_pe, pages = _inputs(1, 2, 8, 8, 4, 2, seed=9)
    tables = np.array([[0, 1]], np.int32)
    pd.paged_mla_decode(*(torch.from_numpy(x) for x in (q_lat, q_pe, pages, tables,
                                                         np.array([6], np.int32))),
                        softmax_scale=0.5)
    assert pd.launch_count() == 0


def test_split_len_fills_the_card_at_the_path_shape():
    """8 sequences x 4 head groups at up to 2176 tokens: 9 splits of 256,
    288 CTAs for 132 SMs; a tiny shape still takes one 16-token tile."""
    assert pd.split_len_for(8, 32, 34 * 64) == 256
    assert pd.split_len_for(1, 2, 8) == 16


@pytest.mark.parametrize("h, r, p_dim", [(32, 112, 16), (20, 64, 8)],
                         ids=["qwen3_8b_mla_heads", "hico_2b_heads"])
def test_plain_matches_jax_kernel_at_the_paths_head_counts(h, r, p_dim):
    """The serving paths' head counts with their R : P ratios (896 : 128,
    512 : 64) at narrow R: ragged lengths over shuffled pages against the
    JAX kernel in interpret mode at 1e-4."""
    rng, q_lat, q_pe, pages = _inputs(3, h, r, p_dim, 8, 6, seed=h)
    seq_lens = np.array([1, 23, 48], np.int32)
    tables = _tables(rng, seq_lens, 6, 8, shuffle=True)
    args = (q_lat, q_pe, pages, tables, seq_lens)
    ref = jax_paged_decode(*(jnp.asarray(x) for x in args), softmax_scale=0.2, interpret=True)
    out = pd.paged_mla_decode(*(torch.from_numpy(x) for x in args), softmax_scale=0.2)
    assert out.shape == (3, h, r)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_bf16_split_len_keeps_one_wave_at_the_path_shapes():
    """The bf16 kernel's CTA takes all heads of one sequence and holds its SM
    alone, so batch x splits stays within the SMs: the 8B decode's 8
    sequences of up to 34 pages take 16 splits of 144 tokens (128 CTAs on
    132 SMs), one 32,768-token sequence 128 of 256; a tiny one a 16-token
    stage."""
    assert pd.split_len_bf16(8, 34 * 64, 132) == 144
    assert pd.split_len_bf16(1, 32768, 132) == 256
    assert pd.split_len_bf16(1, 8, 132) == 16
    for b, tokens in ((8, 34 * 64), (8, 17 * 64), (1, 32768), (3, 5000), (200, 2048)):
        split = pd.split_len_bf16(b, tokens, 132)
        assert split % 16 == 0
        assert b * -(-tokens // split) <= max(132, b)


def test_bf16_wrapper_refuses_shapes_it_does_not_instantiate():
    """The bf16 kernel exists at (R, P) = (896, 128) and (512, 64) with at
    most 32 heads; another shape raises before anything reaches the card,
    naming the queue that would add it."""
    args = lambda h, r, p: (torch.zeros(1, h, r, dtype=torch.bfloat16),  # noqa: E731
                            torch.zeros(1, h, p, dtype=torch.bfloat16),
                            torch.zeros(2, 4, r + p, dtype=torch.bfloat16),
                            torch.zeros(1, 2, dtype=torch.int32), torch.ones(1, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        pd._paged_decode_cuda(*args(2, 64, 16), 1.0)
    with pytest.raises(NotImplementedError, match="at most 32 heads"):
        pd._paged_decode_cuda(*args(40, 512, 64), 1.0)
