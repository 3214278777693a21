"""K5's grouped-query and sliding-window backward (csrc/flash_bwd_causal_dq.cu,
csrc/flash_bwd_causal_dkv.cu) vs its plain PyTorch version, on the card.

Needs an NVIDIA GPU with nvcc (the kernels have no CPU mode), so every test
here is marked `cuda` and skips without a card. The file imports neither
jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_gqa_bwd_kernel_cuda.py -m cuda
"""

import pytest
import torch

from internvideo_tpu_torch.ops import flash_attention as fa

# (B, Sq, Sk, Hq, Hkv, D, keyword arguments): the JAX kernel tests' shapes
# (test_sliding_window_unaligned_grads, test_gqa causal and not, a causal
# window with the query offset 72 and a ragged S, test_window_fully_masked_
# rows_zero's rows without keys), a non-causal offset window whose last rows
# see no key, GQA with segments and -1 pads, and the qwen3_8b_dense head dim.
CASES = [
    (1, 200, 200, 2, 2, 64, dict(window=64)),
    (1, 128, 128, 8, 2, 64, {}),
    (1, 128, 128, 8, 2, 64, dict(causal=True)),
    (1, 128, 200, 4, 2, 64, dict(causal=True, window=50, q_position_offset=72)),
    (1, 256, 64, 2, 2, 64, dict(window=50)),
    (1, 200, 200, 2, 1, 64, dict(window=30, q_position_offset=72)),
    (2, 256, 256, 8, 2, 64, dict(causal=True, segments=True)),
    (2, 333, 333, 8, 2, 128, dict(causal=True)),
    (2, 333, 333, 8, 2, 128, dict(causal=True, window=128)),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the K5 backward kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(case, dtype, g):
    b, sq, sk, hq, hkv, d, kw = case
    kw = dict(kw)
    if kw.pop("segments", False):
        seg = (torch.arange(sk, device="cuda")[None].expand(b, sk) // 100).clone()
        seg[:, 220:] = -1  # pads meet each other
        kw.update(q_segment_ids=seg, kv_segment_ids=seg)
    q = torch.randn(b, sq, hq, d, device="cuda", generator=g).to(dtype)
    k, v = (torch.randn(b, sk, hkv, d, device="cuda", generator=g).to(dtype) for _ in range(2))
    do = torch.randn(b, sq, hq, d, device="cuda", generator=g).to(dtype)
    dlse = torch.randn(b, hq, sq, device="cuda", generator=g)
    return q, k, v, do, dlse, kw


def _kernel_grads(q, k, v, do, dlse, kw):
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    dl = torch.where(torch.isfinite(lse), dlse, 0.0)
    return torch.autograd.grad((out, lse), (q, k, v), (do, dl))


def _plain_grads(q, k, v, do, dlse, kw):
    causal, off = kw.get("causal", False), kw.get("q_position_offset", 0)
    segs = kw.get("q_segment_ids"), kw.get("kv_segment_ids")
    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_attention_ref_with_lse(q, k, v, scale, causal, off, *segs,
                                               kw.get("window"))
    dl = torch.where(torch.isfinite(lse), dlse, 0.0)
    return fa.flash_attention_bwd_ref(q, k, v, out, lse, do, scale, lse_ct=dl, causal=causal,
                                      q_position_offset=off, q_segment_ids=segs[0],
                                      kv_segment_ids=segs[1], window=kw.get("window"))


def _counter(kind, kw, gqa):
    return f"flash_bwd_causal_{kind}" + ("_window" if kw.get("window") else "_gqa" if gqa
                                         else "_seg")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain(dtype):
    """fp32: max-abs 5e-4 (the JAX grad bar); bf16: rel-L2 <= 1e-2; each
    launch counted under its name."""
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(0)
    for case in CASES:
        q, k, v, do, dlse, kw = _inputs(case, dt, g)
        names = [_counter(kind, kw, k.shape[2] != q.shape[2]) for kind in ("dq", "dkv")]
        before = [fa.launch_count(n) for n in names]
        got = _kernel_grads(q, k, v, do, dlse, kw)
        torch.cuda.synchronize()
        assert [fa.launch_count(n) for n in names] == [c + 1 for c in before], case
        want = _plain_grads(q, k, v, do, dlse, kw)
        for what, a, w in zip(("dq", "dk", "dv"), got, want):
            assert a.shape == w.shape and a.dtype == w.dtype, (case, what)
            if dt == torch.float32:
                torch.testing.assert_close(a, w, atol=5e-4, rtol=0, msg=f"{case} {what}")
            else:
                rel = ((a.float() - w.float()).norm() / w.float().norm()).item()
                assert rel <= 1e-2, (case, what, rel)


@pytest.mark.cuda
def test_rows_without_keys_and_determinism():
    """Rows that see no key get dq = 0; two calls give bit-identical dk / dv
    (the dk/dv kernel sums the group's q heads in a fixed order, no atomics)."""
    _card()
    g = torch.Generator("cuda").manual_seed(1)
    q, k, v, do, dlse, kw = _inputs((1, 256, 64, 2, 2, 64, dict(window=50)), torch.float32, g)
    dq = _kernel_grads(q, k, v, do, dlse, kw)[0]
    assert (dq[:, 113:] == 0).all() and dq[:, :113].abs().sum() > 0
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do, dlse, kw = _inputs((2, 333, 333, 8, 2, 128, dict(causal=True, window=128)),
                                        dtype, g)
        first, second = (_kernel_grads(q, k, v, do, dlse, kw) for _ in range(2))
        for a, b in zip(first[1:], second[1:]):
            assert torch.equal(a, b)


# Every instantiated (d_qk, d_v) pair at the tile edges of the wgmma
# backward (128-row dq CTAs over 64-key stages; dk/dv CTAs of 128 keys, or
# 64 at d_qk 256, over 64-row q steps): (B, Sq, Sk, Hq, Hkv, keyword
# arguments) with a ragged Sq < Sk and a query offset, groups of 8, 4 and 2,
# window band edges inside a tile (causal and not), and rows without keys.
PAIRS = [(256, 128), (128, 128), (64, 64), (64, 32), (32, 32)]
EDGE_CASES = [
    (1, 70, 150, 4, 2, dict(causal=True, q_position_offset=80)),
    (1, 200, 200, 8, 1, dict(causal=True, window=40)),
    (1, 130, 190, 4, 1, dict(window=70, q_position_offset=30)),
    (2, 333, 333, 2, 1, dict(causal=True)),
    (1, 256, 64, 2, 2, dict(window=50)),
]


def _views(b, s, h, d, dv, dtype, g):
    """k and v as strided views of one (B, S, H, 8 + d + dv) tensor whose
    first 8 elements are skipped: a base 16 bytes past the allocation's in
    bf16."""
    kv = torch.randn(b, s, h, 8 + d + dv, device="cuda", generator=g).to(dtype)
    return kv[..., 8:8 + d], kv[..., 8 + d:]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}_{p[1]}")
def test_backward_tile_edges(pair, dtype):
    """fp32: max-abs 5e-4; bf16: rel-L2 <= 1e-2; rows without keys get
    dq = 0; each launch counted under its name (window > GQA)."""
    _card()
    d, dv = pair
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(2)
    for b, sq, sk, hq, hkv, kw in EDGE_CASES:
        q = torch.randn(b, sq, hq, d, device="cuda", generator=g).to(dt)
        k, v = _views(b, sk, hkv, d, dv, dt, g)
        assert k.data_ptr() % 16 == 0 and k.stride(1) != d
        do = torch.randn(b, sq, hq, dv, device="cuda", generator=g).to(dt)
        dlse = torch.randn(b, hq, sq, device="cuda", generator=g)
        names = [_counter(kind, kw, hkv != hq) for kind in ("dq", "dkv")]
        before = [fa.launch_count(n) for n in names]
        got = _kernel_grads(q, k, v, do, dlse, kw)
        torch.cuda.synchronize()
        case = (b, sq, sk, hq, hkv, d, dv, kw, dtype)
        assert [fa.launch_count(n) for n in names] == [c + 1 for c in before], case
        want = _plain_grads(q, k, v, do, dlse, kw)
        _, lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5, kw.get("causal", False),
                                                 kw.get("q_position_offset", 0), None, None,
                                                 kw.get("window"))
        empty = torch.isinf(lse).any(dim=(0, 1))
        assert (got[0][:, empty] == 0).all(), case
        for what, a, w in zip(("dq", "dk", "dv"), got, want):
            assert a.shape == w.shape and a.dtype == w.dtype, (case, what)
            if dt == torch.float32:
                torch.testing.assert_close(a, w, atol=5e-4, rtol=0, msg=f"{case} {what}")
            else:
                rel = ((a.float() - w.float()).norm() / w.float().norm()).item()
                assert rel <= 1e-2, (case, what, rel)
