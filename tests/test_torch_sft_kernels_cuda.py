"""The SFT slice's CUDA kernels vs their plain PyTorch versions, on the card:
the causal / narrow-v flash backward (K5 backward, csrc/flash_bwd_causal_dq.cu
and flash_bwd_causal_dkv.cu), packed segment ids in K5's forward and
backward (K8), and the small-S kernels (K2 / K4b) at the vision tower's head
dim 72.

Needs an NVIDIA GPU with nvcc (the kernels have no CPU mode), so every test
here is marked `cuda` and skips without a card. The file imports neither
jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_sft_kernels_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from internvideo_tpu_torch.ops import flash_attention as fa
from internvideo_tpu_torch.ops.attention_xla import attention_xla

# (B, Sq, Sk, H, d_qk, d_v, causal, q_position_offset, segments): the JAX
# kernel tests' shapes (tests/test_flash_attention.py: test_grads_segment_ids
# :80, test_causal_q_position_offset :152, test_packed_segment_block_skipping
# _parity :511, test_narrow_v_head_dim :569 without its GQA), pads with id -1
# that meet each other, and the 8B's training pair at a ragged S.
CASES = [
    (1, 256, 256, 2, 64, 64, False, 0, "halves"),
    (1, 72, 200, 2, 64, 64, True, 128, None),
    (2, 512, 512, 2, 32, 32, False, 0, "packed"),
    (2, 512, 512, 2, 32, 32, True, 0, "packed"),
    (2, 200, 200, 4, 64, 32, True, 0, None),
    (2, 200, 200, 4, 64, 32, False, 0, None),
    (1, 300, 300, 2, 64, 64, True, 0, "pads"),
    (1, 333, 333, 2, 256, 128, True, 0, "packed"),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SFT kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def segments(kind, b, s):
    """(B, S) int32 segment ids on the card: two halves; four packed runs
    (130 / 100 / 200 / 82 at S = 512, scaled otherwise); or three runs
    (3 / 8, 1 / 4 and 1 / 8 of S) then pads of -1."""
    if kind == "halves":
        ids = np.repeat([0, 1], [s // 2, s - s // 2])
    elif kind == "packed":
        lens = np.array([130, 100, 200, 82]) * s // 512
        lens[-1] = s - lens[:-1].sum()
        ids = np.repeat(np.arange(4), lens)
    else:
        lens = [s * 3 // 8, s // 4, s // 8]
        ids = np.repeat([0, 1, 2, -1], lens + [s - sum(lens)])
    return torch.from_numpy(np.tile(ids[None], (b, 1)).astype(np.int32)).cuda()


def stream_segments(s, seed=0):
    """(1, S) ids laid out as the SFT stream packs a row: one ~920-token
    video sample, text samples of 256-2048 tokens, pads of -1."""
    rng = np.random.default_rng(seed)
    lens = [920]
    while sum(lens) < s - 256:
        lens.append(int(min(rng.integers(256, 2049), s - sum(lens))))
    ids = np.concatenate([np.full(n, i) for i, n in enumerate(lens)]
                         + [np.full(s - sum(lens), -1)])
    return torch.from_numpy(ids[None].astype(np.int32)).cuda()


def _grads(q, k, v, do, fn):
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = fn(*leaves)
    return (out.detach(), *torch.autograd.grad(out, leaves, do))


def _plain(causal, off, seg, scale):
    def fn(q, k, v):
        return attention_xla(q, k, v, causal=causal, q_position_offset=off,
                            q_segment_ids=seg, kv_segment_ids=seg, softmax_scale=scale)
    return fn


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_backward_and_segments_match_plain(dtype):
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(0)
    for b, sq, sk, h, d, dv, causal, off, kind in CASES:
        q = torch.randn(b, sq, h, d, device="cuda", generator=g).to(dt)
        k = torch.randn(b, sk, h, d, device="cuda", generator=g).to(dt)
        v = torch.randn(b, sk, h, dv, device="cuda", generator=g).to(dt)
        do = torch.randn(b, sq, h, dv, device="cuda", generator=g).to(dt)
        seg = segments(kind, b, sq) if kind else None
        suffix = "_seg" if kind else ""
        before = {n: fa.launch_count(n) for n in fa.KERNELS}
        got = _grads(q, k, v, do, lambda q, k, v: fa.flash_attention(
            q, k, v, causal=causal, q_position_offset=off, q_segment_ids=seg,
            kv_segment_ids=seg))
        torch.cuda.synchronize()
        for n in ("flash_fwd_causal", "flash_bwd_causal_dq", "flash_bwd_causal_dkv"):
            assert fa.launch_count(n + suffix) == before[n + suffix] + 1, n + suffix
        want = _grads(q, k, v, do, _plain(causal, off, seg, d ** -0.5))
        case = (b, sq, sk, h, d, dv, causal, off, kind, dtype)
        for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
            if dt == torch.float32:
                torch.testing.assert_close(a, w, atol=2e-5 if name == "out" else 5e-4, rtol=0,
                                           msg=f"{case} {name}")
            else:
                assert _rel(a, w) <= 1e-2, (case, name, _rel(a, w))


@pytest.mark.cuda
def test_lse_cotangent_and_rows_without_keys():
    """The LSE output is differentiable (its cotangent folds into delta),
    and a row that sees no key (a segment id no key has) gets out 0, LSE
    -inf and a zero dq."""
    _card()
    g = torch.Generator("cuda").manual_seed(1)
    b, s, h, d, dv = 1, 200, 2, 64, 32
    q, k = (torch.randn(b, s, h, d, device="cuda", generator=g) for _ in range(2))
    v = torch.randn(b, s, h, dv, device="cuda", generator=g)
    q_seg = segments("pads", b, s)
    kv_seg = q_seg.clone()
    kv_seg[:, :90] = 7  # query rows of segment 0 see no key
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = fa.flash_attention_with_lse(*leaves, causal=True, q_segment_ids=q_seg,
                                           kv_segment_ids=kv_seg)
    assert (out[:, :90] == 0).all() and torch.isinf(lse[:, :, :90]).all()
    w = torch.randn(lse.shape, device="cuda", generator=g)
    w[:, :, :90] = 0.0
    loss = out.square().sum() + (torch.where(torch.isinf(lse), 0.0, lse) * w).sum()
    got = torch.autograd.grad(loss, leaves)
    assert (got[0][:, :90] == 0).all()
    ref_out, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5, True, 0, q_seg, kv_seg)
    want = fa.flash_attention_bwd_ref(q, k, v, ref_out, ref_lse, 2 * ref_out, d ** -0.5,
                                      lse_ct=w, causal=True, q_segment_ids=q_seg,
                                      kv_segment_ids=kv_seg)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, atol=5e-4, rtol=0)


@pytest.mark.cuda
def test_path_shapes_bf16():
    """bf16 at the SFT path's shapes: K5 + K8 at (1, 8192, 32, 256 / 128)
    with the stream's segments (q / k / v as strided views, as MLAttention
    makes them), and K2 / K4b at the tower's (8, 196, 16, 72) on views of
    one (B, S, 3W) tensor; rel-L2 <= 1e-2 on out and every gradient."""
    _card()
    g = torch.Generator("cuda").manual_seed(2)
    b, s, h, d, dv = 1, 8192, 32, 256, 128
    seg = stream_segments(s)
    q = torch.randn(b, s, h, d, device="cuda", generator=g).bfloat16()
    kv = torch.randn(b, s, h, d + dv, device="cuda", generator=g).bfloat16()
    k, v = kv[..., :d], kv[..., d:]
    do = torch.randn(b, s, h, dv, device="cuda", generator=g).bfloat16()
    got = _grads(q, k, v, do, lambda q, k, v: fa.flash_attention(
        q, k, v, causal=True, q_segment_ids=seg, kv_segment_ids=seg))
    out_ref, lse_ref = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5, True, 0, seg, seg)
    _, lse = fa.flash_attention_with_lse(q, k, v, causal=True, q_segment_ids=seg,
                                         kv_segment_ids=seg)
    want = (out_ref, *fa.flash_attention_bwd_ref(q, k, v, out_ref, lse_ref, do, d ** -0.5,
                                                 causal=True, q_segment_ids=seg,
                                                 kv_segment_ids=seg))
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert _rel(a, w) <= 1e-2, (name, _rel(a, w))
    torch.testing.assert_close(lse, lse_ref, atol=1e-2, rtol=0)

    b, s, h, d = 8, 196, 16, 72
    qkv = torch.randn(b, s, 3 * h * d, device="cuda", generator=g).bfloat16()
    q, k, v = (x.unflatten(-1, (h, d)) for x in qkv.split(h * d, dim=-1))
    do = torch.randn(b, s, h, d, device="cuda", generator=g).bfloat16()
    before = fa.launch_count("small_s_fwd")
    got = _grads(q, k, v, do, lambda q, k, v: fa.flash_attention(q, k, v))
    assert fa.launch_count("small_s_fwd") == before + 1
    out_ref, lse_ref = fa.small_s_attention_ref(q, k, v, d ** -0.5)
    want = (out_ref, *fa.small_s_attention_bwd_ref(q, k, v, out_ref, lse_ref, do, d ** -0.5))
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert _rel(a, w) <= 1e-2, (name, _rel(a, w))


@pytest.mark.cuda
def test_small_s_at_72_fp32():
    """K2 / K4b at head dim 72 exactly, fp32, ragged S: max-abs 2e-5 forward,
    5e-4 grads."""
    _card()
    g = torch.Generator("cuda").manual_seed(3)
    for b, sq, sk, h in ((2, 196, 196, 2), (1, 50, 77, 3)):
        q = torch.randn(b, sq, h, 72, device="cuda", generator=g)
        k, v = (torch.randn(b, sk, h, 72, device="cuda", generator=g) for _ in range(2))
        do = torch.randn(b, sq, h, 72, device="cuda", generator=g)
        got = _grads(q, k, v, do, lambda q, k, v: fa.flash_attention(q, k, v))
        want = _grads(q, k, v, do, _plain(False, 0, None, 72 ** -0.5))
        for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
            torch.testing.assert_close(a, w, atol=2e-5 if name == "out" else 5e-4, rtol=0,
                                       msg=f"{(b, sq, sk, h)} {name}")


@pytest.mark.cuda
def test_refusals():
    """What the kernels do not take raises: the backward at a pair it does
    not instantiate, also for a windowed or GQA call with segments (their
    forward is K5's window / GQA path, their backward K5's at the pairs of
    CAUSAL_BWD_HEAD_DIMS)."""
    _card()
    seg = segments("halves", 1, 64)
    q = torch.randn(1, 64, 2, 192, device="cuda", requires_grad=True)
    k = torch.randn(1, 64, 2, 192, device="cuda")
    v = torch.randn(1, 64, 2, 128, device="cuda")
    out = fa.flash_attention(q, k, v, causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    with pytest.raises(NotImplementedError, match="K5"):
        out.sum().backward()
    for kk, vv, kw in ((k, v, dict(causal=True, window=8)), (k[:, :, :1], v[:, :, :1], {})):
        out = fa.flash_attention(q, kk, vv, q_segment_ids=seg, kv_segment_ids=seg, **kw)
        ref, _ = fa.flash_attention_ref_with_lse(q.detach(), kk, vv, 192 ** -0.5,
                                                 kw.get("causal", False), 0, seg, seg,
                                                 kw.get("window"))
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
        with pytest.raises(NotImplementedError, match="K5"):
            out.sum().backward()


def edge_segments(s):
    """(1, S) ids whose boundaries fall inside the forward's 64-key tiles
    (runs of 50, 80, 190, 100) and whose tail of pads (-1) fills whole key
    tiles and a whole 128-row query tile."""
    lens = [50, 80, 190, 100]
    ids = np.repeat([0, 1, 2, 3, -1], lens + [s - sum(lens)])
    return torch.from_numpy(ids[None].astype(np.int32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_tile_edges(dtype):
    """K8 in K5's forward with segment boundaries mid-tile and a key tile of
    pad ids only, causal and not, at the training pairs and the 2B's (192,
    128)."""
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(4)
    for d, dv in ((256, 128), (192, 128), (128, 128), (64, 32)):
        for causal in (True, False):
            s = 700
            seg = edge_segments(s)
            q = torch.randn(1, s, 2, d, device="cuda", generator=g).to(dt)
            kv = torch.randn(1, s, 2, d + dv, device="cuda", generator=g).to(dt)
            k, v = kv[..., :d], kv[..., d:]
            before = fa.launch_count("flash_fwd_causal_seg")
            out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal, q_segment_ids=seg,
                                                   kv_segment_ids=seg)
            torch.cuda.synchronize()
            assert fa.launch_count("flash_fwd_causal_seg") == before + 1
            ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5, causal, 0, seg,
                                                           seg)
            case = (d, dv, causal, dtype)
            if dt == torch.float32:
                torch.testing.assert_close(out, ref, atol=2e-5, rtol=0, msg=str(case))
                torch.testing.assert_close(lse, ref_lse, atol=2e-5, rtol=0, msg=str(case))
            else:
                assert _rel(out, ref) <= 1e-2, (case, _rel(out, ref))
                torch.testing.assert_close(lse, ref_lse, atol=1e-2, rtol=0, msg=str(case))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_tile_edges_backward(dtype):
    """K8 in K5's backward at every instantiated pair, causal and not, with
    segment boundaries inside the dq / dk/dv tiles and whole tiles of pads
    (edge_segments), k / v as strided views at a 16-byte base offset: fp32
    max-abs 5e-4, bf16 rel-L2 <= 1e-2 on dq / dk / dv."""
    _card()
    dt = getattr(torch, dtype)
    g = torch.Generator("cuda").manual_seed(5)
    s = 700
    seg = edge_segments(s)
    for d, dv in ((256, 128), (128, 128), (64, 64), (64, 32), (32, 32)):
        for causal in (True, False):
            q = torch.randn(1, s, 2, d, device="cuda", generator=g).to(dt)
            kv = torch.randn(1, s, 2, 8 + d + dv, device="cuda", generator=g).to(dt)
            k, v = kv[..., 8:8 + d], kv[..., 8 + d:]  # base 16 bytes in (bf16)
            do = torch.randn(1, s, 2, dv, device="cuda", generator=g).to(dt)
            names = ("flash_bwd_causal_dq_seg", "flash_bwd_causal_dkv_seg")
            before = [fa.launch_count(n) for n in names]
            got = _grads(q, k, v, do, lambda q, k, v: fa.flash_attention(
                q, k, v, causal=causal, q_segment_ids=seg, kv_segment_ids=seg))
            torch.cuda.synchronize()
            assert [fa.launch_count(n) for n in names] == [c + 1 for c in before]
            ref, ref_lse = fa.flash_attention_ref_with_lse(q, k, v, d ** -0.5, causal, 0, seg,
                                                           seg)
            want = fa.flash_attention_bwd_ref(q, k, v, ref, ref_lse, do, d ** -0.5,
                                              causal=causal, q_segment_ids=seg,
                                              kv_segment_ids=seg)
            case = (d, dv, causal, dtype)
            for name, a, w in zip(("dq", "dk", "dv"), got[1:], want):
                if dt == torch.float32:
                    torch.testing.assert_close(a, w, atol=5e-4, rtol=0, msg=f"{case} {name}")
                else:
                    assert _rel(a, w) <= 1e-2, (case, name, _rel(a, w))
