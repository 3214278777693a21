"""The CUDA paged absorbed-MLA decode (K6, csrc/paged_decode.cu) vs its plain
PyTorch version, on the card.

Needs an NVIDIA GPU with nvcc (the kernel has no CPU mode), so every test
here is marked `cuda` and skips without a card. The file imports neither
jax nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_paged_decode_kernel_cuda.py -m cuda
"""

import pytest
import torch

from internvideo_tpu_torch.ops import paged_decode as pd


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the paged decode kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(b, h, r, p_dim, page_size, max_pages, seq_lens, dtype, seed):
    """Pool of b * max_pages pages plus a trash page of NaN (the last);
    shuffled tables whose unused columns point at the trash page, and the
    slots past each seq_len inside its last page NaN too."""
    g = torch.Generator("cuda").manual_seed(seed)
    n_pages = b * max_pages
    pages = torch.randn(n_pages + 1, page_size, r + p_dim, device="cuda", generator=g)
    pages[n_pages] = float("nan")
    tables = torch.full((b, max_pages), n_pages, dtype=torch.int32)
    for s, n_tok in enumerate(seq_lens):
        n = -(-n_tok // page_size)
        own = torch.randperm(max_pages, generator=torch.Generator().manual_seed(seed + s))[:n]
        tables[s, :n] = s * max_pages + own.int()
        if n:
            pages[tables[s, n - 1], n_tok - (n - 1) * page_size:] = float("nan")
    q_lat = torch.randn(b, h, r, device="cuda", generator=g).to(dtype)
    q_pe = torch.randn(b, h, p_dim, device="cuda", generator=g).to(dtype)
    lens = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    return q_lat, q_pe, pages.to(dtype), tables.cuda(), lens


def _clean(pages):
    return torch.nan_to_num(pages, nan=0.0)


@pytest.mark.cuda
def test_kernel_matches_plain_fp32_ragged_with_nan_trash():
    """tests/test_quant_rl_paged.py:162's lengths and a fuzz: the kernel on
    the NaN-dirty pool vs the plain version on the cleaned one, 1e-4."""
    _card()
    cases = [(3, 4, 32, 16, 4, 5, [3, 9, 17]), (4, 4, 16, 8, 4, 11, [1, 44, 23, 5]),
             (2, 20, 512, 64, 64, 5, [1, 300]), (2, 32, 896, 128, 64, 4, [0, 130])]
    for i, (b, h, r, p_dim, ps, mp, lens) in enumerate(cases):
        q_lat, q_pe, pages, tables, sl = _inputs(b, h, r, p_dim, ps, mp, lens, torch.float32, i)
        before = pd.launch_count()
        out = pd.paged_mla_decode(q_lat, q_pe, pages, tables, sl, softmax_scale=0.17)
        torch.cuda.synchronize()
        assert pd.launch_count() == before + 1
        ref = pd.paged_mla_decode_ref(q_lat, q_pe, _clean(pages), tables, sl,
                                      softmax_scale=0.17)
        assert torch.isfinite(out).all(), lens
        # a sequence with no token gets 0 (the plain gather formulation
        # softmaxes over its all-masked row instead)
        live = sl > 0
        assert (out[~live] == 0).all()
        torch.testing.assert_close(out[live], ref[live], atol=1e-4, rtol=0, msg=str(lens))


@pytest.mark.cuda
def test_kernel_matches_plain_bf16_path_shape():
    """The 8B decode shape: B 8, H 32, R 896, P 128, page 64, seq 2048-2112."""
    _card()
    lens = [2048, 2060, 2075, 2080, 2090, 2100, 2111, 2112]
    q_lat, q_pe, pages, tables, sl = _inputs(8, 32, 896, 128, 64, 34, lens, torch.bfloat16, 9)
    out = pd.paged_mla_decode(q_lat, q_pe, pages, tables, sl, softmax_scale=256 ** -0.5)
    ref = pd.paged_mla_decode_ref(q_lat, q_pe, _clean(pages), tables, sl,
                                  softmax_scale=256 ** -0.5)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= 1e-2, rel


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take():
    _card()
    q_lat, q_pe, pages, tables, sl = _inputs(1, 2, 16, 8, 4, 2, [5], torch.float32, 0)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        pd.paged_mla_decode(q_lat.half(), q_pe.half(), pages.half(), tables, sl,
                            softmax_scale=1.0)
    with pytest.raises(NotImplementedError, match="R <= 1024"):
        pd.paged_mla_decode(torch.zeros(1, 2, 1040, device="cuda"), q_pe,
                            torch.zeros(2, 4, 1048, device="cuda"), tables, sl,
                            softmax_scale=1.0)
    with pytest.raises(NotImplementedError, match="multiple of 4"):
        pd.paged_mla_decode(q_lat[..., :14], q_pe, pages[..., 2:], tables, sl,
                            softmax_scale=1.0)
    misaligned = torch.zeros(pages.numel() + 1, device="cuda")[1:].view(pages.shape)
    with pytest.raises(ValueError, match="16-byte"):
        pd.paged_mla_decode(q_lat, q_pe, misaligned, tables, sl, softmax_scale=1.0)


def _bf16_split(b, max_tokens):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return pd.split_len_bf16(b, max_tokens, sms)


# (H, R, P) of the bf16 kernel's paths: qwen3_8b_mla, and qwen3_2b_mla /
# internvideo25_hico_2b
BF16_PATHS = [(32, 896, 128), (20, 512, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("h, r, p_dim", BF16_PATHS)
def test_bf16_kernel_edges_with_nan_trash(b, h, r, p_dim):
    """The bf16 tensor-core kernel at its paths' (H, R, P), page 64: lengths
    0, 1, page - 1, page, page + 1, either side of a split boundary and
    32,768 (B 1), on a pool whose unused block-table columns point at a page
    of NaN and whose slots past each length are NaN; rel-L2 <= 1e-2 against
    the plain version on the cleaned pool, a sequence without tokens 0, one
    launch a call, and two calls bit-identical."""
    _card()
    page = 64
    if b == 1:
        cases = [[0], [1], [page - 1], [page], [page + 1], [32768]]
    else:
        cases = [[0, 1, page - 1, page, page + 1, 300, 1000, 2112]]
    split = _bf16_split(b, 40 * page)  # the pools below hold 40 pages a sequence
    around = [split - 1, split, split + 1, 2 * split - 1, 2 * split + 1]
    cases += [[n] for n in around] if b == 1 else [around + [split - 1, split, split + 1]]
    for i, lens in enumerate(cases):
        mp = max(40, -(-max(lens) // page))
        q_lat, q_pe, pages, tables, sl = _inputs(b, h, r, p_dim, page, mp, lens, torch.bfloat16,
                                                 100 + i)
        scale = (r // 7 + p_dim) ** -0.5
        before = pd.launch_count()
        out = pd.paged_mla_decode(q_lat, q_pe, pages, tables, sl, softmax_scale=scale)
        again = pd.paged_mla_decode(q_lat, q_pe, pages, tables, sl, softmax_scale=scale)
        torch.cuda.synchronize()
        assert pd.launch_count() == before + 2
        ref = pd.paged_mla_decode_ref(q_lat, q_pe, _clean(pages), tables, sl,
                                      softmax_scale=scale)
        assert out.dtype == torch.bfloat16 and torch.isfinite(out).all(), lens
        live = sl > 0
        assert (out[~live] == 0).all(), lens
        if live.any():
            rel = ((out[live].float() - ref[live].float()).norm()
                   / ref[live].float().norm()).item()
            assert rel <= 1e-2, (lens, rel)
        assert torch.equal(out, again), lens


@pytest.mark.cuda
def test_bf16_kernel_refuses_uninstantiated_shapes():
    _card()
    q_lat, q_pe, pages, tables, sl = _inputs(1, 2, 64, 16, 4, 2, [5], torch.bfloat16, 0)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        pd.paged_mla_decode(q_lat, q_pe, pages, tables, sl, softmax_scale=1.0)
    q_lat, q_pe, pages, tables, sl = _inputs(1, 40, 256, 64, 64, 2, [5], torch.bfloat16, 0)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        pd.paged_mla_decode(q_lat, q_pe, pages, tables, sl, softmax_scale=1.0)
