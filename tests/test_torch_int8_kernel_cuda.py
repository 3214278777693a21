"""The CUDA fused dynamic-int8 GEMM (K7, csrc/int8_gemm.cu) vs its plain
PyTorch version, on the card.

Needs an NVIDIA GPU with nvcc (the kernel has no CPU mode), so every test
here is marked `cuda` and skips without a card. The file imports neither
jax nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_int8_kernel_cuda.py -m cuda

The plain version quantizes with the same arithmetic and forms the exact
integer sums (float64), so f32 outputs agree bit for bit (bar: relative
1e-6); bf16 outputs may differ where the f32 value sits on a bf16 rounding
edge (bar: relative L2 1e-2, the count printed).
"""

import pytest
import torch

from internvideo_tpu_torch.ops import int8_gemm
from internvideo_tpu_torch.ops.quant import quantize_int8

# tests/test_int8_gemm.py:24-32 (M shape, K, N), K = 200 (a 64-wide k-tile
# and a partial one), the tower fc2's ragged K = 4304 and its N tail
SHAPES = [((256,), 256, 384), ((3, 170), 256, 384), ((130,), 384, 200), ((64,), 128, 128),
          ((2, 40), 200, 96), ((300,), 4304, 1152), ((129,), 1152, 4304)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the int8 GEMM kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(m_shape, k, n, dtype, seed):
    """x with row 0 all zero and row 1 of exact .5 ties (amax 127, so the
    scale is 1 and x / s = x); weights quantized per output channel."""
    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(*m_shape, k, device="cuda", generator=g)
    rows = x.view(-1, k)
    rows[0] = 0.0
    rows[1] = torch.arange(k, device="cuda") % 5 - 2.5
    rows[1, 0] = 127.0
    w = torch.randn(n, k, device="cuda", generator=g) * 0.05
    w_q, w_s = quantize_int8(w, 1)
    return x.to(dtype), w_q, w_s.reshape(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(x_dtype, out_dtype):
    _card()
    for i, (m_shape, k, n) in enumerate(SHAPES):
        x, w_q, w_s = _inputs(m_shape, k, n, x_dtype, seed=i)
        before = int8_gemm.launch_count()
        with torch.no_grad():
            got = int8_gemm.int8_matmul_fused(x, w_q, w_s, out_dtype)
        torch.cuda.synchronize()
        assert int8_gemm.launch_count() == before + 1
        ref = int8_gemm.int8_matmul_reference(x, w_q, w_s, out_dtype)
        assert got.shape == (*m_shape, n) and got.dtype == out_dtype
        flat = got.reshape(-1, n)
        assert (flat[0] == 0).all()
        differ = int((got != ref).sum())
        if out_dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
        else:
            rel = ((got.float() - ref.float()).norm() / ref.float().norm()).item()
            assert rel <= 1e-2, (m_shape, k, n, rel)
        print(f"K7 {x_dtype} -> {out_dtype} {(*m_shape, k, n)}: {differ} of {got.numel()} "
              "elements differ from the plain version")


@pytest.mark.cuda
def test_kernel_is_inference_only_and_checks_its_limits():
    _card()
    x, w_q, w_s = _inputs((64,), 256, 128, torch.bfloat16, seed=9)
    with pytest.raises(RuntimeError, match="inference-only"):
        int8_gemm.int8_matmul_fused(x.float().requires_grad_(), w_q, w_s)
    with pytest.raises(NotImplementedError, match="multiple of 4"):
        int8_gemm.int8_matmul_fused(x[:, :254], w_q[:, :254], w_s)
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        int8_gemm.int8_matmul_fused(x.half(), w_q, w_s)
    # an unaligned view of x is copied, not refused
    wide = torch.zeros(64, 260, dtype=torch.bfloat16, device="cuda")
    wide[:, 2:258] = x
    with torch.no_grad():
        got = int8_gemm.int8_matmul_fused(wide[:, 2:258], w_q, w_s)
    torch.testing.assert_close(got, int8_gemm.int8_matmul_reference(x, w_q, w_s),
                               rtol=1e-6, atol=1e-6)


# The edges of the Hopper GEMM's tiles: 128 rows and 256 columns a CTA (a
# row, one short of and one past a 64-row warpgroup and a tile, and one past
# 128 tiles of rows), 128-byte k-tiles (K 4: a row pitch padded to 16; 132:
# one k-tile and 4 bytes; the 1B encoder's 1408: 11 k-tiles).
EDGE_M = (1, 63, 65, 129, 16385)
EDGE_N = (1, 255, 257)
EDGE_K = (4, 132, 1408)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernel_tile_edges_bit_identical_to_plain(x_dtype, out_dtype):
    """The integer sums are exact and the rescale is one fixed chain, so at
    every tile edge the kernel's output equals its plain version's bit for
    bit (codes, scales and the f32 / bf16 roundings are the same)."""
    _card()
    for i, (m, k, n) in enumerate((m, k, n) for m in EDGE_M for k in EDGE_K for n in EDGE_N):
        x, w_q, w_s = _inputs((max(m, 2),), k, n, x_dtype, seed=100 + i)
        x = x[-m:]  # M = 1: the row of ties alone
        with torch.no_grad():
            got = int8_gemm.int8_matmul_fused(x, w_q, w_s, out_dtype)
        ref = int8_gemm.int8_matmul_reference(x, w_q, w_s, out_dtype)
        torch.cuda.synchronize()
        assert got.shape == (m, n) and got.dtype == out_dtype
        assert torch.equal(got, ref), ((m, k, n), int((got != ref).sum()))
