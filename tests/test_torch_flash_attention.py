"""Attention ops of the PyTorch port vs the JAX package.

On the CPU the port's flash attention runs its plain version; it is held
against the JAX Pallas kernels in interpret mode, run as
tests/test_flash_attention.py runs them. The CUDA kernel itself is held
against the plain version on the card by test_torch_flash_kernel_cuda.py
and chip_smoke.py.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internvideo_tpu.ops.attention_xla import xla_attention
from internvideo_tpu.ops.flash_attention import flash_attention as jax_flash
from internvideo_tpu.ops.flash_attention import flash_attention_with_lse as jax_flash_lse
from internvideo_tpu_torch.ops import _build
from internvideo_tpu_torch.ops import flash_attention as fa
from internvideo_tpu_torch.ops.attention import dot_product_attention
from internvideo_tpu_torch.ops.attention_xla import attention_xla

# (B, Sq, Sk, H, D): the JAX kernel tests' shape, the ragged route at
# head dim 88, both one-sided tails, and a single query row; then the edges
# of the Hopper kernel's 128-row query tile (one row, one short of it, one
# past it) against those of its 64-key stages (one key past one stage, past
# two, past three) at both head dims.
SHAPES = [
    (2, 256, 256, 2, 64),
    (1, 257, 257, 2, 88),
    (1, 256, 263, 2, 64),
    (1, 263, 256, 2, 64),
    (1, 1, 257, 2, 88),
] + [(1, sq, sk, 1, d) for d in (88, 64) for sq in (1, 127, 129) for sk in (65, 129, 193)]


def _qkv(b, sq, sk, h, d, seed=0, hkv=None):
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_plain_matches_jax_kernel(shape):
    q, k, v = _qkv(*shape)
    ref = jax_flash(q, k, v, interpret=True, block_q=128, block_k=128)
    out = fa.flash_attention(*_t(q, k, v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_with_lse_plain_matches_jax_kernel(shape):
    q, k, v = _qkv(*shape, seed=1)
    ref_out, ref_lse = jax_flash_lse(q, k, v, interpret=True, block_q=128, block_k=128)
    out, lse = fa.flash_attention_with_lse(*_t(q, k, v))
    assert lse.shape == (shape[0], shape[3], shape[1]) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=2e-5, rtol=2e-5)
    # both in natural log
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=2e-5, rtol=2e-5)


def _segments(b, s, seed):
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(1, s, size=(b, 2)), axis=1)
    pos = np.arange(s)[None]
    return ((pos >= cuts[:, :1]).astype(np.int32) + (pos >= cuts[:, 1:]).astype(np.int32))


@pytest.mark.parametrize("case", ["plain", "causal", "segments", "gqa", "offset", "scale"])
def test_attention_xla_matches_jax(case):
    b, sq, sk, h, d = 2, 48, 48, 4, 32
    hkv = 2 if case == "gqa" else None
    if case == "offset":
        sq = 16
    q, k, v = _qkv(b, sq, sk, h, d, seed=2, hkv=hkv)
    kw = {}
    if case == "causal":
        kw["causal"] = True
    if case == "segments":
        seg = _segments(b, sq, seed=3)
        kw.update(q_segment_ids=seg, kv_segment_ids=seg)
    if case == "offset":
        kw.update(causal=True, q_position_offset=sk - sq)
    if case == "scale":
        kw["softmax_scale"] = 0.3
    ref = xla_attention(q, k, v, **{k_: (jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_)
                                     for k_, v_ in kw.items()})
    tkw = {k_: (torch.from_numpy(v_) if isinstance(v_, np.ndarray) else v_)
           for k_, v_ in kw.items()}
    out = attention_xla(*_t(q, k, v), **tkw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_attention_xla_bf16_cast_chain_matches_jax():
    q, k, v = _qkv(1, 40, 40, 2, 88, seed=4)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = np.asarray(xla_attention(qb, kb, vb), np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = attention_xla(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    # same roundings up to fp32 summation order: at most one bf16 ulp apart
    np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-2, rtol=1e-2)


def test_cpu_dispatch_never_builds_or_launches(monkeypatch):
    def no_build():
        raise AssertionError("the CUDA library was requested for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    fa.reset_launch_count()
    q, k, v = _t(*_qkv(1, 65, 65, 2, 88, seed=5))
    ref = attention_xla(q, k, v)
    for impl in ("auto", "kernel", "pallas", "plain", "xla"):
        out = dot_product_attention(q, k, v, impl=impl)
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    fa.flash_attention_with_lse(q, k, v)
    assert fa.launch_count() == 0


def test_dispatch_rejects_unknown_impl_and_unported_cases():
    q, k, v = _t(*_qkv(1, 16, 16, 2, 64, seed=6))
    with pytest.raises(ValueError, match="unknown attention impl"):
        dot_product_attention(q, k, v, impl="triton")
    seg = torch.tensor([[0] * 5 + [1] * 9 + [-1] * 2], dtype=torch.int32)
    # the window and GQA forward and backward are ported (K5): the kernel
    # route's gradients are autograd's through the plain attention
    qg, kg, vg = _t(*_qkv(1, 16, 16, 4, 64, seed=7, hkv=2))
    for args, kw in (((q, k, v), dict(window=8)), ((q, k, v), dict(causal=True, window=8)),
                     ((qg.requires_grad_(), kg, vg), {})):
        out = dot_product_attention(*args, impl="kernel", **kw)
        want = attention_xla(*args, **kw)
        torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
        if out.requires_grad:
            torch.testing.assert_close(torch.autograd.grad(out.sum(), args[0])[0],
                                       torch.autograd.grad(want.sum(), args[0])[0],
                                       atol=5e-4, rtol=5e-4)
    with pytest.raises(ValueError, match="both"):
        dot_product_attention(q, k, v, impl="kernel", q_segment_ids=seg)
    # causal, its query offset, segment ids (K5 / K8) and the bhsd layout
    # are ported: both routes agree on them
    for kw in (dict(causal=True), dict(causal=True, q_position_offset=2),
               dict(q_segment_ids=seg, kv_segment_ids=seg),
               dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)):
        torch.testing.assert_close(dot_product_attention(q, k, v, impl="kernel", **kw),
                                   dot_product_attention(q, k, v, impl="plain", **kw),
                                   atol=2e-5, rtol=2e-5)
    bhsd = [x.transpose(1, 2) for x in (q, k, v)]
    for impl in ("kernel", "plain"):
        out = dot_product_attention(*bhsd, impl=impl, causal=True, layout="bhsd")
        torch.testing.assert_close(out.transpose(1, 2), attention_xla(q, k, v, causal=True),
                                   atol=2e-5, rtol=2e-5)


def test_port_imports_without_jax_or_triton():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'triton', 'internvideo_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import internvideo_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) >= 15, mods\n"
        "print(len(mods))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.join(os.path.dirname(__file__), ".."), timeout=120)
    assert res.returncode == 0, res.stderr
