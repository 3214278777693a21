"""The fused add + RMSNorm ops of the PyTorch port (K9 `fused_add_rms_norm`,
K10 `fused_ls_add_rms_norm`) vs the JAX package, on the CPU.

The port's CPU route is each kernel's plain version; it is held against the
JAX Pallas kernels run in interpret mode, at the JAX tests' shapes and bars
(tests/test_misc_ops.py:13-20, :137-173): K9 fp32 y 1e-5 and the sum 1e-6,
bf16 x with an fp32 residual stream (the case K9 is for) the sum identical
and y within one bf16 ulp; K10 fp32 y and the new residual 1e-6, bf16 y
5e-2, and its gradients (autograd through the unfused composition) against
`jax.grad` of `_ls_add_norm_ref` at relative 1e-5 (fp32) / 2e-1 (bf16).
Each JAX function is jitted once per module. The CUDA kernels are held
against the plain versions on the card by
test_torch_fused_norm_kernels_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internvideo_tpu.ops import rmsnorm as jrms
from internvideo_tpu_torch import ops
from internvideo_tpu_torch.ops import _build
from internvideo_tpu_torch.ops import rmsnorm as rms


@pytest.fixture(scope="module")
def jax_fns():
    def k9(x, r, w):
        return jrms.fused_add_rms_norm(x, r, w, interpret=True, block_rows=32)

    def k10(h, r, g, w):
        return jrms._fused_ls_add_rms_norm(h, r, g, w, 1e-6, True)

    def loss(h, r, g, w):
        return jnp.sum(jnp.asarray(jrms._ls_add_norm_ref(h, r, g, w, 1e-6)[0], jnp.float32) ** 2)

    return {"k9": jax.jit(k9), "k10": jax.jit(k10),
            "k10_grad": jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))}


def _t(a, dtype=torch.float32):
    """numpy / JAX array -> torch tensor of `dtype` (bf16 through fp32, exact)."""
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _bf16_bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32) >> 16


def test_fused_add_rms_norm_plain_matches_jax_fp32(jax_fns):
    rng = np.random.default_rng(0)
    x, res = (rng.standard_normal((4, 16, 64)).astype(np.float32) for _ in range(2))
    w = (rng.standard_normal(64) * 0.1 + 1.0).astype(np.float32)
    y_ref, newres_ref = jax_fns["k9"](x, res, w)
    y, newres = ops.fused_add_rms_norm(_t(x), _t(res), _t(w))
    assert y.dtype == torch.float32 and newres.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5)
    np.testing.assert_allclose(newres.numpy(), np.asarray(newres_ref), atol=1e-6)
    # the plain route differentiates (the JAX op has no VJP; the CUDA kernel raises)
    xt = _t(x).requires_grad_()
    ops.fused_add_rms_norm(xt, _t(res), _t(w))[0].sum().backward()
    assert xt.grad is not None and torch.isfinite(xt.grad).all()


def test_fused_add_rms_norm_bf16_x_fp32_residual(jax_fns):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((4, 16, 64)), jnp.bfloat16)
    res = rng.standard_normal((4, 16, 64)).astype(np.float32)
    w = (rng.standard_normal(64) * 0.1 + 1.0).astype(np.float32)
    y_ref, newres_ref = jax_fns["k9"](x, res, w)
    y, newres = rms.fused_add_rms_norm(_t(x, torch.bfloat16), _t(res), _t(w))
    assert y.dtype == torch.bfloat16 and newres.dtype == torch.float32
    np.testing.assert_array_equal(newres.numpy(), np.asarray(newres_ref))
    ulps = np.abs(_bf16_bits(y.float().numpy()) - _bf16_bits(y_ref))
    assert ulps.max() <= 1, ulps.max()


@pytest.mark.parametrize("dtype, ytol, gtol", [("float32", 1e-6, 1e-5),
                                               ("bfloat16", 5e-2, 2e-1)])
def test_fused_ls_add_rms_norm_plain_matches_jax(jax_fns, dtype, ytol, gtol):
    rng = np.random.default_rng(11)
    shape = (2, 123, 64)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    h = jnp.asarray(rng.standard_normal(shape), jdt)
    x = jnp.asarray(rng.standard_normal(shape), jdt)
    g = (rng.standard_normal(shape[-1]) * 0.01).astype(np.float32)
    w = (rng.standard_normal(shape[-1]) * 0.1 + 1).astype(np.float32)
    y_ref, r_ref = jax_fns["k10"](h, x, g, w)
    grads_ref = jax_fns["k10_grad"](h, x, g, w)

    leaves = [_t(h, tdt), _t(x, tdt), _t(g), _t(w)]
    leaves = [t.requires_grad_() for t in leaves]
    y, newres = rms.fused_ls_add_rms_norm(*leaves, 1e-6)
    assert y.dtype == tdt and newres.dtype == tdt
    np.testing.assert_allclose(y.float().detach().numpy(), np.asarray(y_ref, np.float32),
                               atol=ytol, rtol=ytol)
    np.testing.assert_allclose(newres.float().detach().numpy(), np.asarray(r_ref, np.float32),
                               atol=1e-6, rtol=1e-6)
    grads = torch.autograd.grad(y.float().square().sum(), leaves)
    assert type(y.grad_fn).__name__ == "FusedLSAddRMSNormBackward"
    for name, a, b in zip(("h", "x", "gamma", "w"), grads, grads_ref):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        rel = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-9)
        assert rel < gtol, f"{name} rel={rel} dt={dtype}"


def test_cpu_norm_ops_never_build_or_launch(monkeypatch):
    def no_build():
        raise AssertionError("the CUDA library was requested for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    rms.reset_launch_count()
    x = torch.randn(3, 100)  # D % 8 != 0: the kernel's scalar path on the card
    y, newres = rms.fused_add_rms_norm(x, x, torch.ones(100))
    torch.testing.assert_close(newres, 2 * x)
    torch.testing.assert_close(y, rms.rms_norm(x, torch.ones(100), residual=x))
    rms.fused_ls_add_rms_norm(x, x, torch.ones(100), torch.ones(100))
    assert {n: rms.launch_count(n) for n in rms.KERNELS} == dict.fromkeys(rms.KERNELS, 0)
