"""The int8 ops of the PyTorch port vs the JAX package, on the CPU:
`ops/quant.py` (quantize_int8, int8_matmul, QuantDense, Int8Dense,
Int8WoDense, quantize_params_like) and K7's entry `ops/int8_gemm.py`
(int8_matmul_fused), which on a CPU tensor runs its plain version.

Inputs are made with numpy from a seed and handed to both packages; weights
go through models/convert.py:params_from_jax. Codes and scales must be
identical, f32 int8 products agree to a relative 1e-6 (the JAX kernel
tests' bar, tests/test_int8_gemm.py:39-40), QuantDense's grads to 5e-4.
The kernel itself is held on the card by test_torch_int8_kernel_cuda.py.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import linen as fnn

from internvideo_tpu.ops import int8_gemm as jgemm
from internvideo_tpu.ops import quant as jquant
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.ops import int8_gemm, quant

# tests/test_int8_gemm.py:24-32's shapes (m_shape, K, N, bm, bn), K = 200
# (not a multiple of 32) and f32 input with a bf16 output (:43-53); then the
# Hopper GEMM's edges: K = 4 (a weight pitch padded to 16 bytes) with M and N
# one past a 128 x 256 tile, and one k-tile and 4 bytes (K = 132) against N
# one past a tile.
SHAPES = [((256,), 256, 384, 128, 128), ((3, 170), 256, 384, 128, 128),
          ((130,), 384, 200, 128, 128), ((64,), 128, 128, 128, 128),
          ((2, 40), 200, 96, 128, 128), ((257,), 4, 257, 128, 128),
          ((2, 40), 132, 257, 128, 128)]


def _t(a):
    """numpy (bf16 via ml_dtypes) -> torch, bit for bit."""
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _inputs(m_shape, k, n, x_dtype, seed):
    """x (m_shape, K) with row 0 all zero and a few exact ties, weights
    quantized per output channel by JAX: (x, (K, N) int8, (1, N) f32)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*m_shape, k)).astype(np.float32)
    x.reshape(-1, k)[0] = 0.0
    x.reshape(-1, k)[1, :3] = [2.5, -0.5, 0.0]
    x = x.astype(x_dtype)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    w_q, w_s = jquant.quantize_int8(jnp.asarray(w), axis=0)
    return x, np.asarray(w_q), np.asarray(w_s)


@pytest.mark.parametrize("m_shape,k,n,bm,bn", SHAPES)
def test_int8_matmul_matches_jax_auto_and_kernel(m_shape, k, n, bm, bn):
    x, w_q, w_s = _inputs(m_shape, k, n, ml_dtypes.bfloat16, seed=k + n)
    jx = jnp.asarray(x)
    # the activation codes and scales: identical
    jq, js = jquant.quantize_int8(jx, axis=-1)
    tq, ts = quant.quantize_int8(_t(x), -1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (tq.reshape(-1, k)[0] == 0).all()
    auto = np.asarray(jquant.int8_matmul(jx, jnp.asarray(w_q), jnp.asarray(w_s), fused="xla"))
    kern = np.asarray(jgemm.int8_matmul_fused(jx, jnp.asarray(w_q), jnp.asarray(w_s),
                                              jnp.float32, bm, bn, True))
    got = quant.int8_matmul(_t(x), _t(w_q).t(), _t(w_s).reshape(-1), dynamic_activations=True,
                            out_dtype=torch.float32)
    assert got.shape == auto.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), auto, rtol=1e-6, atol=1e-6)
    assert (got.reshape(-1, n)[0] == 0).all()
    # JAX's kernel in interpret mode forms the scale as amax * f32(1 / 127),
    # not amax / 127 (quant.py:29, int8_gemm.py:86): on the rows where the two
    # differ in the last bit, ties of x / s fall the other way. Every other
    # row agrees with the port at the same bar.
    amax = np.maximum(np.abs(x.astype(np.float32)).max(-1), np.float32(1e-8))
    moved = (amax * (np.float32(1) / np.float32(127)) != amax / np.float32(127)).reshape(-1)
    rows = np.abs(got.numpy() - kern).reshape(-1, n).max(-1) > 1e-6 * (1 + np.abs(kern).max())
    assert not (rows & ~moved).any(), np.flatnonzero(rows & ~moved)
    np.testing.assert_allclose(got.numpy().reshape(-1, n)[~moved], kern.reshape(-1, n)[~moved],
                               rtol=1e-6, atol=1e-6)


def test_f32_input_bf16_output_matches_jax():
    """test_int8_gemm.py:43-53: f32 activations, bf16 out."""
    x, w_q, w_s = _inputs((192,), 256, 256, np.float32, seed=7)
    ref = jquant.int8_matmul(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(w_s), fused="xla",
                             out_dtype=jnp.bfloat16)
    got = int8_gemm.int8_matmul_fused(_t(x), _t(w_q).t(), _t(w_s).reshape(-1), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), np.asarray(ref, np.float32))


def test_quantize_int8_rounds_half_to_even():
    # amax 127 -> scale exactly 1: every x / s is x itself
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -126.5],
                  [0.0] * 9], np.float32)
    q, s = quant.quantize_int8(torch.from_numpy(x), -1)
    np.testing.assert_array_equal(q[0].numpy(), [127, 0, 2, 2, 0, -2, -2, 4, -126])
    np.testing.assert_array_equal(q[1].numpy(), 0)
    jq, js = jquant.quantize_int8(jnp.asarray(x), axis=-1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_cpu_entry_runs_plain_version_and_differentiates_as_auto():
    """On a CPU tensor K7's entry is its plain version and launches
    nothing; its gradient (through the activation scale, as JAX's `auto`
    composition) matches jax.grad; the weight-only branch matches JAX."""
    x, w_q, w_s = _inputs((2, 24), 64, 48, np.float32, seed=3)
    before = int8_gemm.launch_count()
    tx = torch.from_numpy(x).requires_grad_()
    ts = _t(w_s).reshape(-1).requires_grad_()
    out = int8_gemm.int8_matmul_fused(tx, _t(w_q).t(), ts)
    torch.testing.assert_close(out, int8_gemm.int8_matmul_reference(tx, _t(w_q).t(), ts),
                               atol=0, rtol=0)
    assert int8_gemm.launch_count() == before
    (out * out).sum().backward()

    def loss(x, s):
        y = jquant.int8_matmul(x, jnp.asarray(w_q), s, fused="xla")
        return jnp.sum(y * y)

    gx, gs = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w_s))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(gs).reshape(-1), rtol=5e-4,
                               atol=5e-4)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        wo = quant.int8_matmul(_t(x).to(dt), _t(w_q).t(), _t(w_s).reshape(-1),
                               dynamic_activations=False)
        ref = jquant.int8_matmul(jnp.asarray(x, jdt), jnp.asarray(w_q), jnp.asarray(w_s),
                                 dynamic_activations=False)
        np.testing.assert_allclose(wo.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_quantize_params_like_matches_jax(param_dtype):
    """The JAX and port quantized trees of one dense layer stack are equal,
    and params_from_jax carries JAX's int8 tree onto the port's names."""
    k, n = 48, 40
    rng = np.random.default_rng(11)
    kernel = jnp.asarray(rng.standard_normal((k, n)) * 0.1, param_dtype)
    bias = jnp.asarray(rng.standard_normal((n,)), param_dtype)
    dense = {"proj": {"kernel": kernel, "bias": bias}}
    jint8 = jquant.Int8Dense(n, dtype=jnp.float32, param_dtype=jnp.float32)
    abstract = fnn.unbox(jax.eval_shape(jint8.init, jax.random.key(0), jnp.zeros((1, k))))
    jq = jquant.quantize_params_like({"proj": abstract["params"]}, dense)

    tmod = torch.nn.ModuleDict({"proj": quant.Int8Dense(k, n)})
    tdense = {"proj.weight": _t(jax.device_get(kernel)).t(),
              "proj.bias": _t(jax.device_get(bias))}
    sd = quant.quantize_params_like(tmod, tdense)
    assert sd["proj.weight_q"].dtype == torch.int8 and sd["proj.weight_q"].shape == (n, k)
    assert sd["proj.scale"].dtype == torch.float32 and sd["proj.scale"].shape == (n,)
    assert sd["proj.bias"].dtype == torch.float32
    tmod.load_state_dict(sd, strict=True)
    from_jax = params_from_jax(jax.device_get(jq))
    assert set(from_jax) == set(sd)
    for key in sd:
        np.testing.assert_array_equal(from_jax[key].numpy(), sd[key].numpy(), err_msg=key)
    np.testing.assert_array_equal(sd["proj.weight_q"].numpy(), np.asarray(jq["proj"]["kernel_q"]).T)


@pytest.mark.parametrize("dynamic", [True, False])
def test_quant_dense_forward_and_grads_match_jax(dynamic):
    k, n = 32, 24
    jm = jquant.QuantDense(n, dynamic_activations=dynamic)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, k)).astype(np.float32)
    params = fnn.unbox(jm.init(jax.random.key(1), jnp.asarray(x)))
    tm = quant.QuantDense(k, n, dynamic_activations=dynamic)
    tm.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)

    def loss(p, x):
        y = jm.apply(p, x)
        return jnp.sum(y * y), y

    (_, y), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    ty = tm(tx)
    (ty * ty).sum().backward()
    np.testing.assert_allclose(_np(ty), np.asarray(y), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(tm.weight.grad.numpy(), np.asarray(gp["params"]["kernel"]).T,
                               rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(tm.bias.grad.numpy(), np.asarray(gp["params"]["bias"]),
                               rtol=5e-4, atol=5e-4)
    q, s = tm.inference_weights()
    jqk, jsk = jm.apply(params, params["params"]["kernel"], method="inference_weights")
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqk).T)
    np.testing.assert_array_equal(_np(s).reshape(-1), np.asarray(jsk).reshape(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dense_and_wo_dense_match_jax(dtype):
    """Int8Dense and Int8WoDense (below and above dyn_m_threshold) on JAX's
    quantized params: JAX's cast chain (bf16 store, fp32 bias add, cast)."""
    k, n, thr = 64, 48, 32
    rng = np.random.default_rng(9)
    kernel = rng.standard_normal((k, n)).astype(np.float32) * 0.1
    bias = rng.standard_normal((n,)).astype(np.float32)
    kq, sc = jquant.quantize_int8(jnp.asarray(kernel), axis=0)
    jp = {"params": {"kernel_q": kq, "scale": sc, "bias": jnp.asarray(bias)}}
    sd = params_from_jax(jax.device_get(jp))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 1e-2
    for rows in (8, 48):  # M = 2 x rows: below / above the threshold
        x = rng.standard_normal((2, rows, k)).astype(np.float32)
        jx = jnp.asarray(x, jdt)
        tx = _t(np.asarray(jx))
        layers = [(jquant.Int8Dense(n, dtype=jdt), quant.Int8Dense(k, n, dtype=tdt))]
        for t in (None, thr):
            layers.append((jquant.Int8WoDense(n, use_bias=True, dtype=jdt, dyn_m_threshold=t),
                           quant.Int8WoDense(k, n, bias=True, dtype=tdt, dyn_m_threshold=t)))
        outs = []
        for jl, tl in layers:
            tl.load_state_dict(sd, strict=True)
            with torch.no_grad():
                got = tl(tx)
            ref = np.asarray(jl.apply(jp, jx), np.float32)
            assert got.dtype == tdt
            rel = np.linalg.norm(_np(got) - ref) / np.linalg.norm(ref)
            assert rel <= tol, (type(tl).__name__, rows, rel)
            outs.append(got)
        # with the threshold: the dynamic-int8 product at M >= thr, else the
        # weight-only code bit for bit
        dyn = 2 * rows >= thr
        torch.testing.assert_close(outs[2], outs[0 if dyn else 1], atol=0, rtol=0)
