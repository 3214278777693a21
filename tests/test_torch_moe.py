"""nn/moe.py of the PyTorch port vs the JAX package: the two routers, the
expert activations, MoEMlp's two dispatches (with shared experts and
expert biases) and update_router_bias.

Parameters are the JAX module's init, loaded through
models/convert.py:params_from_jax; inputs are seeded numpy. In fp32 the
outputs, aux loss, expert load and dropped fraction agree within 2e-5 and
the gradients of x and of every parameter within 5e-4 (the JAX kernel
tests' tolerances); routing indices are equal. The gradients are autograd
through plain torch: the module holds no kernel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from internvideo_tpu.nn import moe as jmoe
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.nn import moe

D = 16
# name -> (MoEConfig fields, router bias?); one case each: dropless softmax;
# capacity with drops, expert biases and the clipped SwiGLU; the grouped
# sigmoid router with a bias and a shared expert; capacity with unnormalised
# gates and two shared experts
CASES = {
    "dropless": (dict(num_experts=8, top_k=2, intermediate_size=24, dispatch="dropless"), False),
    "capacity_drops_bias": (dict(num_experts=4, top_k=2, intermediate_size=24,
                                 capacity_factor=0.5, expert_bias=True,
                                 act_fn="clipped_swiglu", clip_limit=0.05), False),
    "sigmoid_groups_shared": (dict(num_experts=8, top_k=2, intermediate_size=24,
                                   scoring_func="sigmoid", n_group=4, topk_group=2,
                                   router_scaling_factor=2.5, num_shared_experts=1,
                                   router_bias_balancing=True, dispatch="dropless"), True),
    "capacity_unnormed_shared": (dict(num_experts=4, top_k=2, intermediate_size=24,
                                      norm_topk_prob=False, num_shared_experts=2), False),
}
_PAIRS = {}


def _pair(name):
    """(JAX module, JAX params, port module, router bias or None), cached.
    The params are seeded numpy of the shapes JAX's init gives (std 0.3, so
    that the clipped SwiGLU's clamps and the routing are exercised)."""
    if name not in _PAIRS:
        fields, with_bias = CASES[name]
        jm = jmoe.MoEMlp(jmoe.MoEConfig(**fields))
        shapes = fnn.unbox(jax.eval_shape(jm.init, jax.random.key(0),
                                          jnp.zeros((2, 6, D), jnp.float32)))
        rng = np.random.default_rng(len(name))
        params = jax.tree.map(
            lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32) * 0.3),
            shapes)
        tm = moe.MoEMlp(moe.MoEConfig(**fields), D)
        tm.load_state_dict(params_from_jax(jax.device_get(params)), strict=True)
        bias = (np.random.default_rng(1).standard_normal(fields["num_experts"]) * 0.1
                ).astype(np.float32) if with_bias else None
        _PAIRS[name] = (jm, params, tm, bias)
    return _PAIRS[name]


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=tol)


_RNG = np.random.default_rng(0)
X = _RNG.standard_normal((2, 6, D)).astype(np.float32)
COT = _RNG.standard_normal((2, 6, D)).astype(np.float32)


def _jax_refs():
    """Every case's JAX outputs and gradients of sum(output * COT) + aux_loss,
    from one jitted computation (one compile for the four cases)."""
    if "refs" not in _PAIRS:
        pairs = {name: _pair(name) for name in CASES}

        def all_cases(params, x):
            res = {}
            for name, (jm, _, _, bias) in pairs.items():
                jbias = None if bias is None else jnp.asarray(bias)

                def jloss(p, xx, jm=jm, jbias=jbias):
                    out = jm.apply(p, xx, jbias)
                    return jnp.sum(out.output * COT) + out.aux_loss, out

                res[name] = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
                    params[name], x)
            return res

        _PAIRS["refs"] = jax.jit(all_cases)({n: p[1] for n, p in pairs.items()},
                                            jnp.asarray(X))
    return _PAIRS["refs"]


@pytest.mark.parametrize("name", list(CASES))
def test_moe_mlp_outputs_and_grads_match_jax(name):
    jm, params, tm, bias = _pair(name)
    x, cot = X, COT
    jbias = None if bias is None else jnp.asarray(bias)
    (_, jout), (jgp, jgx) = _jax_refs()[name]
    tx = torch.from_numpy(x).requires_grad_()
    tout = tm(tx, None if bias is None else torch.from_numpy(bias))
    ((tout.output * torch.from_numpy(cot)).sum() + tout.aux_loss).backward()
    _close(tout.output.detach(), jout.output, 2e-5)
    for field in ("aux_loss", "expert_load", "dropped_fraction"):
        _close(getattr(tout, field).detach(), getattr(jout, field), 2e-5)
    if "drops" in name:
        assert float(tout.dropped_fraction) > 0
    _close(tx.grad, jgx, 5e-4)
    want = params_from_jax(jax.device_get(jgp))
    for pname, p in tm.named_parameters():
        _close(p.grad, want[pname].numpy(), 5e-4)
    # routing indices equal (the router's logits are its own first output)
    logits = tm.router(torch.from_numpy(x).reshape(-1, D))
    tidx = moe.route_tokens(logits, tm.cfg, None if bias is None
                            else torch.from_numpy(bias))[0]
    jidx = jmoe.route_tokens(jnp.asarray(logits.detach().numpy()), jm.cfg, jbias)[0]
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("fields,with_bias", [
    (dict(num_experts=8, top_k=2), False),
    (dict(num_experts=8, top_k=2, norm_topk_prob=False, router_scaling_factor=1.5), True),
    (dict(num_experts=8, top_k=3, scoring_func="sigmoid", router_scaling_factor=2.5), True),
    (dict(num_experts=8, top_k=2, scoring_func="sigmoid", n_group=4, topk_group=2), True),
    (dict(num_experts=8, top_k=1, scoring_func="sigmoid", norm_topk_prob=True), False),
])
def test_route_tokens_matches_jax(fields, with_bias):
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((32, fields["num_experts"])).astype(np.float32)
    bias = rng.standard_normal(fields["num_experts"]).astype(np.float32) * 0.3
    jcfg, tcfg = jmoe.MoEConfig(**fields), moe.MoEConfig(**fields)
    jout = jmoe.route_tokens(jnp.asarray(logits), jcfg,
                             jnp.asarray(bias) if with_bias else None)
    tout = moe.route_tokens(torch.from_numpy(logits), tcfg,
                            torch.from_numpy(bias) if with_bias else None)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    _close(tout[1], jout[1], 1e-6)
    _close(tout[2], jout[2], 1e-6)


@pytest.mark.parametrize("act", ["swiglu", "clipped_swiglu"])
def test_moe_act_matches_jax(act):
    rng = np.random.default_rng(6)
    gate, up = (rng.standard_normal((5, 12)).astype(np.float32) * 6 for _ in range(2))
    cfg = dict(act_fn=act)
    want = jmoe.moe_act(jmoe.MoEConfig(**cfg), jnp.asarray(gate), jnp.asarray(up))
    got = moe.moe_act(moe.MoEConfig(**cfg), torch.from_numpy(gate), torch.from_numpy(up))
    _close(got, want, 2e-6)
    with pytest.raises(ValueError, match="act_fn"):
        moe.moe_act(moe.MoEConfig(act_fn="gelu"), torch.from_numpy(gate), torch.from_numpy(up))


def test_update_router_bias_and_unported_dispatch():
    rng = np.random.default_rng(7)
    bias = rng.standard_normal(8).astype(np.float32)
    load = rng.random(8).astype(np.float32)
    want = jmoe.update_router_bias(jnp.asarray(bias), jnp.asarray(load), speed=0.01)
    got = moe.update_router_bias(torch.from_numpy(bias), torch.from_numpy(load), speed=0.01)
    _close(got, want, 1e-7)
    with pytest.raises(NotImplementedError, match="item 8b"):
        moe.MoEMlp(moe.MoEConfig(dispatch="dropless_ep"), D)
    # the config is JAX's, field for field
    assert [f.name for f in dataclasses.fields(moe.MoEConfig)] == \
        [f.name for f in dataclasses.fields(jmoe.MoEConfig)]
    assert dataclasses.asdict(moe.MoEConfig()) == dataclasses.asdict(jmoe.MoEConfig())
