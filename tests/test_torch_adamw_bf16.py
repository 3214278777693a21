"""One bf16 AdamW step of the PyTorch port vs the JAX package's optax chain.

At configs/torch/sft_tiny.py's widths and optimizer (lr 1e-4, weight decay
0.05, clip 3.0), the same bf16 params (the port's VideoMLLM init) and the
same bf16 grads (seeded numpy) take one step through

  * JAX: internvideo_tpu/train/optim.py's chain, clip -> scale_by_adam ->
    decayed weights -> lr, in bf16, jitted, over the params as a
    flat dict of the port's names (its no-decay mask, matched on the path,
    is the port's `decays`);
  * the port's CPU route: torch's fused AdamW, fp32 arithmetic and one
    bf16 rounding of p, m and v per step (train/optim.py). The card runs the
    same fused update; chip_smoke.py holds the two against each other;
  * an fp32 reference: the port's optimizer on fp32 copies, rounded to bf16
    once at the end: what the fused behaviour computes.

The port holds to the fused behaviour: its CPU route matches the fp32
reference to 1e-5 of the update's norm (rel-L2; measured 0). JAX's bf16
roundings move its update by 1.8e-3 of the update's norm, jitted as its
train step runs it (8.4e-4 op by op); it is held to 5e-3.
"""

import dataclasses

import jax
import ml_dtypes
import numpy as np
import optax
import torch

from internvideo_tpu.train.optim import OptimizerConfig as JOptimizerConfig
from internvideo_tpu.train.optim import build_optimizer as jax_build_optimizer
from internvideo_tpu.train.optim import no_decay_mask
from internvideo_tpu_torch.core.config import load_config
from internvideo_tpu_torch.models.convert import params_from_jax
from internvideo_tpu_torch.models.mllm import VideoMLLM
from internvideo_tpu_torch.train.optim import Optimizer, decays


def _step(opt_cfg, params, grads, dtype):
    """The port's optimizer on copies of `params` (name -> tensor) in
    `dtype` with `grads`; returns the updated params and the optimizer."""
    ps = {k: v.to(dtype).clone().requires_grad_() for k, v in params.items()}
    for k, p in ps.items():
        p.grad = grads[k].to(dtype).clone()
    opt = Optimizer(opt_cfg, list(ps.items()))
    opt.step()
    return {k: p.detach() for k, p in ps.items()}, opt


def _rel_update(got, want, start):
    num = sum(((got[k].float() - want[k].float()) ** 2).sum() for k in want)
    den = sum(((want[k].float() - start[k].float()) ** 2).sum() for k in want)
    return (num / den).sqrt().item()


def test_bf16_step_matches_fused_reference_and_jax():
    run = load_config("configs/torch/sft_tiny.py")
    opt_cfg = run.trainer.optimizer
    model = VideoMLLM(run.model, device="cpu", generator=torch.Generator().manual_seed(0))
    bf16 = ml_dtypes.bfloat16
    rng = np.random.default_rng(0)
    p0 = {k: v.float().numpy().astype(bf16) for k, v in model.state_dict().items()}
    g0 = {k: (rng.standard_normal(v.shape) * 0.05).astype(bf16) for k, v in p0.items()}
    mask = no_decay_mask(p0)
    assert all(mask[k] == decays(k, v) for k, v in model.state_dict().items())

    tx, _ = jax_build_optimizer(JOptimizerConfig(**dataclasses.asdict(opt_cfg)), p0)
    step = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))
    jax_new = params_from_jax(jax.tree.map(np.asarray, step(g0, p0)))

    start, grads = params_from_jax(p0), params_from_jax(g0)
    port_new, opt = _step(opt_cfg, start, grads, torch.bfloat16)
    ref32, _ = _step(opt_cfg, start, grads, torch.float32)
    ref = {k: v.to(torch.bfloat16) for k, v in ref32.items()}
    assert all(p.dtype == torch.bfloat16 for p in port_new.values())
    assert all(s["exp_avg_sq"].dtype == torch.bfloat16 for s in opt.adamw.state.values())
    assert sum((ref[k] != start[k]).sum().item() for k in ref) > 0.5 * sum(
        v.numel() for v in ref.values())  # the step moves most elements
    assert _rel_update(port_new, ref, start) <= 1e-5
    gap = _rel_update(jax_new, ref, start)
    assert 0 < gap <= 5e-3, gap
