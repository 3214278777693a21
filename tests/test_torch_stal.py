"""The STAL ROI action head in the PyTorch port vs the JAX package, on the
CPU in fp32.

tests/test_stal.py's tiny head (in_dim 8, hidden 32, 3 + 2 + 2 classes,
ROI 4 x 4) on its synthetic feature volumes, with one padded box; the port
loads the JAX init params through `params_from_jax`. Held: the logits and
every `stal_loss` term at max-abs 2e-5, every parameter's gradient and the
features' gradient against `jax.grad` at max-abs 5e-4 (the JAX kernels'
grad bar). `random_box_aug` draws from a torch.Generator, so it is held to
the properties tests/test_stal.py:44 checks, not to JAX's draws.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internvideo_tpu.models import stal as J
from internvideo_tpu_torch.models import stal as P
from internvideo_tpu_torch.models.convert import params_from_jax

KW = dict(in_dim=8, hidden_dim=32, num_pose=3, num_object=2, num_person=2, roi_size=(4, 4))
FWD_TOL, GRAD_TOL = 2e-5, 5e-4


def _synth(seed=1, b=2, n=3, t=4, hw=16):
    """tests/test_stal.py's `_synth`: box interiors carry their pose class
    on channel c and interaction flags on channels 3-6; the last box of
    clip 1 is padding."""
    cfg = J.STALConfig(**KW)
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, t, hw, hw, cfg.in_dim)).astype(np.float32) * 0.1
    boxes = np.zeros((b, n, 4), np.float32)
    labels = np.zeros((b, n, cfg.num_classes), np.float32)
    for i in range(b):
        for j in range(n):
            x1, y1, w = rng.integers(0, hw - 6), rng.integers(0, hw - 6), rng.integers(4, 6)
            boxes[i, j] = (x1 + 0.3, y1 + 0.6, x1 + w, y1 + w + 0.2)
            pose = rng.integers(0, cfg.num_pose)
            labels[i, j, pose] = 1.0
            feats[i, :, y1:y1 + w, x1:x1 + w, pose] += 3.0
            if rng.random() < 0.5:
                k = rng.integers(0, cfg.num_object)
                labels[i, j, cfg.num_pose + k] = 1.0
                labels[i, j, cfg.num_pose + cfg.num_object + (j % 2)] = 1.0
                feats[i, :, y1:y1 + w, x1:x1 + w, cfg.num_pose + k] += 3.0
    mask = np.ones((b, n), bool)
    mask[1, -1] = False
    return feats, boxes, labels, mask


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = J.STALConfig(**KW), P.STALConfig(**KW)
    feats, boxes, labels, mask = _synth()
    jm = J.ROIActionHead(jcfg)
    params = jax.tree.map(np.asarray, flax_nn.unbox(jax.jit(jm.init)(
        jax.random.key(0), jnp.asarray(feats), jnp.asarray(boxes), jnp.asarray(mask))))

    def loss_fn(p, f):
        logits = jm.apply(p, f, jnp.asarray(boxes), jnp.asarray(mask))
        total, parts = J.stal_loss(logits, jnp.asarray(labels), jnp.asarray(mask), jcfg)
        return total, (logits, parts)

    (loss, (logits, parts)), grads = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1),
                                                                has_aux=True))(
        params, jnp.asarray(feats))
    pm = P.ROIActionHead(pcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(params_from_jax(params), strict=True)
    want = dict(loss=float(loss), logits=np.asarray(logits),
                parts={k: float(v) for k, v in parts.items()},
                grads=jax.tree.map(np.asarray, grads))
    return dict(pcfg=pcfg, pm=pm, inputs=(feats, boxes, labels, mask), want=want)


def test_head_forward_matches_jax(setup):
    feats, boxes, _, mask = (torch.from_numpy(x) for x in setup["inputs"])
    with torch.no_grad():
        got = setup["pm"](feats, boxes, mask)
    want = setup["want"]["logits"]
    assert tuple(got.shape) == want.shape == (2, 3, 7)
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=0)


def test_stal_loss_and_grads_match_jax(setup):
    pm, want = setup["pm"], setup["want"]
    feats, boxes, labels, mask = (torch.from_numpy(x) for x in setup["inputs"])
    feats.requires_grad_()
    pm.zero_grad()
    total, parts = P.stal_loss(pm(feats, boxes, mask), labels, mask, setup["pcfg"])
    total.backward()
    np.testing.assert_allclose(total.item(), want["loss"], atol=FWD_TOL, rtol=0)
    assert parts.keys() == want["parts"].keys()
    for k, v in parts.items():
        np.testing.assert_allclose(v.item(), want["parts"][k], atol=FWD_TOL, rtol=0, err_msg=k)
    want_g = params_from_jax(want["grads"][0])
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), atol=GRAD_TOL, rtol=0,
                                   err_msg=name)
    np.testing.assert_allclose(feats.grad.numpy(), want["grads"][1], atol=GRAD_TOL, rtol=0)


def test_random_box_aug_properties():
    """tests/test_stal.py:44's bounds (sizes within 35 %), the shape, the
    draws' determinism under one seed, and jitter that moves every box."""
    _, boxes, _, _ = _synth()
    boxes = torch.from_numpy(boxes)
    out = P.random_box_aug(boxes, torch.Generator().manual_seed(0))
    assert out.shape == boxes.shape
    w0, w1 = boxes[..., 2] - boxes[..., 0], out[..., 2] - out[..., 0]
    h0, h1 = boxes[..., 3] - boxes[..., 1], out[..., 3] - out[..., 1]
    assert (w1 / w0 - 1).abs().max() < 0.35 and (h1 / h0 - 1).abs().max() < 0.35
    c0, c1 = 0.5 * (boxes[..., 0] + boxes[..., 2]), 0.5 * (out[..., 0] + out[..., 2])
    assert ((c1 - c0).abs() / w0).max() < 0.4
    assert torch.equal(out, P.random_box_aug(boxes, torch.Generator().manual_seed(0)))
    assert not torch.equal(out, P.random_box_aug(boxes, torch.Generator().manual_seed(1)))
    assert not (out == boxes).any()


def test_dropout_draws_from_the_generator():
    cfg = P.STALConfig(**{**KW, "dropout": 0.5})
    head = P.ROIActionHead(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    feats, boxes, _, mask = (torch.from_numpy(x) for x in _synth())
    with pytest.raises(ValueError, match="generator"):
        head(feats, boxes, mask, deterministic=False)
    a, b = (head(feats, boxes, mask, deterministic=False,
                 generator=torch.Generator().manual_seed(7)) for _ in range(2))
    assert torch.equal(a, b) and not torch.equal(a, head(feats, boxes, mask))
