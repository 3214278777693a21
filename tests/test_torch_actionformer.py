"""ActionFormer in the PyTorch port vs the JAX package, on the CPU in fp32.

tests/test_actionformer.py's tiny widths, with full attention (window -1)
and with window 5 on a batch whose second row is padded past frame 45
(segment id -2 at the pads); the port loads the JAX init params through
`actionformer_params_from_jax`. Held: the forward's logits and offsets at
max-abs 2e-5 and its point mask exactly; `label_points` exactly;
`actionformer_loss` and its terms at 2e-5 and every parameter's gradient
against `jax.grad` at max-abs 5e-4 (the JAX kernels' grad bar);
`decode_detections` exactly on the same inputs. JAX's attention takes the
window through its Pallas interpreter, the port's through the plain
band-masked route.
"""

import functools

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internvideo_tpu.models import actionformer as J
from internvideo_tpu_torch.models import actionformer as P
from internvideo_tpu_torch.models.convert import actionformer_params_from_jax

TINY = dict(in_dim=16, embed_dim=32, num_heads=4, num_levels=3, num_blocks=1, head_layers=1,
            num_classes=3, max_seq_len=64)
FWD_TOL, GRAD_TOL = 2e-5, 5e-4


def _batch(seed=0, b=2, n_events=3):
    """tests/test_actionformer.py's synthetic batch (class c paints channel
    c inside its event), row 1 padded past frame 45, its last event masked."""
    rng = np.random.default_rng(seed)
    t, c_in = TINY["max_seq_len"], TINY["in_dim"]
    feats = rng.standard_normal((b, t, c_in)).astype(np.float32) * 0.1
    segs = np.zeros((b, n_events, 2), np.float32)
    labels = np.zeros((b, n_events), np.int32)
    for i in range(b):
        for j in range(n_events):
            start, length = rng.integers(0, 30), rng.integers(3, 14)
            segs[i, j] = (start, start + length)
            labels[i, j] = rng.integers(0, TINY["num_classes"])
            feats[i, start:start + length, labels[i, j]] += 4.0
    mask = np.ones((b, t), bool)
    mask[1, 45:] = False
    event_mask = np.ones((b, n_events), bool)
    event_mask[1, -1] = False
    return {"feats": feats, "mask": mask, "segments": segs, "labels": labels,
            "event_mask": event_mask}


@functools.cache
def _init_params():
    """The JAX model's init params on `_batch()` (the window changes no
    parameter, so both configs share them)."""
    b = _batch()
    jm = J.ActionFormer(J.ActionFormerConfig(**TINY))
    return jax.tree.map(np.asarray, flax_nn.unbox(jax.jit(jm.init)(
        jax.random.key(0), jnp.asarray(b["feats"]), jnp.asarray(b["mask"]))))


def _setup(window):
    """The JAX model's forward, loss terms, gradients and label assignment
    on `_batch()` from one jitted call; the port model on the same params."""
    jcfg, pcfg = J.ActionFormerConfig(window=window, **TINY), P.ActionFormerConfig(
        window=window, **TINY)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    points = J.generate_points(jcfg)
    jm = J.ActionFormer(jcfg)
    params = _init_params()

    def loss_fn(p):
        out = jm.apply(p, jb["feats"], jb["mask"])
        loss, aux = J.actionformer_loss(out, jnp.asarray(points), jb, jcfg)
        return loss, (out, aux)

    @jax.jit
    def reference(p):
        (loss, (out, aux)), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        labels = J.label_points(jnp.asarray(points), jb["segments"], jb["labels"],
                                jb["event_mask"], num_classes=jcfg.num_classes)
        return out, loss, aux, grads, labels

    want = jax.tree.map(np.asarray, reference(params))
    pm = P.ActionFormer(pcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    pm.load_state_dict(actionformer_params_from_jax(params, pcfg), strict=True)
    return dict(jcfg=jcfg, pcfg=pcfg, params=params, pm=pm, batch=batch, points=points,
                want=dict(zip(("out", "loss", "aux", "grads", "labels"), want)))


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=[-1, 5], ids=["full", "window5"])
def setup(request):
    return _setup(request.param)


def test_config_and_points_match_jax():
    for kw in ({}, TINY, dict(regression_ranges=((0, 4), (4, 1e4)), num_levels=2)):
        jc, pc = J.ActionFormerConfig(**kw), P.ActionFormerConfig(**kw)
        np.testing.assert_array_equal(pc.ranges(), jc.ranges())
        np.testing.assert_array_equal(P.generate_points(pc), J.generate_points(jc))


def test_param_tree_maps_exactly(setup):
    params, pcfg = setup["params"], setup["pcfg"]
    sd = actionformer_params_from_jax(params, pcfg)
    assert set(sd) == set(setup["pm"].state_dict())
    assert sd["scales.2"].shape == () and sd["embed0.weight"].shape == (32, 16, 3)
    np.testing.assert_array_equal(sd["embed0.weight"].numpy(),
                                  params["params"]["embed0"]["kernel"].transpose(2, 1, 0))
    with pytest.raises(ValueError, match="num_blocks"):
        actionformer_params_from_jax(params, P.ActionFormerConfig(**{**TINY, "num_blocks": 2}))


def test_forward_matches_jax(setup):
    batch = setup["batch"]
    with torch.no_grad():
        got = setup["pm"](torch.from_numpy(batch["feats"]), torch.from_numpy(batch["mask"]))
    for g, w, what in zip(got, setup["want"]["out"], ("logits", "offsets", "point_mask")):
        assert tuple(g.shape) == w.shape, what
        if what == "point_mask":
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=FWD_TOL, rtol=0, err_msg=what)


def test_label_points_match_jax_exactly(setup):
    tb = _t(setup["batch"])
    got = P.label_points(torch.from_numpy(setup["points"]), tb["segments"], tb["labels"],
                         tb["event_mask"], num_classes=setup["pcfg"].num_classes)
    assert got[2].any()
    for g, w in zip(got, setup["want"]["labels"]):
        np.testing.assert_array_equal(g.numpy(), w)


def test_loss_and_grads_match_jax(setup):
    pm, pcfg, want = setup["pm"], setup["pcfg"], setup["want"]
    tb = _t(setup["batch"])
    pm.zero_grad()
    got, aux = P.actionformer_loss(pm(tb["feats"], tb["mask"]),
                                   torch.from_numpy(setup["points"]), tb, pcfg)
    got.backward()
    np.testing.assert_allclose(got.item(), want["loss"], atol=FWD_TOL, rtol=0)
    for k in ("cls_loss", "reg_loss", "num_pos"):
        np.testing.assert_allclose(aux[k].item(), want["aux"][k], atol=FWD_TOL, rtol=0)
    want_g = actionformer_params_from_jax(want["grads"], pcfg)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(), atol=GRAD_TOL,
                                   rtol=0, err_msg=name)


def test_decode_detections_match_jax(setup):
    batch, points = setup["batch"], setup["points"]
    with torch.no_grad():
        logits, offsets, _ = setup["pm"](torch.from_numpy(batch["feats"][:1]),
                                torch.from_numpy(batch["mask"][:1]))
    for thr in (0.05, 0.5):
        got = P.decode_detections(logits[0], offsets[0], points, score_threshold=thr,
                                  max_per_class=7)
        want = J.decode_detections(logits[0].numpy(), offsets[0].numpy(), points,
                                   score_threshold=thr, max_per_class=7)
        assert got.keys() == want.keys()
        for c in want:
            np.testing.assert_array_equal(got[c], want[c])
