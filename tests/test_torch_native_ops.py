"""The port's C++ host ops, ROIAlign3D / ROIPool3D and focal losses vs the
JAX package's, on the CPU.

The library the port builds from native/*.cpp is held against the JAX
package's ops/native.py and against the port's own numpy plain versions:
NMS indices exactly, soft-NMS indices exactly and scores to 1e-6, the
Weibull fit's shape / scale to rtol 1e-9 against JAX (the same C++) and
1e-5 against numpy, w_score to 1e-12. ROIAlign3D / ROIPool3D and both
focal losses are held to JAX's in fp32 at max-abs 1e-5, their gradients
too (the ROI ops' input gradients, sums over up to 64 samples of values
near 10, at 1e-5 absolute + 1e-5 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internvideo_tpu.ops import losses as jlosses
from internvideo_tpu.ops import native as jnative
from internvideo_tpu.ops import roi_align3d as jroi
from internvideo_tpu_torch.ops import losses as plosses
from internvideo_tpu_torch.ops import native as pnative
from internvideo_tpu_torch.ops import roi_align3d as proi

TOL = 1e-5


def _proposals(seed=0, n=50):
    rng = np.random.RandomState(seed)
    starts = rng.rand(n) * 100
    segs = np.stack([starts, starts + 1 + rng.rand(n) * 20], 1)
    return segs.astype(np.float32), rng.rand(n).astype(np.float32)


def test_native_library_builds_outside_native_dir():
    path = pnative.build()
    assert path.exists() and path.parent == pnative.BUILD_DIR
    assert pnative.NATIVE_DIR not in path.parents
    assert pnative.load_library() is pnative.load_library()


@pytest.mark.parametrize("seed,iou,max_keep", [(0, 0.5, None), (1, 0.3, 7), (2, 0.7, None)])
def test_temporal_nms_matches_jax_and_plain(seed, iou, max_keep):
    segs, scores = _proposals(seed)
    got = pnative.temporal_nms(segs, scores, iou, max_keep)
    np.testing.assert_array_equal(got, jnative.temporal_nms(segs, scores, iou, max_keep))
    np.testing.assert_array_equal(
        got, pnative._temporal_nms_np(segs, scores, iou, max_keep or len(scores)))
    assert got.dtype == np.int32 and np.all(np.diff(scores[got]) <= 0)
    assert len(pnative.temporal_nms(segs[:0], scores[:0])) == 0


@pytest.mark.parametrize("method", ["gaussian", "linear"])
def test_soft_nms_matches_jax_and_plain(method):
    segs, scores = _proposals(3)
    idx, vals = pnative.soft_temporal_nms(segs, scores, 0.4, 0.5, 1e-3, method)
    j_idx, j_vals = jnative.soft_temporal_nms(segs, scores, 0.4, 0.5, 1e-3, method)
    n_idx, n_vals = pnative._soft_temporal_nms_np(segs, scores, 0.4, 0.5, 1e-3, method)
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_array_equal(idx, n_idx)
    np.testing.assert_allclose(vals, j_vals, atol=1e-6)
    np.testing.assert_allclose(vals, n_vals, atol=1e-6)
    assert np.all(np.diff(vals) <= 1e-6)


@pytest.mark.parametrize("tail", [10, 500])
def test_weibull_matches_jax_and_plain(tail):
    rng = np.random.RandomState(0)
    data = 5.0 * rng.weibull(2.0, size=2000) - 0.5  # some negatives: a translate
    mr, jmr, nmr = pnative.MetaRecognition(), jnative.MetaRecognition(), pnative.MetaRecognition()
    assert mr.fit_high(data, tail) and jmr.fit_high(data, tail)
    nmr._fit_high_np(np.asarray(data, np.float64), tail)
    for other, rtol in ((jmr, 1e-9), (nmr, 1e-5)):
        np.testing.assert_allclose([mr.shape, mr.scale, mr.translate],
                                   [other.shape, other.scale, other.translate], rtol=rtol)
    x = np.array([-2.0, 0.1, 3.0, 5.0, 30.0])
    w = mr.w_score(x)
    np.testing.assert_allclose(w, jmr.w_score(x), atol=1e-12)
    np.testing.assert_allclose(w, pnative._w_score_np(x, mr.shape, mr.scale, mr.translate),
                               atol=1e-12)
    assert not pnative.MetaRecognition().fit_high(np.array([1.0]), 5)  # one point: no fit


def _roi_inputs(seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((2, 3, 9, 11, 5)).astype(np.float32)
    boxes = np.array([[0, -2.0, 1.0, 6.5, 7.0], [1, 3.2, 0.2, 12.0, 10.5],
                      [1, 5.0, 5.0, 5.3, 5.2], [0, 0.0, 0.0, 11.0, 9.0]], np.float32)
    return feats, boxes


@pytest.mark.parametrize("fn", ["roi_align_3d", "roi_pool_3d"])
@pytest.mark.parametrize("kw", [{}, dict(output_size=(3, 4), spatial_scale=0.5)])
def test_roi_ops_match_jax(fn, kw):
    """Boxes past every edge of the map, one smaller than a pixel; values
    and the input gradient of sum(out^2)."""
    feats, boxes = _roi_inputs()
    jfn, pfn = getattr(jroi, fn), getattr(proi, fn)
    @jax.jit
    def reference(f):
        out, vjp = jax.vjp(lambda z: jfn(z, jnp.asarray(boxes), **kw), f)
        return out, vjp(2 * out)[0]  # the gradient of sum(out^2)

    want, g = (np.asarray(a) for a in reference(jnp.asarray(feats)))
    x = torch.from_numpy(feats).requires_grad_()
    got = pfn(x, torch.from_numpy(boxes), **kw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL, rtol=0)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), atol=TOL, rtol=TOL)


def test_focal_losses_match_jax():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((6, 5)) * 3).astype(np.float32)
    sig_t = np.array([0, 1, 5, -1, 3, 2], np.int32)  # 0 background, -1 ignored
    soft_t = np.array([0, 4, 2, 1, 0, 3], np.int32)
    for name, t in (("sigmoid_focal_loss", sig_t), ("softmax_focal_loss", soft_t)):
        for kw in ({}, dict(gamma=1.5, alpha=0.4)):
            x = torch.from_numpy(logits).requires_grad_()
            got = getattr(plosses, name)(x, torch.from_numpy(t), **kw)
            got.backward()
            jfn = getattr(jlosses, name)
            want, g = jax.jit(jax.value_and_grad(lambda z: jfn(z, jnp.asarray(t), **kw)))(
                jnp.asarray(logits))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.item(), float(want), atol=TOL, rtol=0)
            np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), atol=TOL, rtol=0)
