"""The action-localization evals of the PyTorch port vs the JAX package's,
on the CPU: temporal detection (decode, per-class NMS, ANET mAP), open-set
recognition (OpenMax over libMR) and spatio-temporal detection (ROI
features, box IoU, AVA frame mAP), and the eval CLI's three tasks on the
port's tiny configs against JAX's `run_*` on the JAX tiny configs.

Held: decoded proposals, NMS output, tIoU and box IoU exactly (the same
numpy on the same inputs; NMS through each package's C++ build); mAP dicts
equal; OpenMax probabilities at max-abs 1e-12 (float64 numpy); ROI
descriptors at max-abs 1e-5 (fp32); the CLI result dicts equal with floats
to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from internvideo_tpu.cli import eval as jcli
from internvideo_tpu.core import config as jconfig
from internvideo_tpu.eval import openset as jopen
from internvideo_tpu.eval import spatiotemporal as jst
from internvideo_tpu.eval import temporal_detection as jtd
from internvideo_tpu_torch.cli import eval as pcli
from internvideo_tpu_torch.core import config as pconfig
from internvideo_tpu_torch.eval import openset as popen
from internvideo_tpu_torch.eval import spatiotemporal as pst
from internvideo_tpu_torch.eval import temporal_detection as ptd
from internvideo_tpu_torch.ops.native import _soft_temporal_nms_np

TASKS = ("temporal_detection", "openset", "spatiotemporal")


def _head_outputs(seed, t=80, c=4):
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0, 1, (t, c)).astype(np.float32) ** 3
    left, right = (rng.uniform(0, 9, t).astype(np.float32) for _ in range(2))
    return scores, left, right


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("kw", [dict(), dict(stride=2.0, score_threshold=0.3, max_per_class=5)])
def test_decode_and_nms_match_jax(kw):
    raw = _head_outputs(0)
    got, want = ptd.decode_proposals(*raw, **kw), jtd.decode_proposals(*raw, **kw)
    _assert_same(got, want)
    for nms_kw in (dict(), dict(iou_threshold=0.3, max_keep=3)):
        _assert_same(ptd.nms_proposals(*got, **nms_kw), jtd.nms_proposals(*want, **nms_kw))
    seg = got[0][:9]
    np.testing.assert_array_equal(ptd._tiou(seg, got[0][3:7]), jtd._tiou(seg, got[0][3:7]))
    empty = ptd.decode_proposals(raw[0] * 0, raw[1], raw[2])
    _assert_same(empty, jtd.decode_proposals(raw[0] * 0, raw[1], raw[2]))
    _assert_same(ptd.nms_proposals(*empty), jtd.nms_proposals(*empty))


def test_soft_nms_proposals_return_segments():
    """The port's departure (JAX's soft=True raises): per class, the kept
    segments and their decayed scores, capped at max_keep."""
    segs, scores, labels = ptd.decode_proposals(*_head_outputs(1))
    out_s, out_sc, out_l = ptd.nms_proposals(segs, scores, labels, soft=True, sigma=0.3,
                                             max_keep=4)
    with pytest.raises(TypeError):
        jtd.nms_proposals(segs, scores, labels, soft=True)
    for c in np.unique(labels):
        m = labels == c
        idx, vals = _soft_temporal_nms_np(segs[m], scores[m], sigma=0.3)
        np.testing.assert_array_equal(out_s[out_l == c], segs[m][idx[:4]])
        np.testing.assert_allclose(out_sc[out_l == c], vals[:4], atol=1e-6)


def test_detection_map_matches_jax():
    preds, gt = {}, {}
    for i in range(4):
        segs, sc, labs = jtd.decode_proposals(*_head_outputs(10 + i), score_threshold=0.2)
        preds[f"v{i}"] = jtd.nms_proposals(segs, sc, labs)
        rng = np.random.default_rng(20 + i)
        start = rng.uniform(0, 60, 3).astype(np.float32)
        gt[f"v{i}"] = (np.stack([start, start + rng.uniform(2, 15, 3)], 1).astype(np.float32),
                       rng.integers(0, 4, 3).astype(np.int32))
    gt["v9"] = (np.zeros((1, 2), np.float32) + [1, 5], np.array([2], np.int32))
    for kw in ({}, dict(tiou_thresholds=(0.1, 0.5), num_classes=6)):
        assert ptd.detection_map(preds, gt, **kw) == jtd.detection_map(preds, gt, **kw)


def test_openmax_matches_jax():
    run = pconfig.load_config("configs/torch/eval_openset_tiny.py")
    tr_f, tr_y, tr_z, te_f, te_z, te_y = run.data()
    for kw in (dict(tail_size=10, alpha=2), dict(tail_size=30, alpha=3)):
        got = popen.OpenMax(**kw).fit(tr_f, tr_y, tr_z)
        want = jopen.OpenMax(**kw).fit(tr_f, tr_y, tr_z)
        np.testing.assert_array_equal(got.means, want.means)
        p_got, p_want = got.recalibrate(te_f, te_z), want.recalibrate(te_f, te_z)
        np.testing.assert_allclose(p_got, p_want, atol=1e-12, rtol=0)
        assert popen.openset_metrics(p_got, te_y) == jopen.openset_metrics(p_want, te_y)


def test_roi_features_box_iou_and_frame_map_match_jax():
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, 3, 12, 12, 4)).astype(np.float32)
    rois = np.array([[0, 1.0, 2.0, 7.5, 9.0], [1, 4.0, 0.5, 11.0, 6.0]], np.float32)
    got = pst.roi_action_features(torch.from_numpy(feats), torch.from_numpy(rois),
                                  output_size=(3, 3), spatial_scale=0.9)
    want = jax.jit(lambda f, r: jst.roi_action_features(f, r, output_size=(3, 3),
                                                        spatial_scale=0.9))(
        jnp.asarray(feats), jnp.asarray(rois))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    a, b = rois[:, 1:], np.array([[0, 0, 8, 8], [5, 1, 10, 6], [3, 3, 4, 4]], np.float32)
    np.testing.assert_array_equal(pst.box_iou(a, b), jst.box_iou(a, b))
    preds = {f"f{i}": (np.concatenate([a, b]), rng.uniform(0, 1, (5, 3))) for i in range(3)}
    gt = {"f0": (b, np.array([0, 1, 2])), "f1": (a, np.array([2, 2])),
          "f2": (b[:1], np.array([1])), "f3": (a, np.array([0, 1]))}
    for kw in ({}, dict(iou_threshold=0.3, num_classes=2)):
        assert pst.frame_map(preds, gt, **kw) == jst.frame_map(preds, gt, **kw)


def test_evaluate_action_detector_matches_jax():
    """A head that is a fixed linear map (a tensor in, a tensor out on the
    port's side), on the tiny config's shapes (so JAX's eager ops compile
    once for this test and the CLI's)."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((3, 3)).astype(np.float32)
    feats = {f"f{i}": rng.standard_normal((1, 2, 16, 16, 3)).astype(np.float32) for i in range(3)}
    boxes = {"f0": np.array([[1, 1, 6, 6], [4, 2, 13, 9]], np.float32),
             "f1": np.array([[0, 0, 5, 8]], np.float32),
             "f2": np.zeros((0, 4), np.float32)}
    gt = {"f0": (boxes["f0"], np.array([0, 2])), "f1": (boxes["f1"], np.array([1]))}
    got = pst.evaluate_action_detector(lambda x: x @ torch.from_numpy(w), feats, boxes, gt,
                                       spatial_scale=1.0, device="cpu")
    want = jst.evaluate_action_detector(lambda x: np.asarray(x) @ w, feats, boxes, gt)
    assert got["frame_mAP@0.5"] == pytest.approx(want["frame_mAP@0.5"], abs=1e-6)
    np.testing.assert_allclose(got["per_class_ap"], want["per_class_ap"], atol=1e-6)


@pytest.mark.parametrize("task", TASKS)
def test_cli_tasks_match_jax(task):
    run = pconfig.load_config(f"configs/torch/eval_{task}_tiny.py")
    jrun = jconfig.load_config(f"configs/eval_{task}_tiny.py")
    assert run.task == jrun.task == task and run.options == jrun.options
    got = pcli.TASKS[task](run, torch.device("cpu"))
    want = jcli.TASKS[task](jrun)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-6, rtol=0, err_msg=k)
