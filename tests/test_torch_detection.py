"""The port's ``detection_postprocess`` (plain torch) against the JAX
package's on the cases of tests/test_detection.py: boxes within atol 1e-5,
classes, scores' order and valid counts equal. Scores are drawn without ties
(``lax.top_k`` and ``torch.topk`` break ties differently)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compute_engine_tpu.ops.detection import (
    detection_postprocess as jdetection_postprocess)

from compute_engine_tpu_torch.ops import detection_postprocess

from test_detection import SCALES, _case

BOX_ATOL = 1e-5


def _both(raw, scores, anchors, **kw):
    want = jdetection_postprocess(jnp.asarray(raw), jnp.asarray(scores),
                                  jnp.asarray(anchors), scales=SCALES, **kw)
    got = detection_postprocess(torch.from_numpy(raw),
                                torch.from_numpy(scores),
                                torch.from_numpy(anchors), scales=SCALES,
                                **kw)
    return got, [np.asarray(w) for w in want]


def _assert_same(got, want):
    boxes, classes, scores, count = got
    assert boxes.dtype == torch.float32 and scores.dtype == torch.float32
    assert classes.dtype == torch.int32 and count.dtype == torch.int32
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
    np.testing.assert_allclose(boxes.numpy(), want[0], atol=BOX_ATOL, rtol=0)
    np.testing.assert_array_equal(classes.numpy(), want[1])
    np.testing.assert_allclose(scores.numpy(), want[2], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(count.numpy(), want[3])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fast_nms_matches_jax(seed):
    raw, scores, anchors = _case(seed)
    got, want = _both(raw, scores, anchors, max_detections=10,
                      iou_threshold=0.5, score_threshold=0.3)
    _assert_same(got, want)
    n = int(got[3][0])
    assert 0 < n <= 10
    assert bool((got[2][0, n:] == 0).all()) and bool((got[0][0, n:] == 0).all())


def test_regular_nms_per_class_matches_jax():
    raw, scores, anchors = _case(3, a=30, c=4)
    got, want = _both(raw, scores, anchors, max_detections=8,
                      iou_threshold=0.5, score_threshold=0.25,
                      use_regular_nms=True)
    _assert_same(got, want)
    assert len(set(got[1][0].tolist())) > 1  # more than one class survives


def test_int8_inputs_dequantized_inline_match_jax():
    raw, scores, anchors = _case(4)
    (bs, bzp), (ss, szp), (as_, azp) = (0.05, 3), (1 / 255.0, -128), (0.004, 0)
    b_i8 = np.clip(np.round(raw / bs) + bzp, -128, 127).astype(np.int8)
    s_i8 = np.clip(np.round(scores / ss) + szp, -128, 127).astype(np.int8)
    a_i8 = np.clip(np.round(anchors / as_) + azp, -128, 127).astype(np.int8)
    kw = dict(max_detections=6, iou_threshold=0.5, score_threshold=0.3)
    quant = dict(boxes_quant=(bs, bzp), scores_quant=(ss, szp),
                 anchors_quant=(as_, azp))
    got, want = _both(b_i8, s_i8, a_i8, **kw, **quant)
    _assert_same(got, want)
    floats, _ = _both((b_i8.astype(np.float32) - bzp) * np.float32(bs),
                      (s_i8.astype(np.float32) - szp) * np.float32(ss),
                      (a_i8.astype(np.float32) - azp) * np.float32(as_), **kw)
    for g, f in zip(got, floats):
        np.testing.assert_allclose(g.numpy(), f.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [
    {}, {"use_regular_nms": True}, {"max_classes_per_detection": 2}])
def test_batch_matches_jax_and_each_image_alone(kw):
    raw, scores, anchors = _case(5)
    raw2 = np.concatenate([raw, raw * 0.5])
    scores2 = np.ascontiguousarray(np.concatenate([scores, scores[:, ::-1]]))
    common = dict(max_detections=5, iou_threshold=0.5, score_threshold=0.3,
                  **kw)
    got, want = _both(raw2, scores2, anchors, **common)
    _assert_same(got, want)
    one, _ = _both(raw2[1:], scores2[1:], anchors, **common)
    for g, o in zip(got, one):
        assert torch.equal(g[1], o[0])


def test_validation_raises():
    raw, scores, anchors = (torch.from_numpy(a) for a in _case(6))
    with pytest.raises(ValueError, match=r"boxes must be \(B, A, 4\)"):
        detection_postprocess(torch.zeros((4, 3)), scores, anchors)
    with pytest.raises(ValueError, match="scores must be"):
        detection_postprocess(raw, torch.zeros((1, 7, 2)), anchors)
    with pytest.raises(ValueError, match="anchors must be"):
        detection_postprocess(raw, scores, torch.zeros((3, 4)))
    with pytest.raises(TypeError, match="int8 but no"):
        detection_postprocess(torch.zeros((1, 40, 4), dtype=torch.int8),
                              scores, anchors)
    with pytest.raises(TypeError, match="!= int8"):
        detection_postprocess(raw, scores, anchors, boxes_quant=(0.1, 0))


def test_the_loop_reads_nothing_back_to_the_host(monkeypatch):
    """No ``.item()``, ``bool()`` or ``.tolist()`` on a tensor anywhere in
    the op: on a card each of them would be a synchronisation per box."""
    raw, scores, anchors = (torch.from_numpy(a) for a in _case(7))

    def refuse(name):
        def method(self, *a, **kw):
            raise AssertionError(f"Tensor.{name} would synchronise")
        return method

    for name in ("item", "tolist", "__bool__", "__int__", "__float__",
                 "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse(name))
    for kw in ({}, {"use_regular_nms": True}):
        detection_postprocess(raw, scores, anchors, max_detections=4, **kw)
