"""The port's COCO mAP (`data/coco_eval.py`) against the JAX package's:
the result dicts are equal, key for key and value for value (NaN where
both are NaN), on seeded detections and ground truth with crowd and
ignore regions, COCO areas, images without detections and classes
without GT."""
import math

import numpy as np
import pytest

from semi_detr_tpu.data import coco_eval as jax_eval
from semi_detr_tpu_torch.data import coco_eval as port_eval

NAMES = ("a", "b", "c", "d", "e")


def _boxes(rs, n, size=200.0):
    xy = rs.uniform(0, size * 0.8, (n, 2))
    wh = rs.uniform(4, size * 0.5, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _case(seed, n_img=7, num_classes=5):
    rs = np.random.RandomState(seed)
    gts, dets = {}, {}
    for img in range(n_img):
        m = rs.randint(0, 6)
        b = _boxes(rs, m)
        labels = rs.randint(0, num_classes - 1, m)     # the last: no GT
        crowd = rs.rand(m) < 0.2
        rec = (b, labels, crowd)
        if seed % 2:                                   # COCO areas
            rec += ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
                    * rs.uniform(0.5, 1.0, m),)
        gts[img] = rec
        if img == 0:
            continue                                   # no detections
        n = rs.randint(0, 12)
        # detections near a GT box with its label, and some anywhere
        pick = rs.randint(0, max(m, 1), n)
        near = (b[pick] + rs.normal(0, 6, (n, 4)) if m else _boxes(rs, n))
        db = np.where(rs.rand(n, 1) < 0.7, near, _boxes(rs, n)).astype(
            np.float32)
        dl = np.where(rs.rand(n) < 0.8, labels[pick] if m else 0,
                      rs.randint(0, num_classes, n))
        dets[img] = (db, rs.rand(n).astype(np.float32), dl)
    return dets, gts


def _assert_same(got, ref):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, dict):
            _assert_same(got[k], v)
        elif v is None or (isinstance(v, float) and math.isnan(v)):
            assert got[k] is None or math.isnan(got[k]), k
        else:
            assert got[k] == v, (k, got[k], v)


@pytest.mark.parametrize("seed", range(4))
def test_coco_map_equal(seed):
    dets, gts = _case(seed)
    ref = jax_eval.coco_map(dets, gts, len(NAMES), NAMES)
    got = port_eval.coco_map(dets, gts, len(NAMES), NAMES)
    _assert_same(got, ref)
    assert 0.0 < got["mAP_50"] <= 1.0
    assert got["AP_per_class"]["e"] is None


def test_box_iou_crowd_equal():
    rs = np.random.RandomState(9)
    a, b = _boxes(rs, 6), _boxes(rs, 5)
    crowd = np.asarray([True, False, True, False, False])
    np.testing.assert_array_equal(port_eval.box_iou_xyxy(a, b, crowd),
                                  jax_eval.box_iou_xyxy(a, b, crowd))
