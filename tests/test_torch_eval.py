"""The port's eval loop (`models/inference.run_eval`, `evaluate_detector`)
against the JAX package's, at tiny width with carried weights, float32,
on a synthetic PNG set of landscape and portrait images (both aspect-flag
batches, a padded tail batch, bucket padding).

The images are evaluated at their own size (the test scale is the image
size), so both packages feed the detector the same pixels (cv2's resize
and `interpolate` differ by a grey level elsewhere; test_torch_predict
holds the resize). Per-image detections: labels equal, scores within 1e-5
and boxes within 1e-3 pixel (float32 round-off through the ResNet-50 and
the transformer); the COCO metrics within 1e-4.
"""
import copy
import json
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest

from semi_detr_tpu.data import coco as jax_coco
from semi_detr_tpu.data.pipeline import make_test_batch as jax_test_batch
from semi_detr_tpu.models import inference as jax_inference
from semi_detr_tpu_torch.data import coco as port_coco
from semi_detr_tpu_torch.data.pipeline import make_test_batch
from semi_detr_tpu_torch.data.synthetic import write_synthetic_coco
from semi_detr_tpu_torch.models import inference as port_inference

from test_torch_detector import build_pair

NAMES = ("person", "class1", "class2", "x", "y")
LAND, PORT = (40, 56), (56, 40)

from format_writers import jax_native_fixture

# the JAX package's host library, loaded under the shared lock
jax_native_loaded = jax_native_fixture()


@pytest.fixture(scope="module")
def val_set(tmp_path_factory):
    """5 landscape and 3 portrait images: (annotation dict, image root,
    dataset maker for each package)."""
    root = str(tmp_path_factory.mktemp("val"))
    images, anns = [], []
    for sub, hw, n, offset in (("land", LAND, 5, 0), ("port", PORT, 3, 100)):
        path, _ = write_synthetic_coco(os.path.join(root, sub), n=n, hw=hw,
                                       seed=len(sub), n_classes=3,
                                       max_boxes=3)
        with open(path) as f:
            part = json.load(f)
        for im in part["images"]:
            images.append(dict(im, id=im["id"] + offset,
                               file_name=f"{sub}/images/{im['file_name']}"))
        for a in part["annotations"]:
            anns.append(dict(a, id=a["id"] + offset,
                             image_id=a["image_id"] + offset))
    ann = {"images": images, "annotations": anns,
           "categories": [{"id": i + 1, "name": n}
                          for i, n in enumerate(NAMES)]}
    kw = dict(classes=NAMES, filter_empty_gt=False, test_mode=True)
    return (jax_coco.CocoDataset(ann, root, **kw),
            port_coco.CocoDataset(ann, root, **kw), ann, root)


def _gt_from(dets, ann, seed=0):
    """An annotation set whose GT boxes are the detector's own top
    detections, each moved by a few pixels (so the matches spread over the
    IoU thresholds), and one crowd region: the metrics are far from 0."""
    rs = np.random.RandomState(seed)
    out, aid = [], 0
    for img_id, (boxes, scores, labels) in sorted(dets.items()):
        for k in range(3):
            x0, y0, x1, y1 = (boxes[k] + rs.uniform(-1, 1, 4)).tolist()
            aid += 1
            out.append({"id": aid, "image_id": img_id,
                        "category_id": int(labels[k]) + 1,
                        "bbox": [x0, y0, max(x1 - x0, 1.5),
                                 max(y1 - y0, 1.5)],
                        "area": max(x1 - x0, 1.5) * max(y1 - y0, 1.5),
                        "iscrowd": int(k == 2 and img_id == 1)})
    return dict(ann, annotations=out)


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=3)


def _batches(make, ds, bucket, scale):
    flags = np.asarray(ds.flags)
    for f, bkt in ((1, bucket), (0, bucket[::-1])):
        ids = [int(i) for i in np.nonzero(flags == f)[0]]
        for s in range(0, len(ids), 4):
            idx = ids[s:s + 4]
            yield make(ds, idx + [idx[-1]] * (4 - len(idx)), bkt,
                       scale=scale[::-1] if f == 0 else scale)


@pytest.mark.parametrize("use_nms", [False, True], ids=["topk", "nms"])
def test_run_eval_matches_jax(val_set, pair, use_nms):
    jax_ds, port_ds = val_set[:2]
    jdet, jvars, port = pair
    bucket = (48, 64)
    predict = jax_inference.make_predict_fn(jdet, use_nms)
    ref = jax_inference.run_eval(predict, jvars, _batches(
        jax_test_batch, jax_ds, bucket, LAND))
    got = port_inference.run_eval(port, _batches(
        make_test_batch, port_ds, bucket, LAND), use_nms)
    assert sorted(got) == sorted(ref) and len(got) == 8
    for img_id, (rb, rs, rl) in ref.items():
        gb, gs, gl = got[img_id]
        np.testing.assert_array_equal(gl, np.asarray(rl))
        np.testing.assert_allclose(gs, np.asarray(rs), rtol=0, atol=1e-5)
        np.testing.assert_allclose(gb, np.asarray(rb), rtol=0, atol=1e-3)


@pytest.mark.parametrize("use_nms", [False, True], ids=["topk", "nms"])
def test_evaluate_detector_matches_jax(val_set, pair, use_nms):
    port_ds, ann, root = val_set[1:]
    jdet, jvars, port = pair
    # GT from the port's own detections: both packages must score them the
    # same way through the batching, rescale and ignore plumbing
    ann = _gt_from(port_inference.run_eval(port, _batches(
        make_test_batch, port_ds, (48, 64), LAND), use_nms), ann)
    kw = dict(classes=NAMES, filter_empty_gt=False, test_mode=True)
    jax_ds = jax_coco.CocoDataset(ann, root, **kw)
    port_ds = port_coco.CocoDataset(ann, root, **kw)
    kw = dict(batch_size=4, use_nms=use_nms, bucket=(48, 64),
              test_scale=LAND, num_classes=len(NAMES), class_names=NAMES)
    ref = jax_inference.evaluate_detector(jdet, jvars, jax_ds, **kw)
    got = port_inference.evaluate_detector(port, port_ds, **kw)
    assert 0.05 < got["mAP"] < 1.0 and got["mAP_50"] > 0.2
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k == "AP_per_class":
            for name, ap in v.items():
                assert (ap is None) == (got[k][name] is None), name
                if ap is not None:
                    assert abs(got[k][name] - ap) <= 1e-4, name
        elif math.isnan(v):
            assert math.isnan(got[k]), k
        else:
            assert abs(got[k] - v) <= 1e-4, (k, got[k], v)
    assert not port.training           # the detector's mode is restored


def test_teacher_and_student_evaluated(val_set, pair):
    port_ds = copy.copy(val_set[1])
    port_ds.records = port_ds.records[:2]
    _, _, port = pair
    state = SimpleNamespace(model=port, teacher=port)
    out = port_inference.evaluate_teacher_and_student(
        state, port_ds, bucket=(48, 64), test_scale=LAND,
        num_classes=len(NAMES))
    assert set(out) == {"student", "teacher"}
    assert json.dumps(out["student"]) == json.dumps(out["teacher"])
    state.teacher = None
    assert set(port_inference.evaluate_teacher_and_student(
        state, port_ds, bucket=(48, 64), test_scale=LAND,
        num_classes=len(NAMES))) == {"student"}
