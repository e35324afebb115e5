"""The port's data stream against the JAX package's: the synthetic COCO
writer, the COCO reader, the semi-balance sampler, the batch functions and
the trainers' batch streams.

Both packages read the same PNG files (written by the port), so their
decoded pixels are equal. The batch functions and streams then agree on
everything but the pixels exactly (bucket, valid extent, GT boxes,
labels, validity, matrices, image ids). Pixels: images are drawn at their
training scale, so the resize is the identity on both sides; colour ops are
bit-exact; a geometric op (the strong view's warp) differs from cv2's by
at most one grey level, which a colour op after it may stretch, so the
strong views are held at 2 % of their values differing.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest

from semi_detr_tpu.data import coco as jax_coco
from semi_detr_tpu.data import pipeline as jax_pipeline
from semi_detr_tpu.data import sampler as jax_sampler
from semi_detr_tpu.data import synthetic as jax_synthetic
from semi_detr_tpu.models.dino_head import DinoConfig as JaxDinoConfig
from semi_detr_tpu.models.ssod import SsodConfig as JaxSsodConfig
from semi_detr_tpu.train.loop import SsodTrainer as JaxSsodTrainer
from semi_detr_tpu.train.loop import SupervisedTrainer as JaxSupTrainer
from semi_detr_tpu_torch.data import coco as port_coco
from semi_detr_tpu_torch.data import pipeline as port_pipeline
from semi_detr_tpu_torch.data import sampler as port_sampler
from semi_detr_tpu_torch.data.synthetic import write_synthetic_coco
from semi_detr_tpu_torch.models.dino_head import DinoConfig
from semi_detr_tpu_torch.models.ssod import SsodConfig
from semi_detr_tpu_torch.train.loop import SsodTrainer, SupervisedTrainer

HW = (48, 64)


@pytest.fixture(scope="module")
def coco_set(tmp_path_factory):
    """12 synthetic images, 3 classes, up to 3 boxes and 2 distractors
    each, plus crowd, ignore, out-of-image, zero-area and sub-pixel
    annotations and an image with none of its classes."""
    root = str(tmp_path_factory.mktemp("coco"))
    path, img_dir = write_synthetic_coco(root, n=12, hw=HW, seed=3,
                                         n_classes=3, max_boxes=3,
                                         distractors=2)
    with open(path) as f:
        ann = json.load(f)
    extra = [
        {"image_id": 1, "category_id": 1, "bbox": [5, 5, 20, 10],
         "area": 150, "iscrowd": 1},                       # crowd
        {"image_id": 2, "category_id": 2, "bbox": [1, 2, 30, 20],
         "area": 600, "ignore": 1},                        # ignore flag
        {"image_id": 3, "category_id": 1, "bbox": [70, 10, 9, 9],
         "area": 81},                                      # outside
        {"image_id": 3, "category_id": 3, "bbox": [4, 4, 10, 10],
         "area": 0},                                       # zero area
        {"image_id": 4, "category_id": 1, "bbox": [4, 4, 0.5, 10],
         "area": 5},                                       # sub-pixel
        {"image_id": 5, "category_id": 99, "bbox": [4, 4, 10, 10],
         "area": 100},                                     # unknown class
    ]
    for i, a in enumerate(extra):
        a["id"] = 1000 + i
    ann["annotations"] = [a for a in ann["annotations"]
                          if a["image_id"] != 6] + extra
    ann["images"].append({"id": 13, "file_name": "1.png", "width": 20,
                          "height": 20})                   # below min_size
    with open(path, "w") as f:
        json.dump(ann, f)
    return path, img_dir


def test_synthetic_writer_json_equals_jax(tmp_path):
    kw = dict(n=6, hw=(40, 56), seed=4, n_classes=2, max_boxes=3,
              distractors=2, splits={"a": range(0, 4), "b": range(4, 6)})
    port_paths, _ = write_synthetic_coco(str(tmp_path / "port"), **kw)
    jax_paths, _ = jax_synthetic.write_synthetic_coco(str(tmp_path / "jax"),
                                                      **kw)
    for name in kw["splits"]:
        with open(port_paths[name]) as f:
            port = json.load(f)
        with open(jax_paths[name]) as f:
            ref = json.load(f)
        for im in ref["images"]:
            im["file_name"] = im["file_name"].replace(".jpg", ".png")
        assert port == ref


@pytest.mark.parametrize("train", [True, False])
def test_coco_records_equal(coco_set, train):
    path, img_dir = coco_set
    names = ("person", "class1", "class2")
    kw = dict(classes=names, filter_empty_gt=train, test_mode=not train)
    ref = jax_coco.CocoDataset(path, img_dir, **kw)
    got = port_coco.CocoDataset(path, img_dir, **kw)
    assert len(got) == len(ref) > 0
    np.testing.assert_array_equal(got.flags, ref.flags)
    assert got.cat_id_to_label == ref.cat_id_to_label
    for a, b in zip(got.records, ref.records):
        assert (a.id, a.file_name, a.width, a.height) == (
            b.id, b.file_name, b.width, b.height)
        for key in ("boxes", "labels", "boxes_ignore", "labels_ignore",
                    "ann_ids", "areas", "areas_ignore"):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key),
                                          err_msg=key)
    assert any(len(r.boxes_ignore) for r in got.records)
    # both packages decode the port's PNG files to the same pixels
    for i in range(3):
        np.testing.assert_array_equal(got.load_image(i), ref.load_image(i))


@pytest.mark.parametrize("by_prob,shards", [(False, 1), (True, 1),
                                            (False, 2), (True, 2)])
def test_sampler_streams_equal(by_prob, shards):
    rs = np.random.RandomState(0)
    sup_flags, unsup_flags = rs.randint(0, 2, 9), rs.randint(0, 2, 23)
    for shard in range(shards):
        kw = dict(samples_per_batch=5, sample_ratio=(1, 4), epoch_length=11,
                  by_prob=by_prob, seed=3, num_shards=shards,
                  shard_id=shard)
        ref = jax_sampler.SemiBalanceSampler(9, 23, sup_flags, unsup_flags,
                                             **kw)
        got = port_sampler.SemiBalanceSampler(9, 23, sup_flags, unsup_flags,
                                              **kw)
        for ep in (0, 1):
            for (a, b, c), (x, y, z) in zip(got.epoch(ep), ref.epoch(ep)):
                np.testing.assert_array_equal(a, x)
                np.testing.assert_array_equal(b, y)
                assert c == z


def _assert_batches(got, ref, strong=()):
    """Everything but the pixels exactly; pixels equal, or for the keys in
    `strong` within one grey level of the warp, stretched by at most a
    later colour op."""
    assert set(got) == set(ref)
    for key in ref:
        if isinstance(ref[key], dict):
            _assert_batches(got[key], ref[key], strong)
        elif key in strong:
            diff = np.abs(got[key].astype(int) - ref[key].astype(int))
            assert (diff > 0).mean() < 0.02, key
        elif np.asarray(ref[key]).dtype.kind == "f":
            np.testing.assert_allclose(got[key], ref[key], rtol=0,
                                       atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_batch_functions_equal(coco_set):
    path, img_dir = coco_set
    names = ("person", "class1", "class2")
    ref_ds = jax_coco.CocoDataset(path, img_dir, classes=names)
    got_ds = port_coco.CocoDataset(path, img_dir, classes=names)
    idx, bucket, scales = [0, 2, 3, 5], (48, 64), [HW]
    for seed in range(3):
        ref = jax_pipeline.make_sup_batch(np.random.default_rng(seed),
                                          ref_ds, idx, bucket, 8,
                                          scales=scales)
        got = port_pipeline.make_sup_batch(np.random.default_rng(seed),
                                           got_ds, idx, bucket, 8,
                                           scales=scales)
        _assert_batches(got, ref)
        ref = jax_pipeline.make_unsup_batch(np.random.default_rng(seed),
                                            ref_ds, idx, bucket, 8,
                                            scales=scales)
        got = port_pipeline.make_unsup_batch(np.random.default_rng(seed),
                                             got_ds, idx, bucket, 8,
                                             scales=scales)
        _assert_batches(got, ref, strong=("student_images",))
    ref = jax_pipeline.make_test_batch(ref_ds, idx, (48, 64), scale=HW)
    got = port_pipeline.make_test_batch(got_ds, idx, (48, 64), scale=HW)
    _assert_batches(got, ref)


def test_buckets_equal():
    assert port_pipeline.DEFAULT_BUCKETS == jax_pipeline.DEFAULT_BUCKETS
    for hw in ((500, 700), (700, 500), (1400, 900), (100, 100)):
        assert (port_pipeline.pick_bucket(*hw)
                == jax_pipeline.pick_bucket(*hw))
    for flag in (0, 1):
        jr, tr = np.random.default_rng(4), np.random.default_rng(4)
        for _ in range(6):
            assert (port_pipeline.pick_step_bucket(
                tr, port_pipeline.COCO_SCALES, (800, 1344), flag)
                == jax_pipeline.pick_step_bucket(
                    jr, port_pipeline.COCO_SCALES, (800, 1344), flag))


class FakeDs:
    """Images drawn at their training scale (24x32, landscape)."""

    def __init__(self, n, seed):
        rs = np.random.RandomState(seed)
        self.flags = np.ones(n, np.int64)
        self.imgs = [(rs.rand(24, 32, 3) * 255).astype(np.uint8)
                     for _ in range(n)]
        self.recs = [SimpleNamespace(
            boxes=np.asarray([[4.0, 4.0, 20.0, 16.0]], np.float32),
            labels=np.asarray([0], np.int32), id=i) for i in range(n)]

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        return self.recs[i]

    def load_image(self, i):
        return self.imgs[i].copy()


def _stream_trainers(multi_bucket):
    common = dict(scales=[(24, 32)], multi_bucket=multi_bucket,
                  bucket=(32, 40), seed=3)
    pair = []
    for cls, scfg, dcfg in ((JaxSsodTrainer, JaxSsodConfig, JaxDinoConfig),
                            (SsodTrainer, SsodConfig, DinoConfig)):
        t = cls.__new__(cls)
        t.cfg = scfg(dino=dcfg(num_classes=1, max_gt=4))
        t.sup_dataset, t.unsup_dataset = FakeDs(6, 0), FakeDs(9, 1)
        t.samples_per_batch, t.sample_ratio = 3, (1, 2)
        t.epoch_length, t.by_prob = 4, False
        for k, v in common.items():
            setattr(t, k, v)
        pair.append(t)
    return pair


@pytest.mark.parametrize("multi_bucket", [False, True])
def test_ssod_batch_stream_equal_and_resumes(multi_bucket):
    jt, pt = _stream_trainers(multi_bucket)
    take = lambda gen, n: [next(gen) for _ in range(n)]    # noqa: E731
    ref, got = take(jt.batches(0), 9), take(pt.batches(0), 9)
    for a, b in zip(got, ref):
        _assert_batches(a, b, strong=("student_images",))
    resumed = take(pt.batches(6), 3)
    for a, b in zip(resumed, got[6:]):
        _assert_batches(a, b)


def test_supervised_batch_stream_equal_and_resumes():
    pair = []
    for cls, dcfg in ((JaxSupTrainer, JaxDinoConfig),
                      (SupervisedTrainer, DinoConfig)):
        t = cls.__new__(cls)
        t.cfg = dcfg(num_classes=1, max_gt=4)
        t.dataset, t.batch_size, t.seed = FakeDs(7, 0), 2, 5
        t.scales, t.multi_bucket, t.bucket = [(24, 32)], False, (32, 40)
        pair.append(t)
    jt, pt = pair
    ref = [b for _, b in zip(range(9), jt.batches(0))]
    got = [b for _, b in zip(range(9), pt.batches(0))]
    for a, b in zip(got, ref):
        _assert_batches(a, b)
    resumed = [b for _, b in zip(range(3), pt.batches(6))]
    for a, b in zip(resumed, got[6:]):
        _assert_batches(a, b)
