"""Host-side batching: bucketed padding, GT packing and the train/test
batches.

Counterpart of `semi_detr_tpu/data/pipeline.py`, uint8 only. Images are
padded with zeros to a fixed bucket (H, W) and shipped as raw uint8; the
model normalizes them on the device (`models/dino_head.prepare_images`)
and re-zeroes the padding through the per-image valid extent. GT is packed
to `max_gt` slots with a validity mask, as normalized cxcywh over the valid
extent. The batch dicts keep the JAX package's keys, which the port's
steps consume.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import native
from .augment import (COCO_SCALES, TEST_SCALE, Sample, make_sample,
                      rescale_size, resized, strong_augment, sup_augment,
                      test_resize, weak_augment)

# buckets covering the 11 training scales x max long side 1333 (H, W and
# W, H orientations); every resized image fits with < 13 % padding
DEFAULT_BUCKETS: Tuple[Tuple[int, int], ...] = (
    (512, 672), (672, 512),
    (544, 912), (912, 544),
    (704, 1184), (1184, 704),
    (800, 1344), (1344, 800),
)

# training bucket short sides for multi-bucket mode: the 11 reference
# scales (480..800 x 1333) quantize onto 3 bucket heights
BUCKET_SHORTS: Tuple[int, ...] = (544, 672, 800)

# the eval reader's loader: threads, and images in flight beyond the batch
# being packed
PREFETCH_THREADS, PREFETCH_AHEAD = 4, 8


def _quantize_short(short: int, base_bucket) -> int:
    """Bucket short side for a scale's short side; the configured bucket's
    short side is the fallback, so a custom scale above max(BUCKET_SHORTS)
    still gets a bucket that fits its resize."""
    bh = next((s for s in BUCKET_SHORTS if s >= short), min(base_bucket))
    return min(bh, min(base_bucket))


def pick_step_bucket(bucket_rng, scales, base_bucket, flag):
    """Multi-bucket training: draw one scale for this step, quantize it to
    a bucket, and return every scale of that bucket's quantization class
    (each image then draws its own scale from the class, so the per-image
    scale marginal stays the reference's uniform one). `bucket_rng`
    advances exactly once per step.

    Returns (class_scales, (H, W) bucket), the bucket oriented by `flag`
    (1 = landscape)."""
    scale = tuple(scales[int(bucket_rng.integers(len(scales)))])
    long_side = max(base_bucket)
    bh = _quantize_short(min(scale), base_bucket)
    class_scales = [tuple(s) for s in scales
                    if _quantize_short(min(s), base_bucket) == bh]
    bucket = (bh, long_side) if flag == 1 else (long_side, bh)
    return class_scales, bucket


def pick_bucket(h: int, w: int,
                buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS
                ) -> Tuple[int, int]:
    """Smallest bucket that contains (h, w); the largest when none does."""
    best = None
    for bh, bw in buckets:
        if bh >= h and bw >= w:
            area = bh * bw
            if best is None or area < best[0]:
                best = (area, (bh, bw))
    if best is None:
        return max(buckets, key=lambda b: b[0] * b[1])
    return best[1]


@dataclass
class PackedImage:
    image: np.ndarray       # (BH, BW, 3) uint8, zero-padded
    hw: np.ndarray          # (2,) int32 valid extent
    boxes: np.ndarray       # (G, 4) float32 normalized cxcywh
    labels: np.ndarray      # (G,) int32
    valid: np.ndarray       # (G,) bool
    matrix: np.ndarray      # (3, 3) float32 transform matrix
    image_id: int = -1
    scale_factor: np.ndarray = None   # (2,) per-axis (fx, fy)


def pack(sample: Sample, bucket: Tuple[int, int], max_gt: int,
         image_id: int = -1) -> PackedImage:
    h, w = sample.img.shape[:2]
    bh, bw = bucket
    if h > bh or w > bw:
        raise ValueError(f"image {(h, w)} does not fit bucket {bucket}")
    if sample.img.dtype != np.uint8:
        raise TypeError(f"pack takes uint8 images, got {sample.img.dtype}")
    img = np.zeros((bh, bw, 3), np.uint8)
    img[:h, :w] = sample.img

    n = min(len(sample.boxes), max_gt)
    boxes = np.zeros((max_gt, 4), np.float32)
    labels = np.zeros((max_gt,), np.int32)
    valid = np.zeros((max_gt,), bool)
    if n:
        b = sample.boxes[:n]
        cx = (b[:, 0] + b[:, 2]) / 2 / w
        cy = (b[:, 1] + b[:, 3]) / 2 / h
        bw_ = (b[:, 2] - b[:, 0]) / w
        bh_ = (b[:, 3] - b[:, 1]) / h
        boxes[:n] = np.stack([cx, cy, bw_, bh_], 1)
        labels[:n] = sample.labels[:n]
        valid[:n] = True
    return PackedImage(
        image=img, hw=np.asarray([h, w], np.int32), boxes=boxes,
        labels=labels, valid=valid,
        matrix=sample.matrix.astype(np.float32), image_id=image_id,
        scale_factor=sample.scale_factor)


def stack(packed: List[PackedImage]) -> Dict[str, Any]:
    """Packed images of one bucket -> a batch dict of numpy arrays shaped
    like the JAX package's: images, img_hw, gt {boxes, labels, valid},
    tmat, image_ids."""
    return {
        "images": np.stack([p.image for p in packed]),
        "img_hw": np.stack([p.hw for p in packed]),
        "gt": {
            "boxes": np.stack([p.boxes for p in packed]),
            "labels": np.stack([p.labels for p in packed]),
            "valid": np.stack([p.valid for p in packed]),
        },
        "tmat": np.stack([p.matrix for p in packed]),
        "image_ids": np.asarray([p.image_id for p in packed], np.int64),
    }


def make_sup_batch(rng: np.random.Generator, dataset, indices,
                   bucket: Tuple[int, int], max_gt: int = 100,
                   augment=sup_augment, scales=None) -> Dict:
    """Supervised batch: one shared bucket per batch."""
    scales = COCO_SCALES if scales is None else scales
    packed = []
    for i in indices:
        rec = dataset[i]
        s = make_sample(dataset.load_image(i), rec.boxes, rec.labels)
        s = augment(rng, s, scales)
        packed.append(pack(s, bucket, max_gt, rec.id))
    out = stack(packed)
    return {"images": out["images"], "img_hw": out["img_hw"],
            "gt": out["gt"], "image_ids": out["image_ids"]}


def make_unsup_batch(rng: np.random.Generator, dataset, indices,
                     bucket: Tuple[int, int], max_gt: int = 100,
                     scales=None) -> Dict:
    """Two views of the same images (reference MultiBranch,
    `rand_aug.py:952-965`): weak for the teacher, strong for the student,
    each with its transform matrix."""
    scales = COCO_SCALES if scales is None else scales
    weak_p, strong_p = [], []
    for i in indices:
        rec = dataset[i]
        s0 = make_sample(dataset.load_image(i))  # unlabeled: no GT
        weak_p.append(pack(weak_augment(rng, s0, scales), bucket, max_gt,
                           rec.id))
        strong_p.append(pack(strong_augment(rng, s0, scales), bucket,
                             max_gt, rec.id))
    wk, st = stack(weak_p), stack(strong_p)
    return {
        "teacher_images": wk["images"], "teacher_hw": wk["img_hw"],
        "teacher_tmat": wk["tmat"],
        "student_images": st["images"], "student_hw": st["img_hw"],
        "student_tmat": st["tmat"],
        "image_ids": wk["image_ids"],
    }


def _test_batch(samples: List[Sample], ids, bucket, max_gt: int = 100
                ) -> Dict:
    packed = [pack(s, bucket, max_gt, i) for s, i in zip(samples, ids)]
    out = stack(packed)
    out["scale_factors"] = np.asarray(
        [p.scale_factor for p in packed], np.float32)
    return out


def make_test_batch(dataset, indices, bucket: Tuple[int, int] = (800, 1344),
                    max_gt: int = 100, scale=None) -> Dict:
    """Test-resized images of one bucket, with their per-axis scale
    factors (to map boxes back to the original frame)."""
    samples = []
    for i in indices:
        rec = dataset[i]
        s = make_sample(dataset.load_image(i), rec.boxes, rec.labels)
        samples.append(test_resize(s) if scale is None
                       else test_resize(s, scale))
    return _test_batch(samples, [dataset[i].id for i in indices], bucket,
                       max_gt)


def prefetched_test_batches(dataset, groups, scale=None):
    """`make_test_batch(dataset, indices, bucket, scale=scale)` for each
    (indices, bucket) of `groups`, in order, equal to it array for array,
    with the images read, decoded and test-resized ahead by a
    `native.PrefetchLoader` of PREFETCH_THREADS threads, at most
    PREFETCH_AHEAD images beyond the batch being packed. The order is
    known ahead, and so are the target sizes: from the records' width and
    height (the annotation file's); an image file of another size raises.
    `dataset` is a `CocoDataset` (records with `file_name`, and
    `img_prefix`)."""
    scale = TEST_SCALE if scale is None else scale
    order = [i for indices, _ in groups for i in indices]
    loader = native.PrefetchLoader(PREFETCH_THREADS)
    ready, submitted, done = {}, 0, 0
    try:
        for indices, bucket in groups:
            while submitted < min(done + len(indices) + PREFETCH_AHEAD,
                                  len(order)):
                rec = dataset[order[submitted]]
                nh, nw, _ = rescale_size(rec.height, rec.width, scale)
                loader.submit(submitted, os.path.join(dataset.img_prefix,
                                                      rec.file_name),
                              (nh, nw))
                submitted += 1
            samples = []
            for pos in range(done, done + len(indices)):
                while pos not in ready:
                    got = loader.next()
                    ready[got.index] = got
                got, rec = ready.pop(pos), dataset[order[pos]]
                if got.src_hw != (rec.height, rec.width):
                    raise ValueError(
                        f"{rec.file_name}: image of {got.src_hw[0]}x"
                        f"{got.src_hw[1]} pixels, the annotation file says "
                        f"{rec.height}x{rec.width}")
                samples.append(resized(
                    make_sample(got.image, rec.boxes, rec.labels), got.image,
                    got.src_hw))
            done += len(indices)
            yield _test_batch(samples, [dataset[i].id for i in indices],
                              bucket)
    finally:
        loader.close()


def _tensor(x) -> torch.Tensor:
    """A numpy array or CPU tensor as a tensor, int32 as int64 (for
    indexing)."""
    t = (x if isinstance(x, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(x)))
    return t.long() if t.dtype == torch.int32 else t


def _tree(batch, fn):
    return ({k: _tree(v, fn) for k, v in batch.items()}
            if isinstance(batch, dict) else fn(batch))


def to_device(batch: Dict[str, Any], device, non_blocking: bool = False
              ) -> Dict[str, Any]:
    """A `stack` batch (numpy arrays or CPU tensors) as tensors on
    `device`. With `non_blocking`, each copy from pinned memory is queued
    on the current stream and the host goes on; the step that reads the
    batch runs later on the same stream, so it reads the copied data."""
    return _tree(batch, lambda x: _tensor(x).to(device,
                                                non_blocking=non_blocking))


def pin_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """A batch of numpy arrays as page-locked CPU tensors, ready for a
    non-blocking copy to the card."""
    return _tree(batch, lambda x: _tensor(x).pin_memory())


def synthetic_batch(rng: np.random.RandomState, bucket: Tuple[int, int],
                    counts, max_gt: int, num_classes: int = 80
                    ) -> Dict[str, Any]:
    """One seeded batch of random uint8 images inside `bucket` (each side
    3/4 to all of the bucket's), image i with counts[i] random GT boxes of
    at least 8 pixels, through `make_sample`, `pack` and `stack`."""
    packed = []
    bh, bw = bucket
    for n in counts:
        h = rng.randint(bh * 3 // 4, bh + 1)
        w = rng.randint(bw * 3 // 4, bw + 1)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        x0 = rng.uniform(0, w * 0.8, n)
        y0 = rng.uniform(0, h * 0.8, n)
        x1 = np.minimum(x0 + rng.uniform(8, w * 0.5, n), w)
        y1 = np.minimum(y0 + rng.uniform(8, h * 0.5, n), h)
        boxes = np.stack([x0, y0, x1, y1], 1).astype(np.float32)
        labels = rng.randint(0, num_classes, n).astype(np.int32)
        packed.append(pack(make_sample(img, boxes, labels), bucket, max_gt))
    return stack(packed)


def synthetic_ssod_batch(n_sup: int, n_unsup: int, h: int, w: int,
                         max_gt: int, gt_per_image: int = 8, seed: int = 0,
                         student_flip: bool = False) -> Dict[str, Any]:
    """A seeded SSOD batch of numpy arrays (the counterpart of the JAX
    package's `data/synthetic.synthetic_ssod_batch`, equal to it array for
    array by default): float32 images of N(0, 0.25) noise, already
    normalized; the supervised images with `gt_per_image` packed random
    boxes; the unlabeled teacher (weak) and student (strong) views with
    identity transform matrices.

    student_flip: the student view is the teacher view flipped left to
    right, and its matrix the flip's, so the cross-view box transform does
    real work."""
    rs = np.random.RandomState(seed)

    def imgs(n):
        return rs.randn(n, h, w, 3).astype(np.float32) * 0.5

    def hws(n):
        return np.tile(np.asarray([[h, w]], np.int32), (n, 1))

    g = max_gt
    cxy = rs.uniform(0.3, 0.7, (n_sup, g, 2)).astype(np.float32)
    wh = rs.uniform(0.1, 0.3, (n_sup, g, 2)).astype(np.float32)
    eye = np.tile(np.eye(3, dtype=np.float32)[None], (n_unsup, 1, 1))
    batch = {
        "sup": {
            "images": imgs(n_sup), "img_hw": hws(n_sup),
            "gt": {"boxes": np.concatenate([cxy, wh], -1),
                   "labels": rs.randint(0, 80, (n_sup, g)).astype(np.int32),
                   "valid": np.tile(np.arange(g)[None] < gt_per_image,
                                    (n_sup, 1))},
        },
        "unsup": {
            "student_images": imgs(n_unsup), "student_hw": hws(n_unsup),
            "student_tmat": eye,
            "teacher_images": imgs(n_unsup), "teacher_hw": hws(n_unsup),
            "teacher_tmat": eye.copy(),
        },
    }
    if student_flip:
        un = batch["unsup"]
        flip = np.asarray([[-1, 0, w], [0, 1, 0], [0, 0, 1]], np.float32)
        un["student_images"] = np.ascontiguousarray(
            un["teacher_images"][:, :, ::-1])
        un["student_tmat"] = flip @ un["teacher_tmat"]
    return batch
