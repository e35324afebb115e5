"""Host-side packing into a fixed bucket, and batching (the uint8 subset of
`semi_detr_tpu/data/pipeline.py`).

Images are padded with zeros to a fixed bucket (H, W) and shipped as raw
uint8; the model normalizes them on the device
(`models/dino_head.prepare_images`) and re-zeroes the padding through the
per-image valid extent. GT is packed to `max_gt` slots with a validity
mask, as normalized cxcywh over the valid extent.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .augment import Sample, make_sample


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


def to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """A `stack` batch as tensors on `device` (labels as int64, for
    indexing)."""
    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        t = torch.from_numpy(np.ascontiguousarray(x))
        if t.dtype == torch.int32:
            t = t.long()
        return t.to(device)
    return put(batch)


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
