"""Synthetic COCO-format dataset for smoke runs, tests and the card run.

Counterpart of `semi_detr_tpu/data/synthetic.py:write_synthetic_coco`
without cv2: the same `np.random.RandomState` draws in the same order, so
the annotation JSON equals the JAX writer's, file names included; ellipses
and bars are drawn in numpy and the images written as JPEG at quality 95,
as cv2.imwrite writes them, through the host library (`native/`). The JAX
writer hands its arrays to cv2, which stores them as BGR; this writer
stores the same channel order, so both sets show the same colours.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, Sequence, Tuple

import numpy as np

from .image_io import write_image


def _fill_ellipse(img, center, axes, angle_deg, color):
    """A filled ellipse (semi-axes `axes`, turned by `angle_deg`), pixel
    centres inside it set to `color`."""
    h, w = img.shape[:2]
    cx, cy = center
    a, b = max(axes[0], 0.5), max(axes[1], 0.5)
    t = math.radians(angle_deg)
    ys, xs = np.mgrid[0:h, 0:w]
    dx, dy = xs - cx, ys - cy
    u = (dx * math.cos(t) + dy * math.sin(t)) / a
    v = (-dx * math.sin(t) + dy * math.cos(t)) / b
    img[u * u + v * v <= 1.0] = color


def write_synthetic_coco(root: str, n: int = 8,
                         hw: Tuple[int, int] = (96, 128), seed: int = 0,
                         class_name: str = "person",
                         splits: Dict[str, Sequence[int]] = None,
                         n_classes: int = 1, max_boxes: int = 1,
                         distractors: int = 0):
    """Write images + annotation json(s) under `root`.

    splits: {name: image indices (0-based)} -> writes `<name>.json` per
    split; None -> one `ann.json` with all images. Returns (paths dict or
    single path, image dir).

    n_classes / max_boxes: each image gets 1..max_boxes rectangles (an
    occluded one is still annotated by its full box); with n_classes > 1
    each class has its own fill colour.

    distractors > 0: each image also gets 0..distractors unannotated
    ellipses and thin bars in jittered palette colours, and the annotated
    rectangles get colour jitter and speckle, so the teacher does not see a
    wall of certain detections.
    """
    rs = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    h, w = hw
    # per-class colours, in the stored (BGR) channel order
    palette = [(220, 60, 60), (60, 220, 60), (60, 60, 220),
               (220, 220, 60), (220, 60, 220), (60, 220, 220)]
    if n_classes > len(palette):
        raise ValueError(
            f"n_classes={n_classes} > {len(palette)} distinct colors")
    images, anns = [], []
    aid = 0
    for i in range(1, n + 1):
        img = (rs.rand(h, w, 3) * 40).astype(np.uint8)
        if distractors:
            for _ in range(int(rs.randint(0, distractors + 1))):
                col = np.clip(np.asarray(
                    palette[int(rs.randint(0, len(palette)))], np.int32)
                    + rs.randint(-90, 90, 3), 0, 255).tolist()
                cx, cy = int(rs.uniform(0, w)), int(rs.uniform(0, h))
                if rs.rand() < 0.5:     # ellipse blob
                    ax = (int(rs.uniform(0.03 * w, 0.12 * w)),
                          int(rs.uniform(0.03 * h, 0.12 * h)))
                    _fill_ellipse(img, (cx, cy), ax,
                                  float(rs.uniform(0, 180)), col)
                else:                   # thin bar
                    bw_ = int(rs.uniform(0.15 * w, 0.4 * w))
                    bh_ = max(int(rs.uniform(0.01 * h, 0.04 * h)), 1)
                    if rs.rand() < 0.5:
                        bw_, bh_ = bh_, bw_
                    x0 = max(min(cx, w - bw_), 0)
                    y0 = max(min(cy, h - bh_), 0)
                    img[y0:y0 + bh_, x0:x0 + bw_] = col
        k = 1 if max_boxes <= 1 else int(rs.randint(1, max_boxes + 1))
        for _ in range(k):
            bw = int(rs.uniform(0.22 * w, 0.36 * w))
            bh = int(rs.uniform(0.25 * h, 0.42 * h))
            x = int(rs.uniform(0, w - bw))
            y = int(rs.uniform(0, h - bh))
            # no draw when single-class, as in the JAX writer
            cls = 0 if n_classes == 1 else int(rs.randint(0, n_classes))
            fill = np.asarray(palette[cls % len(palette)], np.int32)
            if distractors:
                fill = np.clip(fill + rs.randint(-35, 35, 3), 0, 255)
                patch = np.clip(
                    fill[None, None] + rs.randint(-25, 25, (bh, bw, 3)),
                    0, 255).astype(np.uint8)
                img[y:y + bh, x:x + bw] = patch
            else:
                img[y:y + bh, x:x + bw] = fill.tolist()
            aid += 1
            anns.append({"id": aid, "image_id": i, "category_id": cls + 1,
                         "bbox": [x, y, bw, bh], "area": bw * bh,
                         "iscrowd": 0})
        # the array is BGR (as cv2 would store it): the file holds RGB
        write_image(os.path.join(img_dir, f"{i}.jpg"),
                    np.ascontiguousarray(img[..., ::-1]))
        images.append({"id": i, "file_name": f"{i}.jpg", "width": w,
                       "height": h})
    cats = [{"id": c + 1, "name": class_name if c == 0 else f"class{c}"}
            for c in range(n_classes)]

    def dump(name, idx):
        sel = [images[j] for j in idx]
        ids = {im["id"] for im in sel}
        sub = {"images": sel,
               "annotations": [a for a in anns if a["image_id"] in ids],
               "categories": cats}
        path = os.path.join(root, f"{name}.json")
        with open(path, "w") as f:
            json.dump(sub, f)
        return path

    if splits is None:
        return dump("ann", range(n)), img_dir
    return {name: dump(name, idx) for name, idx in splits.items()}, img_dir
