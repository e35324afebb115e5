"""Offline pseudo-label dataset: detections JSON -> training annotations.

Counterpart of `semi_detr_tpu/data/pseudo_coco.py`, over the port's
`CocoDataset`. Capability parity with the reference's `PseudoCocoDataset`
(`detr_ssod/datasets/pseudo_coco.py:8-86`): takes a COCO-format image
set plus a detection-results JSON (list of {image_id, bbox xywh, score,
category_id}), keeps detections with score >= `pseudo_ann_thr`, and
exposes them as a `CocoDataset`-compatible dataset for offline
pseudo-label training.
"""
from __future__ import annotations

import json
from typing import Dict, List, Sequence, Union

from .coco import COCO_CLASSES, CocoDataset


def build_pseudo_coco(image_ann_file: Union[str, Dict],
                      det_results_file: Union[str, List],
                      score_thr: float = 0.9) -> Dict:
    """Returns a COCO dict whose annotations are thresholded detections."""
    if isinstance(image_ann_file, str):
        with open(image_ann_file) as f:
            base = json.load(f)
    else:
        base = dict(image_ann_file)
    if isinstance(det_results_file, str):
        with open(det_results_file) as f:
            dets = json.load(f)
    else:
        dets = det_results_file

    anns = []
    for i, d in enumerate(dets):
        if d.get("score", 0.0) < score_thr:
            continue
        x, y, w, h = d["bbox"]
        anns.append({
            "id": i + 1,
            "image_id": d["image_id"],
            "category_id": d["category_id"],
            "bbox": [x, y, w, h],
            "area": w * h,
            "iscrowd": 0,
            "score": d["score"],
        })
    out = dict(base)
    out["annotations"] = anns
    return out


class PseudoCocoDataset(CocoDataset):
    def __init__(self, image_ann_file, det_results_file,
                 pseudo_ann_thr: float = 0.9, img_prefix: str = "",
                 classes: Sequence[str] = COCO_CLASSES, **kw):
        coco = build_pseudo_coco(image_ann_file, det_results_file,
                                 pseudo_ann_thr)
        super().__init__(coco, img_prefix, classes=classes, **kw)
