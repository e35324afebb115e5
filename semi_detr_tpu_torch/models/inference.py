"""Test-time decode and the predict function.

Counterpart of the decode half of `semi_detr_tpu/models/inference.py`:

* the post-warm-up decode is the top-300 of the flattened (query x class)
  sigmoid scores (`decode_topk`);
* the warm-up / pseudo-label decode is multiclass NMS (score_thr .01,
  iou .6, max 300) (`decode_nms`);
* boxes are scaled to the valid image extent;
* `run_eval` / `evaluate_detector` / `evaluate_teacher_and_student`: the
  batched COCO-mAP evaluation over a dataset, boxes rescaled to the
  original frame (rescale=True), teacher and student over one loader
  (`SubModulesDistEvalHook`, `submodules_evaluation.py:71-101`).
  `gather_results` (multi-process eval) waits for the multi-GPU slice.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from ..core import boxes as box_ops
from ..ops.nms import multiclass_nms


def _extent(img_hw):
    """(B, 2) valid (h, w) -> (B, 1, 4) multipliers (w, h, w, h)."""
    hw = img_hw.float()
    return torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], -1)[:, None]


def decode_topk(cls_logits, coords, img_hw, max_dets: int = 300):
    """Top-k over flattened query x class scores; one image per row.

    cls_logits (B, nq, K); coords (B, nq, 4) normalized cxcywh.
    Returns boxes (B, D, 4) xyxy in valid-extent pixels, scores, labels.
    """
    b, nq, k = cls_logits.shape
    max_dets = min(max_dets, nq * k)
    scores = cls_logits.sigmoid().reshape(b, -1)
    top_s, top_i = torch.topk(scores, max_dets, dim=1)
    q = top_i // k
    lbl = (top_i % k).to(torch.int32)
    wh = _extent(img_hw)
    bx = box_ops.cxcywh_to_xyxy(
        torch.gather(coords, 1, q[..., None].expand(-1, -1, 4))) * wh
    bx = torch.minimum(bx.clamp(min=0), wh)
    return bx, top_s, lbl


def decode_nms(cls_logits, coords, img_hw, max_dets: int = 300):
    """Warm-up / pseudo-label decode: the multiclass NMS path."""
    scores = cls_logits.sigmoid()
    boxes = box_ops.cxcywh_to_xyxy(coords).clamp(0.0, 1.0)
    wh = _extent(img_hw)
    out_b, out_s, out_l = [], [], []
    for i in range(cls_logits.shape[0]):
        nms = multiclass_nms(boxes[i], scores[i], 0.01, 0.6, max_dets, 2000)
        out_b.append(nms["boxes"] * wh[i])
        out_s.append(torch.where(nms["valid"], nms["scores"],
                                 torch.zeros_like(nms["scores"])))
        out_l.append(nms["labels"])
    return torch.stack(out_b), torch.stack(out_s), torch.stack(out_l)


@torch.inference_mode()
def predict(detector, images, img_hw, use_nms: bool = False,
            max_dets: int = 300):
    """One forward and decode: (boxes, scores, labels) on the device.

    images: (B, H, W, 3) uint8 or normalized float; img_hw: (B, 2) int,
    both on the detector's device. Teacher and student go through this one
    function."""
    decode = decode_nms if use_nms else decode_topk
    out = detector(images, img_hw)
    return decode(out["cls"][-1], out["coord"][-1], img_hw, max_dets)


def make_predict_fn(detector, use_nms: bool = False, max_dets: int = 300):
    """Returns predict(images, img_hw) -> (boxes, scores, labels) of
    `detector`."""
    def predict_fn(images, img_hw):
        return predict(detector, images, img_hw, use_nms, max_dets)

    return predict_fn


def run_eval(detector, batches: Iterable[Dict], use_nms: bool = False,
             score_thr: float = 0.0) -> Dict[int, Tuple]:
    """Inference over `batches` (`data.pipeline.make_test_batch`), in eval
    mode on the detector's device. Returns {image_id: (boxes xyxy in the
    original frame, scores, labels)} as numpy arrays."""
    dev = next(detector.parameters()).device
    was_training = detector.training
    detector.eval()
    results = {}
    try:
        for batch in batches:
            images = torch.from_numpy(batch["images"]).to(dev)
            img_hw = torch.from_numpy(batch["img_hw"]).to(dev)
            boxes, scores, labels = (
                t.cpu().numpy() for t in predict(detector, images, img_hw,
                                                 use_nms))
            sf = batch["scale_factors"]               # (B, 2) per axis
            for i, img_id in enumerate(batch["image_ids"]):
                keep = scores[i] > score_thr
                results[int(img_id)] = (boxes[i][keep] / np.tile(sf[i], 2),
                                        scores[i][keep], labels[i][keep])
    finally:
        detector.train(was_training)
    return results


def _groundtruth(dataset) -> Dict[int, Tuple]:
    """{image_id: (boxes, labels, ignore[, areas])}: crowd/ignore regions
    appended as ignored GT, COCO areas where the records carry them."""
    gts = {}
    for rec in dataset.records:
        ig = np.zeros(len(rec.boxes), bool)
        areas = getattr(rec, "areas", np.zeros(0))
        ig_areas = getattr(rec, "areas_ignore", np.zeros(0))
        if len(rec.boxes_ignore):
            boxes = np.concatenate([rec.boxes, rec.boxes_ignore])
            labels = np.concatenate([rec.labels, rec.labels_ignore])
            ig = np.concatenate([ig, np.ones(len(rec.boxes_ignore), bool)])
            areas = (np.concatenate([areas, ig_areas])
                     if len(areas) == len(rec.boxes)
                     and len(ig_areas) == len(rec.boxes_ignore) else None)
        else:
            boxes, labels = rec.boxes, rec.labels
            if len(areas) != len(boxes):
                areas = None
        gts[rec.id] = ((boxes, labels, ig) if areas is None
                       else (boxes, labels, ig, areas))
    return gts


def evaluate_detector(detector, dataset, batch_size: int = 4,
                      use_nms: bool = False, bucket=(800, 1344),
                      test_scale=None, num_classes: int = 80,
                      class_names=None) -> Dict[str, float]:
    """COCO mAP of one detector over a CocoDataset. Images are batched by
    aspect-ratio flag (portrait ones into the transposed bucket); a short
    last batch repeats its last image, whose duplicate results land on the
    same image id."""
    from ..data.coco_eval import coco_map
    from ..data.pipeline import make_test_batch

    def batches():
        h, w = bucket
        land = (h, w) if w >= h else (w, h)
        flags = np.asarray(dataset.flags)
        for f, bkt in ((1, land), (0, (land[1], land[0]))):
            ids = np.nonzero(flags == f)[0]
            for s in range(0, len(ids), batch_size):
                idx = [int(i) for i in ids[s:s + batch_size]]
                idx = idx + [idx[-1]] * (batch_size - len(idx))
                yield make_test_batch(dataset, idx, bkt, scale=test_scale)

    dets = run_eval(detector, batches(), use_nms)
    return coco_map(dets, _groundtruth(dataset), num_classes, class_names)


def evaluate_teacher_and_student(state, dataset, **kw
                                 ) -> Dict[str, Dict[str, float]]:
    """`SubModulesDistEvalHook` parity: the student and, where the state
    has one, the EMA teacher, over the same dataset."""
    out = {"student": evaluate_detector(state.model, dataset, **kw)}
    if state.teacher is not None:
        out["teacher"] = evaluate_detector(state.teacher, dataset, **kw)
    return out
