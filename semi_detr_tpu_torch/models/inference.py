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
  (`SubModulesDistEvalHook`, `submodules_evaluation.py:71-101`);
* data parallel: rank r infers the eval batches i with i % W == r, and
  `gather_results` gives every rank the union (the JAX package's
  rank-sliced eval, `semi_detr_tpu/models/inference.py:135-175, 208-215`),
  so every rank scores the same detections.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from ..core import boxes as box_ops
from ..ops.nms import multiclass_nms
from ..parallel import dist


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


def _forward_decode(detector, images, img_hw, use_nms, max_dets):
    decode = decode_nms if use_nms else decode_topk
    out = detector(images, img_hw)
    return decode(out["cls"][-1], out["coord"][-1], img_hw, max_dets)


@torch.inference_mode()
def predict(detector, images, img_hw, use_nms: bool = False,
            max_dets: int = 300):
    """One forward and decode: (boxes, scores, labels) on the device.

    images: (B, H, W, 3) uint8 or normalized float; img_hw: (B, 2) int,
    both on the detector's device. Teacher and student go through this one
    function."""
    return _forward_decode(detector, images, img_hw, use_nms, max_dets)


class ServingProgram(torch.nn.Module):
    """`predict` as a module, the program `tools/export_model.py` exports
    with `torch.export` (at the batch and bucket of its example inputs, as
    the JAX export fixes them): forward(images, img_hw) -> (boxes, scores,
    labels)."""

    def __init__(self, detector, use_nms: bool = False, max_dets: int = 300):
        super().__init__()
        self.detector = detector
        self.use_nms, self.max_dets = use_nms, max_dets

    def forward(self, images, img_hw):
        return _forward_decode(self.detector, images, img_hw, self.use_nms,
                               self.max_dets)


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


def gather_results(results: Dict[int, Tuple], max_dets: int = 300
                   ) -> Dict[int, Tuple]:
    """All-gather per-image eval results across the ranks (the reference's
    `collect_results_gpu`, `detr_od/apis/test.py:152-191`, as the JAX
    package's one all-gather of padded fixed-shape arrays). Every rank
    passes its images' {image_id: (boxes, scores, labels)} and gets the
    union, merged in rank order (a later rank's entry for an id replaces an
    earlier one). A no-op without a process group."""
    if dist.backend() is None:
        return results
    dev = dist.collective_device()
    ids = sorted(results)
    m = int(dist.all_max(torch.tensor(len(ids), device=dev)))
    img_ids = np.full((m,), -1, np.int64)
    ndet = np.zeros((m,), np.int64)
    boxes = np.zeros((m, max_dets, 4), np.float32)
    scores = np.zeros((m, max_dets), np.float32)
    labels = np.zeros((m, max_dets), np.int32)
    for i, iid in enumerate(ids):
        b, s, lab = results[iid]
        k = min(len(s), max_dets)
        img_ids[i], ndet[i] = iid, k
        boxes[i, :k], scores[i, :k], labels[i, :k] = b[:k], s[:k], lab[:k]
    g = [dist.all_gather(torch.from_numpy(a).to(dev)).cpu().numpy()
         for a in (img_ids, ndet, boxes, scores, labels)]
    gi, gn, gb, gs, gl = g
    merged: Dict[int, Tuple] = {}
    for p in range(gi.shape[0]):
        for r in range(gi.shape[1]):
            if gi[p, r] >= 0:
                k = gn[p, r]
                merged[int(gi[p, r])] = (gb[p, r, :k], gs[p, r, :k],
                                         gl[p, r, :k])
    return merged


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
    same image id. The images are read, decoded and resized ahead by the
    host library's prefetch loader (`data.pipeline.prefetched_test_batches`)
    while the detector runs. Under data parallelism each rank infers every
    W-th batch and every rank scores the gathered union."""
    from ..data.coco_eval import coco_map
    from ..data.pipeline import prefetched_test_batches

    h, w = bucket
    land = (h, w) if w >= h else (w, h)
    flags = np.asarray(dataset.flags)
    groups = []
    for f, bkt in ((1, land), (0, (land[1], land[0]))):
        ids = np.nonzero(flags == f)[0]
        for s in range(0, len(ids), batch_size):
            idx = [int(i) for i in ids[s:s + batch_size]]
            groups.append((idx + [idx[-1]] * (batch_size - len(idx)), bkt))
    mine = groups[dist.rank()::dist.world()]
    dets = gather_results(run_eval(detector, prefetched_test_batches(
        dataset, mine, scale=test_scale), use_nms))
    return coco_map(dets, _groundtruth(dataset), num_classes, class_names)


def evaluate_teacher_and_student(state, dataset, **kw
                                 ) -> Dict[str, Dict[str, float]]:
    """`SubModulesDistEvalHook` parity: the student and, where the state
    has one, the EMA teacher, over the same dataset."""
    out = {"student": evaluate_detector(state.model, dataset, **kw)}
    if state.teacher is not None:
        out["teacher"] = evaluate_detector(state.teacher, dataset, **kw)
    return out
