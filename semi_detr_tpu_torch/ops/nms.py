"""Class-wise multiclass NMS with fixed-size outputs.

Counterpart of `semi_detr_tpu/ops/nms.py` (mmdet `multiclass_nms` as the
reference's warm-up / pseudo-label decode uses it): sigmoid scores per
class, score_thr 0.01, class-wise greedy NMS at IoU 0.6, keep the top
`max_out` by score. Classes are separated by the coordinate-offset trick so
one greedy pass handles all of them. Candidates are the top `pre_topk` of
the flattened (num_boxes * num_classes) scores.

Suppression is the exact greedy result, computed as the fixpoint of

    keep[j] = alive[j] and not any(i < j and keep[i] and iou[i,j] > thr)

over candidates in descending score order: each sweep is one (k, k) masked
reduction, and the loop ends when keep stops changing (the longest
suppression chain, single digits on real detections). Eagerly the loop
is Python's, ending on `torch.equal`; under `torch.export` the same sweeps
run in a `while_loop` (the JAX package's `lax.while_loop`), which the
exported program carries with its data-dependent end.
"""
from __future__ import annotations

import torch

from ..core import boxes as box_ops


def multiclass_nms(boxes_xyxy: torch.Tensor, scores: torch.Tensor,
                   score_thr: float = 0.01, iou_thr: float = 0.6,
                   max_out: int = 300, pre_topk: int = 1500):
    """Args:
      boxes_xyxy: (N, 4) boxes shared across classes (DETR decode).
      scores: (N, C) per-class sigmoid scores.

    Returns dict of (max_out,)-leading tensors sorted by descending score:
      boxes (max_out, 4), scores, labels int32, box_idx int32 (row of the
      input boxes), valid bool.
    """
    n, c = scores.shape
    k = min(pre_topk, n * c)
    top_scores, top_idx = torch.topk(scores.reshape(-1), k)
    box_idx = top_idx // c
    labels = (top_idx % c).to(torch.int32)
    cand = boxes_xyxy[box_idx]                              # (k, 4)
    alive = top_scores > score_thr

    # disjoint coordinate bands per class; shifting by -min keeps negative
    # (unclipped) coordinates out of the previous class's band
    lo = torch.clamp(boxes_xyxy.min(), max=0.0)
    extent = boxes_xyxy.max() - lo + 1.0
    cand_off = cand + (labels.to(cand.dtype)[:, None] * extent - lo)

    iou = box_ops.pairwise_iou(cand_off, cand_off)          # (k, k)
    # overlap[j, i]: higher-scored i would suppress j if kept
    idx = torch.arange(k, device=scores.device)
    overlap = (iou > iou_thr) & (idx[None, :] < idx[:, None])

    keep = _fixpoint(alive, overlap)

    sel_scores = torch.where(keep, top_scores, torch.full_like(top_scores,
                                                               -1.0))
    order = torch.argsort(-sel_scores, stable=True)[:max_out]
    return {
        "boxes": cand[order],
        "scores": sel_scores[order].clamp(min=0.0),
        "labels": labels[order],
        "box_idx": box_idx[order].to(torch.int32),
        "valid": keep[order] & (sel_scores[order] > 0),
    }


def _fixpoint(alive, overlap):
    """The greedy keep set: sweeps of keep = alive & ~any(overlap & keep)
    from keep = alive until a sweep changes nothing (at most k sweeps)."""
    k = alive.shape[0]
    if torch.compiler.is_exporting():
        from torch._higher_order_ops.while_loop import while_loop

        def cond(i, keep, changed):
            return changed & (i < k)

        def body(i, keep, changed):
            new = alive & ~(overlap & keep[None, :]).any(1)
            return i + 1, new, (new != keep).any()

        # the carried keep starts as a copy: a tensor that is both a
        # carried input and one the body reads is an alias AOTInductor
        # refuses
        start = (torch.zeros((), dtype=torch.int64, device=alive.device),
                 alive.clone(),
                 torch.ones((), dtype=torch.bool, device=alive.device))
        return while_loop(cond, body, start)[1]
    keep = alive
    for _ in range(k):
        new = alive & ~(overlap & keep[None, :]).any(1)
        if torch.equal(new, keep):
            break
        keep = new
    return keep
