"""Target assignment: Hungarian one-to-one and TOOD-style one-to-many.

Counterpart of `semi_detr_tpu/models/assign.py`, batched over images
(the JAX package vmaps a per-image function):

* mmdet HungarianAssigner with FocalLossCost(2.0) + BBoxL1Cost(5.0, xywh)
  + IoUCost(giou, 2.0), the post-warm-up branch of `_get_target_single`
  (`dino_detr_ssod_head.py:1188-1207`). The costs are built on the device
  and solved on the host (`ops/hungarian.py`).
* `O2MAssigner` (`o2m_assigner.py:17-170`): alignment score^alpha *
  IoU^beta (alpha 1, beta 6), top-13 candidates per GT, conflicts resolved
  by the largest IoU, and the per-GT normalization of the warm-up branch
  (`dino_detr_ssod_head.py:1148-1162`) as a masked max per GT.

Boxes are cxcywh normalized to each image's valid extent; IoU and GIoU do
not change under the per-axis scaling, so matching in normalized
coordinates equals the reference's matching in pixels. Targets carry no
gradient.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import boxes as box_ops
from ..ops import hungarian
from . import losses

INF = 1e8
# HungarianAssigner cost weights (focal, L1, GIoU) and the O2MAssigner's
# top-k, alpha and beta, as the reference configures them
CLS_COST_W, L1_COST_W, GIOU_COST_W = 2.0, 5.0, 2.0
O2M_TOPK, O2M_ALPHA, O2M_BETA = 13, 1.0, 6.0


class Targets(NamedTuple):
    labels: torch.Tensor          # (B, Nq) int64, num_classes = background
    label_weights: torch.Tensor   # (B, Nq)
    bbox_targets: torch.Tensor    # (B, Nq, 4) normalized cxcywh
    bbox_weights: torch.Tensor    # (B, Nq, 4)
    norm_metrics: torch.Tensor    # (B, Nq) TOOD normalized alignment
    num_pos: torch.Tensor         # (B,) float


@torch.no_grad()
def matching_cost(cls_logits, bbox_pred, gt_boxes, gt_labels, gt_valid
                  ) -> torch.Tensor:
    """Hungarian cost (B, G, Nq) of cls_logits (B, Nq, K), bbox_pred
    (B, Nq, 4) against gt_boxes (B, G, 4), gt_labels / gt_valid (B, G)."""
    safe_labels = torch.where(gt_valid, gt_labels, 0)
    c_cls = losses.focal_cost(cls_logits, safe_labels)           # (B,Nq,G)
    c_l1 = losses.pair_l1_cost(bbox_pred, gt_boxes)
    c_giou = losses.giou_cost(box_ops.cxcywh_to_xyxy(bbox_pred),
                              box_ops.cxcywh_to_xyxy(gt_boxes))
    return (CLS_COST_W * c_cls + L1_COST_W * c_l1
            + GIOU_COST_W * c_giou).transpose(1, 2)


@torch.no_grad()
def one_to_one_targets(cls_logits, bbox_pred, gt_boxes, gt_labels, gt_valid,
                       num_classes: int,
                       cols: Optional[torch.Tensor] = None) -> Targets:
    """Hungarian targets. cols: (B, G) matched query per GT (-1 for an
    invalid GT), e.g. from one `hungarian.solve_batch` over several heads;
    None solves this head's costs here."""
    B, nq = cls_logits.shape[:2]
    if cols is None:
        cols = hungarian.solve_batch(
            matching_cost(cls_logits, bbox_pred, gt_boxes, gt_labels,
                          gt_valid), gt_valid)
    dev = bbox_pred.device
    # an invalid GT writes to the extra column nq, dropped below
    cols = torch.where(gt_valid, cols, nq)
    b_idx = torch.arange(B, device=dev)[:, None].expand_as(cols)
    labels = torch.full((B, nq + 1), num_classes, dtype=torch.int64,
                        device=dev)
    labels[b_idx, cols] = gt_labels.long()
    bbox_targets = torch.zeros((B, nq + 1, 4), dtype=bbox_pred.dtype,
                               device=dev)
    bbox_targets[b_idx, cols] = gt_boxes.to(bbox_pred.dtype)
    bbox_weights = torch.zeros_like(bbox_targets)
    bbox_weights[b_idx, cols] = 1.0
    return Targets(labels[:, :nq], torch.ones((B, nq), device=dev),
                   bbox_targets[:, :nq], bbox_weights[:, :nq],
                   torch.zeros((B, nq), device=dev),
                   gt_valid.sum(1).float())


@torch.no_grad()
def o2m_targets(cls_logits, bbox_pred, gt_boxes, gt_labels, gt_valid,
                num_classes: int) -> Targets:
    """TOOD one-to-many targets (warm-up stage)."""
    B, nq = cls_logits.shape[:2]
    g = gt_boxes.shape[1]
    topk = min(O2M_TOPK, nq)
    score = cls_logits.sigmoid()                                 # (B,Nq,K)
    safe_labels = torch.where(gt_valid, gt_labels, 0).long()
    iou = box_ops.pairwise_iou(box_ops.cxcywh_to_xyxy(bbox_pred),
                               box_ops.cxcywh_to_xyxy(gt_boxes))  # (B,Nq,G)
    bbox_scores = torch.gather(score, 2, safe_labels[:, None].expand(
        B, nq, g))
    align = bbox_scores ** O2M_ALPHA * iou ** O2M_BETA
    align = torch.where(gt_valid[:, None], align, 0.0)

    # top-k candidate queries per gt. Candidates whose alignment is 0 are
    # masked out below (align > 0), so however topk breaks ties among
    # zeros, the targets are the same.
    cand_idx = align.transpose(1, 2).topk(topk, dim=-1).indices  # (B,G,k)
    cand = torch.zeros((B, g, nq), dtype=torch.bool, device=align.device)
    cand.scatter_(2, cand_idx, True)
    is_pos = cand.transpose(1, 2) & (align > 0) & gt_valid[:, None]

    # conflict resolution: a query keeps the candidate gt of largest IoU
    # (argmax returns the first of equal maxima, as jnp.argmax does)
    iou_masked = torch.where(is_pos, iou, -INF)
    assigned = iou_masked.argmax(-1)                             # (B, Nq)
    has = iou_masked.amax(-1) > -INF

    a_metric = torch.where(has, torch.gather(align, 2, assigned[..., None])
                           [..., 0], 0.0)
    onehot = torch.nn.functional.one_hot(assigned, g).bool() & has[..., None]
    # per-gt instance normalization (max over the queries assigned to it)
    m_max = torch.where(onehot, align, -INF).amax(1)             # (B, G)
    i_max = torch.where(onehot, iou, -INF).amax(1)
    norm = (a_metric / (torch.gather(m_max, 1, assigned) + 1e-7)
            * torch.gather(i_max, 1, assigned))
    norm = torch.where(has, norm, 0.0)

    labels = torch.where(has, torch.gather(gt_labels.long(), 1, assigned),
                         num_classes)
    bbox_targets = torch.where(
        has[..., None],
        torch.gather(gt_boxes, 1, assigned[..., None].expand(B, nq, 4)),
        0.0)
    bbox_weights = torch.where(has[..., None],
                               norm[..., None].expand(B, nq, 4), 0.0)
    return Targets(labels, torch.ones((B, nq), device=align.device),
                   bbox_targets, bbox_weights, norm, has.sum(1).float())
