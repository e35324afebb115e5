"""Losses and matching costs: sigmoid focal, task-aligned focal, L1, GIoU.

Counterpart of the active part of `semi_detr_tpu/models/losses.py`, with
the reference's semantics:

* FocalLoss (mmdet sigmoid focal, alpha .25, gamma 2) — `loss_cls2` in
  `dino_detr_ssod_head.py:107-113`;
* TaskAlignedFocalLoss (`task_aligned_focal_loss.py:35-65`):
  |soft - p|^gamma * BCE(p, soft) with soft = metric * onehot, no alpha —
  `loss_cls1`;
* L1 on normalized cxcywh and GIoU. The reference also logs
  loss_bbox_xy / loss_bbox_hw as loss keys that mmcv sums into the total,
  so the effective L1 term is doubled; `l1_terms` reproduces that.

Every loss is mask/weight based; `avg_factor` follows mmdet's
weight_reduce_loss: sum(loss * weight) / max(avg_factor, 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import boxes as box_ops

# the reference's focal loss and FocalLossCost settings
ALPHA, GAMMA = 0.25, 2.0
COST_EPS = 1e-12


def _one_hot(labels, num_classes, dtype):
    """one_hot with num_classes (background) mapping to an all-zero row."""
    return F.one_hot(labels.long(), num_classes + 1)[..., :num_classes].to(
        dtype)


def _avg(avg_factor):
    if isinstance(avg_factor, torch.Tensor):
        return avg_factor.clamp(min=1.0)
    return max(float(avg_factor), 1.0)


def sigmoid_focal_loss(logits, labels, weight, avg_factor, num_classes: int):
    """logits (..., K); labels (...,) int, num_classes = background;
    weight (...,) per element. Returns sum / avg_factor."""
    onehot = _one_hot(labels, num_classes, logits.dtype)
    p = logits.sigmoid()
    ce = F.softplus(-logits) * onehot + F.softplus(logits) * (1 - onehot)
    pt = p * onehot + (1 - p) * (1 - onehot)
    alpha_t = ALPHA * onehot + (1 - ALPHA) * (1 - onehot)
    loss = alpha_t * (1 - pt) ** GAMMA * ce
    return (loss.sum(-1) * weight).sum() / _avg(avg_factor)


def task_aligned_focal_loss(logits, labels, metrics, weight, avg_factor,
                            num_classes: int):
    """logits (..., K) raw; labels int (bg = num_classes); metrics (...,)
    soft targets.

    The BCE comes from the logits through softplus: clipping the sigmoid
    cannot work in float32 (float32(1 - 1e-12) == 1.0, so a saturated
    logit would make log(1 - p) = -inf and NaN the whole loss)."""
    onehot = _one_hot(labels, num_classes, logits.dtype)
    soft = metrics[..., None] * onehot
    p = logits.sigmoid()
    # -log(p) = softplus(-x); -log(1 - p) = softplus(x)
    ce = soft * F.softplus(-logits) + (1 - soft) * F.softplus(logits)
    loss = (soft - p).abs() ** GAMMA * ce
    return (loss.sum(-1) * weight).sum() / _avg(avg_factor)


def l1_loss(pred, target, weight, avg_factor):
    """pred/target (..., D), weight (..., D) per coordinate."""
    return ((pred - target).abs() * weight).sum() / _avg(avg_factor)


def giou_loss(pred_xyxy, target_xyxy, weight, avg_factor):
    """weight (...,) per box."""
    g = box_ops.elementwise_giou(pred_xyxy, target_xyxy)
    return ((1.0 - g) * weight).sum() / _avg(avg_factor)


def l1_terms(pred, target, weight4, avg_factor):
    """(full, xy, hw) L1 terms; all three enter the total, as in the
    reference. full == xy + hw (disjoint coordinate slices)."""
    xy = l1_loss(pred[..., :2], target[..., :2], weight4[..., :2],
                 avg_factor)
    hw = l1_loss(pred[..., 2:], target[..., 2:], weight4[..., 2:],
                 avg_factor)
    return xy + hw, xy, hw


def focal_cost(logits, gt_labels):
    """mmdet FocalLossCost. logits (..., Nq, K); gt_labels (..., G) ->
    (..., Nq, G)."""
    p = logits.sigmoid()
    neg = -(1 - p + COST_EPS).log() * (1 - ALPHA) * p ** GAMMA
    pos = -(p + COST_EPS).log() * ALPHA * (1 - p) ** GAMMA
    cost = pos - neg                                          # (..., Nq, K)
    idx = gt_labels.long()[..., None, :].expand(
        *cost.shape[:-1], gt_labels.shape[-1])
    return torch.gather(cost, -1, idx)


def pair_l1_cost(pred_cxcywh, gt_cxcywh):
    """mmdet BBoxL1Cost (xywh): cdist p=1 -> (..., Nq, G)."""
    return (pred_cxcywh[..., :, None, :]
            - gt_cxcywh[..., None, :, :]).abs().sum(-1)


def giou_cost(pred_xyxy, gt_xyxy):
    return -box_ops.pairwise_giou(pred_xyxy, gt_xyxy)
