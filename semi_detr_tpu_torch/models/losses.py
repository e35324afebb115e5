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


# The reference's registered losses that no live config selects
# (`semi_detr_tpu/models/losses.py:110-179`), for custom configs.

def _kl(log_q, t, eps: float = 1e-12):
    """torch F.kl_div(log_q, t) elementwise: t * (log t - log_q), with
    0 log 0 = 0."""
    return torch.where(t > 0, t * (torch.log(t.clamp(min=eps)) - log_q),
                       torch.zeros_like(t))


def softmax_focal_loss(logits, labels, gamma: float = 1.5,
                       class_weight=None, reduction: str = "sum"):
    """Multi-class focal loss over softmax cross entropy
    (`detr_od/models/losses/softmax_focal_loss.py:9-76`):
    (1 - exp(-CE))**gamma * CE. logits (N, K); labels (N,) int;
    reduction none | sum | mean."""
    logp = F.log_softmax(logits, -1)
    ce = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    if class_weight is not None:
        ce = ce * torch.as_tensor(class_weight, dtype=ce.dtype,
                                  device=ce.device)[labels.long()]
    loss = (1.0 - torch.exp(-ce)) ** gamma * ce
    if reduction == "none":
        return loss
    return loss.mean() if reduction == "mean" else loss.sum()


def binary_kl_div_loss(logits, target, binary: bool = False,
                       eps: float = 1e-12):
    """Per-box KL (or, with binary, symmetric JS over each class's
    Bernoulli) divergence between sigmoid scores and a soft target
    (`detr_od/models/losses/binary_kl_div_loss.py:14-82`). Returns (N,)."""
    p = torch.sigmoid(logits)
    if not binary:
        return _kl(torch.log(p + eps), target, eps).sum(-1)
    pb = torch.stack([p, 1.0 - p], -1)
    tb = torch.stack([target, 1.0 - target], -1)
    m = 0.5 * (pb + tb)
    loss = _kl(torch.log(pb + eps), m, eps) + _kl(torch.log(tb + eps), m,
                                                    eps)
    return 0.5 * loss.sum(-1).sum(-1)


def focal_kl_loss(logits, target, gamma: float = 0.5, weight=None,
                  avg_factor=None):
    """Focal-modulated symmetric binary KL
    (`detr_od/models/losses/soft_label_focal_loss.py:27-105`, use_sigmoid):
    KL(t || sigmoid) + KL(1 - t || 1 - sigmoid) per class, times
    ((t - sigmoid)^2 + 1e-6)**(gamma / 2); the mean, or the sum over
    avg_factor, with an optional per-box weight."""
    logp = F.logsigmoid(logits)
    logn = -logits + logp                       # log(1 - sigmoid)
    loss = _kl(logp, target) + _kl(logn, 1.0 - target)
    p = torch.sigmoid(logits)
    loss = ((target - p) ** 2 + 1e-6) ** (0.5 * gamma) * loss
    if weight is not None:
        loss = loss * weight.reshape(-1, 1)
    if avg_factor is not None:
        return loss.sum() / avg_factor
    return loss.mean()
