"""Detection criterion: per-layer matching, DN and encoder losses.

Counterpart of `semi_detr_tpu/models/criterion.py`, which reproduces
`DINODETRSSODHead.loss / loss_single / loss_single_dn`
(`detr_od/models/dense_heads/dino_detr_ssod_head.py:508-884`):

* matching block: per decoder layer, Hungarian + focal loss after the
  warm-up, or O2M + task-aligned focal loss during it; the encoder's
  interim outputs get the same loss with class-agnostic (all-zero) labels
  (`:568-579`);
* dn block: targets by construction (positive chunks reconstruct their GT,
  negative chunks are background, `_get_target_single_dn :885-957`),
  zeroed when `warm_up and is_pseudo_label` (`:550-556`); images with no
  real GT add no dn loss;
* the reference returns loss_bbox / loss_bbox_xy / loss_bbox_hw as
  separate entries that mmcv sums, doubling the L1 weight; kept.

The avg factors are the global batch's, as in the JAX package's
global-view step: under data parallelism each rank's loss is its images'
sum over the global factor (`parallel.dist.all_sum`), so the ranks' losses
add up to the global batch's loss and their gradients to its gradient.
The loss keys are the JAX package's, letter for letter. After the warm-up,
the costs of all decoder layers and the encoder go to the host in one copy
and come back solved in one copy (`ops/hungarian.solve_batch`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..core import boxes as box_ops
from ..ops import hungarian
from ..parallel import dist
from . import assign, losses
from .dn import CdnBatch

CLS_W, L1_W, GIOU_W = 2.0, 5.0, 2.0
DN_KEYS = ("dn_loss_cls", "dn_loss_bbox", "dn_loss_iou", "dn_loss_bbox_xy",
           "dn_loss_bbox_hw")


def _grouped_cls_weights(num_pos_per_img, cls_group: Optional[int]):
    """Per-image loss scales for the reference's unsynced cls avg factor
    (sync_cls_avg_factor=False, dino_detr_ssod_head.py:86, :763-770): each
    group of `cls_group` consecutive images of the global batch stands for
    one reference GPU, normalized by its own positive count, and the
    per-GPU losses are averaged. Returns this rank's w (B,) with
    sum_i(l_i * w_i) == mean_g(sum_{i in g} l_i / max(pos_g, 1)) over the
    global batch, or None when cls_group is None/0 or does not divide the
    global batch (the caller keeps the global factor). A group that lies
    inside this rank's images needs only their counts; groups that span
    ranks take the global batch's counts."""
    if not cls_group:
        return None
    b = num_pos_per_img.shape[0]
    if (b * dist.world()) % cls_group != 0:
        return None
    n = b * dist.world() // cls_group
    if b % cls_group == 0:
        chunk = num_pos_per_img.reshape(-1, cls_group).sum(1).clamp(min=1.0)
        return (1.0 / (chunk * n)).repeat_interleave(cls_group)
    chunk = dist.all_cat(num_pos_per_img).reshape(n, cls_group).sum(
        1).clamp(min=1.0)
    return dist.rank_rows((1.0 / (chunk * n)).repeat_interleave(cls_group))


def _layer_loss(cls_scores, bbox_preds, gt, warm_up: bool, num_classes: int,
                prefix: str, cls_group: Optional[int] = None,
                cols: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """Loss of one decoder layer's matching block. cls_scores (B, Nq, K);
    bbox_preds (B, Nq, 4); gt: boxes (B,G,4) cxcywh-normalized, labels
    (B,G), valid (B,G). cols: (B, G) Hungarian solution (after warm-up)."""
    if warm_up:
        tg = assign.o2m_targets(cls_scores, bbox_preds, gt["boxes"],
                                gt["labels"], gt["valid"], num_classes)
    else:
        tg = assign.one_to_one_targets(cls_scores, bbox_preds, gt["boxes"],
                                       gt["labels"], gt["valid"],
                                       num_classes, cols)
    num_total_pos = dist.all_sum(tg.num_pos.sum())
    pred_xyxy = box_ops.cxcywh_to_xyxy(bbox_preds)
    tgt_xyxy = box_ops.cxcywh_to_xyxy(tg.bbox_targets)

    out = {}
    if warm_up:
        sum_metrics = dist.all_sum(tg.norm_metrics.sum()).clamp(min=1.0)
        out[f"{prefix}loss_cls"] = CLS_W * losses.task_aligned_focal_loss(
            cls_scores, tg.labels, tg.norm_metrics, tg.label_weights,
            sum_metrics, num_classes)
        reg_avg = dist.all_sum(tg.bbox_weights[..., 0].sum()).clamp(min=1.0)
    else:
        # default: the global positive count for both factors (official
        # DETR / sync_cls_avg_factor=True semantics, the JAX package's
        # default); cls_group opts into the reference's per-GPU factor
        gw = _grouped_cls_weights(tg.num_pos, cls_group)
        if gw is not None:
            out[f"{prefix}loss_cls"] = CLS_W * losses.sigmoid_focal_loss(
                cls_scores, tg.labels, tg.label_weights * gw[:, None], 1.0,
                num_classes)
        else:
            out[f"{prefix}loss_cls"] = CLS_W * losses.sigmoid_focal_loss(
                cls_scores, tg.labels, tg.label_weights,
                num_total_pos.clamp(min=1.0), num_classes)
        reg_avg = num_total_pos.clamp(min=1.0)

    out[f"{prefix}loss_iou"] = GIOU_W * losses.giou_loss(
        pred_xyxy, tgt_xyxy, tg.bbox_weights[..., 0], reg_avg)
    full, xy, hw = losses.l1_terms(bbox_preds, tg.bbox_targets,
                                   tg.bbox_weights, reg_avg)
    out[f"{prefix}loss_bbox"] = L1_W * full
    out[f"{prefix}loss_bbox_xy"] = L1_W * xy
    out[f"{prefix}loss_bbox_hw"] = L1_W * hw
    return out


def _dn_layer_loss(cls_scores, bbox_preds, gt, cdn: CdnBatch,
                   num_classes: int, prefix: str,
                   cls_group: Optional[int] = None) -> Dict[str, Any]:
    """DN loss of one decoder layer, targets from the CDN layout."""
    B, pad, _ = cls_scores.shape
    gt_idx = cdn.gt_idx.long()                            # (pad,)
    is_pos = cdn.is_positive                              # (pad,)
    # a real (not fake) gt at this slot?
    slot_real = gt["valid"][:, gt_idx] & ~cdn.pad_mask[:, None]

    labels = torch.where(is_pos[None] & slot_real, gt["labels"][:, gt_idx],
                         num_classes).long()
    # the reference trains every slot of the active prefix (background
    # where unfilled) with label weight 1; the inactive remainder gets 0
    active = (torch.ones_like(is_pos) if cdn.slot_active is None
              else cdn.slot_active)
    label_weights = ((~cdn.pad_mask)[:, None] & active[None]).float()

    pos_mask = (is_pos[None] & slot_real).float()
    bbox_targets = gt["boxes"][:, gt_idx] * pos_mask[..., None]
    bbox_weights = pos_mask[..., None].expand(B, pad, 4)

    num_total_pos = dist.all_sum(pos_mask.sum())
    reg_avg = num_total_pos.clamp(min=1.0)
    gw = _grouped_cls_weights(pos_mask.sum(1), cls_group)
    if gw is not None:
        dn_cls = CLS_W * losses.sigmoid_focal_loss(
            cls_scores, labels, label_weights * gw[:, None], 1.0,
            num_classes)
    else:
        dn_cls = CLS_W * losses.sigmoid_focal_loss(
            cls_scores, labels, label_weights, num_total_pos.clamp(min=1.0),
            num_classes)

    out = {
        f"{prefix}dn_loss_cls": dn_cls,
        f"{prefix}dn_loss_iou": GIOU_W * losses.giou_loss(
            box_ops.cxcywh_to_xyxy(bbox_preds),
            box_ops.cxcywh_to_xyxy(bbox_targets),
            bbox_weights[..., 0], reg_avg),
    }
    full, xy, hw = losses.l1_terms(bbox_preds, bbox_targets, bbox_weights,
                                   reg_avg)
    out[f"{prefix}dn_loss_bbox"] = L1_W * full
    out[f"{prefix}dn_loss_bbox_xy"] = L1_W * xy
    out[f"{prefix}dn_loss_bbox_hw"] = L1_W * hw
    return out


def detection_loss(outputs: Dict[str, Any], gt: Dict[str, Any],
                   num_classes: int, warm_up: bool,
                   is_pseudo_label: bool = False,
                   cls_group: Optional[int] = None) -> Dict[str, Any]:
    """The full DINO loss of `DINODetector.forward` outputs (with the CDN
    block). Returns the named losses plus 'total'.

    cls_group: opt-in reference-exact per-GPU cls avg factor, images per
    reference GPU (see _grouped_cls_weights); None keeps the global
    factor."""
    n_dec = outputs["cls"].shape[0]
    prefixes = ["" if lid == n_dec - 1 else f"d{lid}." for lid in
                range(n_dec)]
    # encoder interim loss with class-agnostic labels (reference :568-571)
    bin_gt = dict(gt, labels=torch.zeros_like(gt["labels"]))

    cols = [None] * (n_dec + 1)
    if not warm_up:
        # every head's costs to the host in one copy, solved there
        with torch.no_grad():
            costs = torch.stack(
                [assign.matching_cost(outputs["cls"][lid],
                                      outputs["coord"][lid], gt["boxes"],
                                      gt["labels"], gt["valid"])
                 for lid in range(n_dec)]
                + [assign.matching_cost(outputs["enc_cls"],
                                        outputs["enc_coord"], bin_gt["boxes"],
                                        bin_gt["labels"], bin_gt["valid"])])
            valid = gt["valid"][None].expand(n_dec + 1, -1, -1)
            cols = list(hungarian.solve_batch(costs, valid).unbind(0))

    out: Dict[str, Any] = {}
    for lid in range(n_dec):
        out.update(_layer_loss(outputs["cls"][lid], outputs["coord"][lid],
                               gt, warm_up, num_classes, prefixes[lid],
                               cls_group, cols[lid]))
    out.update(_layer_loss(outputs["enc_cls"], outputs["enc_coord"], bin_gt,
                           warm_up, num_classes, "enc_", cls_group,
                           cols[n_dec]))

    if "front_cls" in outputs and "cdn" in outputs:
        dev = outputs["cls"].device
        for lid in range(n_dec):
            if warm_up and is_pseudo_label:
                for k in DN_KEYS:
                    out[f"{prefixes[lid]}{k}"] = torch.zeros((), device=dev)
            else:
                out.update(_dn_layer_loss(
                    outputs["front_cls"][lid], outputs["front_coord"][lid],
                    gt, outputs["cdn"], num_classes, prefixes[lid],
                    cls_group))

    out["total"] = sum(v for k, v in out.items() if "loss" in k)
    return out
