"""Pseudo-sampler equivalents over boolean masks.

Counterpart of `semi_detr_tpu/core/samplers.py`: the reference's two
"samplers that do not sample" (`detr_od/core/bbox/samplers/`),
`IgnorePseudoSampler` (`ignore_sampler.py:10-46`: positive / negative /
ignored predictions from an assigner's `gt_inds`, >0 / ==0 / <0) and
`DoubleSampler` (`double_sampler.py:10-49`: the same for two
assignments). The masks lie over the fixed prediction axis, with the
gathered ground truth zeroed where a prediction is not positive, as the
JAX package keeps them (no ragged index sets). The live configs use
mmdet's plain `PseudoSampler`; these are for experiments that need the
bookkeeping.

Like the JAX package, a gt_bboxes with zero rows is not handled (its
gather has no row to clamp to; the reference's
`ignore_sampling_result.py:41-44` handles it).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SamplingMasks(NamedTuple):
    """pos / neg / ign: (N,) bool, a partition of the predictions;
    pos_assigned_gt_inds (N,) (0 where not positive); pos_gt_bboxes
    (N, 4) (0 where not positive); pos_gt_labels (N,) (-1 where not
    positive) or None."""
    pos: torch.Tensor
    neg: torch.Tensor
    ign: torch.Tensor
    pos_assigned_gt_inds: torch.Tensor
    pos_gt_bboxes: torch.Tensor
    pos_gt_labels: Optional[torch.Tensor]

    @property
    def num_pos(self):
        return self.pos.sum()


class DoubleSamplingMasks(NamedTuple):
    """Two partitions over one prediction set; the gathered boxes follow
    assignment 1 (`double_sampling_result.py:34-53`)."""
    pos_1: torch.Tensor
    neg_1: torch.Tensor
    pos_2: torch.Tensor
    neg_2: torch.Tensor
    pos_assigned_gt_inds_1: torch.Tensor
    pos_assigned_gt_inds_2: torch.Tensor
    pos_gt_bboxes: torch.Tensor
    pos_gt_labels_1: Optional[torch.Tensor]
    pos_gt_labels_2: Optional[torch.Tensor]


def _gathered_gt(gt_inds, gt_bboxes, pos):
    """The matched gt row (gt_inds - 1) and its box per positive
    prediction, zeros elsewhere."""
    assigned = (gt_inds - 1).clamp(min=0)
    g = assigned.clamp(0, max(gt_bboxes.shape[0] - 1, 0))
    boxes = gt_bboxes[g] * pos[:, None].to(gt_bboxes.dtype)
    return assigned * pos.to(assigned.dtype), boxes


def _labels(pos, labels):
    return None if labels is None else torch.where(
        pos, labels, torch.full_like(labels, -1))


def ignore_sampling_masks(gt_inds, gt_bboxes, labels=None) -> SamplingMasks:
    """`IgnorePseudoSampler.sample` (`ignore_sampler.py:24-46`): gt_inds
    (N,) int, >0 positive (gt row + 1), 0 negative, <0 ignored; gt_bboxes
    (G, 4); labels (N,) optional assigned labels."""
    pos = gt_inds > 0
    assigned, boxes = _gathered_gt(gt_inds, gt_bboxes, pos)
    return SamplingMasks(pos, gt_inds == 0, gt_inds < 0, assigned, boxes,
                         _labels(pos, labels))


def double_sampling_masks(gt_inds_1, gt_inds_2, gt_bboxes, labels_1=None,
                          labels_2=None) -> DoubleSamplingMasks:
    """`DoubleSampler.sample` (`double_sampler.py:24-49`): two assignments
    over the same N predictions (e.g. one-to-one and one-to-many)."""
    pos_1, pos_2 = gt_inds_1 > 0, gt_inds_2 > 0
    a1, boxes = _gathered_gt(gt_inds_1, gt_bboxes, pos_1)
    a2 = (gt_inds_2 - 1).clamp(min=0) * pos_2.to(gt_inds_2.dtype)
    return DoubleSamplingMasks(
        pos_1, gt_inds_1 == 0, pos_2, gt_inds_2 == 0, a1, a2, boxes,
        _labels(pos_1, labels_1), _labels(pos_2, labels_2))
