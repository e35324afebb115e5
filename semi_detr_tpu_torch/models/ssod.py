"""Semi-DETR teacher-student SSOD: pseudo labels, the GMM dual filter and
the consistency queries.

Counterpart of `semi_detr_tpu/models/ssod.py`, the reference's
`DinoDetrSSOD` (`detr_ssod/models/dino_detr_ssod.py:75-978`) in fixed
capacity: every image carries `max_pseudo` pseudo-box slots with a
validity mask, and the consistency block is a static budget of
`cons_groups * max_pseudo` query slots whose partition adapts to the batch.
The layouts are the JAX package's slot for slot, so the two packages build
the same queries from the same pseudo labels:

* `decode_pseudo_labels`: NMS of the teacher's last decoder layer, then the
  per-image mean + std score filter, compacted by score (a stable sort: the
  order of `jax.lax.top_k`);
* `pseudo_matching_costs`: the student's (no-grad) Hungarian cost per
  pseudo box, all images solved on the host in one copy;
* `dual_filter`: the supervision set (score) and the consistency set
  (score or GMM cost);
* `inject_fake_consistency_roi`, `consistency_partition`,
  `scatter_to_slots`, `consistency_positions`, `combined_attn_mask`: the
  consistency block, as in the JAX package's docstrings;
* `Projector`: RoI features -> consistency content queries, with the
  reference's parameter names and masked batch statistics;
* `consistency_loss`: per-layer MSE of L2-normalized embeddings, teacher
  detached.

Adaptive sizes (the partitions' group sizes) stay 0-d tensors on the
device, as in `models/dn.py`: building the block syncs nothing.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import boxes as box_ops
from ..ops import hungarian
from ..ops.nms import multiclass_nms
from . import losses
from .dino_head import DinoConfig
from .dn import dn_slot_groups, front_attn_mask
from .transformer import inverse_sigmoid


@dataclass(frozen=True)
class SsodConfig:
    dino: DinoConfig = field(default_factory=DinoConfig)
    # pseudo-label pipeline (reference train_cfg + head test_cfg)
    max_pseudo: int = 32            # per-image pseudo/consistency capacity
    nms_max_out: int = 300          # reference multiclass_nms max_num
    nms_iou: float = 0.6
    nms_score_thr: float = 0.01
    nms_pre_topk: int = 2000
    score_thr: float = 0.4          # pseudo_label_initial_score_thr
    unsup_weight: float = 4.0
    warm_up_step: int = 60000
    cons_groups: int = 5            # dn_number_1 (`dino_detr_ssod.py:533`)
    consistency_weight: float = 10.0
    ema_momentum: float = 0.999
    # the reference MeanTeacher hook's decay schedule
    # (`mean_teacher.py:52-57`); unused (empty) in every reference config
    ema_decay_intervals: tuple = ()
    ema_decay_factor: float = 0.1
    # opt-in reference-exact per-GPU cls avg factor (the reference runs
    # sync_cls_avg_factor=False): images per reference GPU for the (sup,
    # unsup) branches, the recipe's sample_ratio, e.g. (1, 4). None keeps
    # the global factor (the default)
    cls_avg_groups: Optional[tuple] = None

    @property
    def cons_pad(self) -> int:
        return self.cons_groups * self.max_pseudo


class PseudoLabels(NamedTuple):
    """Fixed-capacity per-image pseudo boxes in both frames."""
    boxes_t: torch.Tensor     # (B, P, 4) xyxy abs, teacher (weak) frame
    boxes_s: torch.Tensor     # (B, P, 4) xyxy abs, student (strong) frame
    labels: torch.Tensor      # (B, P) int64
    scores: torch.Tensor      # (B, P)
    valid: torch.Tensor       # (B, P) bool


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the real RoIs only (a (R,) weight mask), always with
    batch statistics: the reference runs its Projector only in training.
    Channels on axis 1; the statistics are biased, eps 1e-5."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, h, w, denom):
        axes = (0,) + tuple(range(2, h.dim()))
        wb = w.reshape((-1,) + (1,) * (h.dim() - 1))
        n = denom * math.prod(h.shape[2:])
        mean = (h * wb).sum(axes, keepdim=True) / n
        var = (((h - mean) ** 2) * wb).sum(axes, keepdim=True) / n
        shape = (1, -1) + (1,) * (h.dim() - 2)
        return ((h - mean) * torch.rsqrt(var + 1e-5)
                * self.weight.reshape(shape) + self.bias.reshape(shape))


class Projector(nn.Module):
    """RoI feature -> query-space adaptor (reference Projector,
    `dino_detr_ssod.py:33-72`): [conv3x3-BN-ReLU] x 2, flatten C*7*7 in NCHW
    order, fc 1024 + BN + ReLU, fc `features` + ReLU.

    Float32 throughout, whatever the detector's compute dtype: the JAX
    Projector's inputs are the float32 RoIAlign products and its layers
    promote to their float32 parameters."""

    def __init__(self, features: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn1 = MaskedBatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = MaskedBatchNorm(features)
        self.fc1 = nn.Linear(features * 7 * 7, 1024)
        self.bn = MaskedBatchNorm(1024)
        self.fc2 = nn.Linear(1024, features)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """The JAX Projector's initializers: xavier-uniform convs,
        lecun-normal (truncated at 2 std, std corrected by 0.8796) fc
        kernels, zero biases, unit BN scales. Draws on the CPU."""
        for conv in (self.conv1, self.conv2):
            rf = conv.weight[0, 0].numel()
            b = math.sqrt(6.0 / ((conv.in_channels + conv.out_channels) * rf))
            conv.weight.copy_(torch.empty(conv.weight.shape).uniform_(
                -b, b, generator=generator))
        for fc in (self.fc1, self.fc2):
            std = math.sqrt(1.0 / fc.in_features) / 0.87962566103423978
            fc.weight.copy_(nn.init.trunc_normal_(
                torch.empty(fc.weight.shape), 0.0, std, -2 * std, 2 * std,
                generator=generator))
            fc.bias.zero_()
        for bn in (self.bn1, self.bn2, self.bn):
            bn.weight.fill_(1.0)
            bn.bias.zero_()
        return self

    def forward(self, x, mask):
        """x: (R, C, 7, 7); mask: (R,) bool, the RoIs of the BN statistics.
        Returns (R, features) float32."""
        w = mask.float()
        denom = w.sum().clamp(min=1.0)
        h = F.relu(self.bn1(self.conv1(x.float()), w, denom))
        h = F.relu(self.bn2(self.conv2(h), w, denom))
        h = F.relu(self.bn(self.fc1(h.flatten(1)), w, denom))
        return F.relu(self.fc2(h))


# --------------------------------------------------------------------------
# pseudo labels (reference extract_teacher_info, :893-951)
# --------------------------------------------------------------------------

def decode_pseudo_labels(cls_logits, coords, img_hw, cfg: SsodConfig
                         ) -> PseudoLabels:
    """NMS decode + per-image mean + std score filter, fixed capacity.

    cls_logits: (B, nq, K) last decoder layer; coords: (B, nq, 4)
    normalized cxcywh; img_hw: (B, 2) valid extents. Returns PseudoLabels
    in the teacher frame (boxes_s a copy; the caller transforms)."""
    boxes = box_ops.cxcywh_to_xyxy(coords.float()).clamp(0.0, 1.0)
    scores = cls_logits.float().sigmoid()
    nms = [multiclass_nms(boxes[i], scores[i], cfg.nms_score_thr,
                          cfg.nms_iou, cfg.nms_max_out, cfg.nms_pre_topk)
           for i in range(boxes.shape[0])]
    v = torch.stack([d["valid"] for d in nms])
    s = torch.stack([d["scores"] for d in nms])
    nms_boxes = torch.stack([d["boxes"] for d in nms])
    nms_labels = torch.stack([d["labels"] for d in nms]).long()

    count = v.sum(1, keepdim=True)
    n = count.clamp(min=1)
    mean = torch.where(v, s, 0.0).sum(1, keepdim=True) / n
    # torch.std is unbiased: one survivor means no pseudo boxes
    var = torch.where(v, (s - mean) ** 2, 0.0).sum(1, keepdim=True) / (
        n - 1).clamp(min=1)
    keep = v & (s >= mean + var.sqrt()) & (count > 1)
    hw = img_hw.float()
    wh = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], -1)
    bx = nms_boxes * wh[:, None]
    # degenerate-box filter (zero width/height after scaling)
    keep = keep & ((bx[..., 2] - bx[..., 0]) > 0) & ((bx[..., 3] - bx[..., 1])
                                                     > 0)
    # compact to max_pseudo slots by score; dropped slots score -1, and the
    # stable sort breaks ties by index as jax.lax.top_k does
    sel = torch.where(keep, s, -1.0)
    order = torch.argsort(-sel, dim=1, stable=True)[:, :cfg.max_pseudo]
    top_s = torch.gather(sel, 1, order)
    boxes_t = torch.gather(bx, 1, order[..., None].expand(-1, -1, 4))
    return PseudoLabels(boxes_t, boxes_t, torch.gather(nms_labels, 1, order),
                        top_s.clamp(min=0.0), top_s > 0)


def transform_pseudo_to_student(pl: PseudoLabels, tmat_teacher, tmat_student,
                                student_hw) -> PseudoLabels:
    """M = T_student @ inv(T_teacher); transform and clip to the student
    image (reference `_get_trans_mat` / `_transform_bbox`, :804-811). A box
    that clips to zero area passes through, as in the reference."""
    m = tmat_student.float() @ torch.linalg.inv(tmat_teacher.float())
    boxes_s = box_ops.transform_boxes(pl.boxes_t, m)
    w = student_hw[:, 1:2].float()
    h = student_hw[:, 0:1].float()
    boxes_s = torch.stack([
        torch.minimum(boxes_s[..., 0].clamp(min=0.0), w),
        torch.minimum(boxes_s[..., 1].clamp(min=0.0), h),
        torch.minimum(boxes_s[..., 2].clamp(min=0.0), w),
        torch.minimum(boxes_s[..., 3].clamp(min=0.0), h)], -1)
    return pl._replace(boxes_s=boxes_s)


def normalize_boxes(boxes_xyxy, img_hw):
    """abs xyxy -> normalized cxcywh by the per-image valid extent."""
    w = img_hw[:, None, 1].float()
    h = img_hw[:, None, 0].float()
    return box_ops.xyxy_to_cxcywh(boxes_xyxy) / torch.stack([w, h, w, h], -1)


# --------------------------------------------------------------------------
# matching costs + GMM dual filter (reference unsup_loss, :229-353)
# --------------------------------------------------------------------------

@torch.no_grad()
def pseudo_matching_costs(cls_logits, bbox_preds, pl_boxes_norm, pl_labels,
                          pl_valid):
    """Per-pseudo-box matched Hungarian cost of the student's predictions:
    FocalLossCost x2 + L1 x5 + GIoU x2 (the reference sums the assigner2
    costs, :265-274). All images' (P, nq) problems go to the host in one
    copy (`hungarian.solve_batch`). Returns (B, P), 0 where invalid."""
    logits, preds = cls_logits.float(), bbox_preds.float()
    safe_labels = torch.where(pl_valid, pl_labels, 0)
    c_cls = losses.focal_cost(logits, safe_labels)              # (B, nq, P)
    c_l1 = losses.pair_l1_cost(preds, pl_boxes_norm)
    c_giou = losses.giou_cost(box_ops.cxcywh_to_xyxy(preds),
                              box_ops.cxcywh_to_xyxy(pl_boxes_norm))
    cost_t = (2.0 * c_cls + 5.0 * c_l1 + 2.0 * c_giou).transpose(1, 2)
    cols = hungarian.solve_batch(cost_t, pl_valid)               # (B, P)
    cols = torch.where(pl_valid, cols, 0)
    costs = torch.gather(cost_t, 2, cols[..., None])[..., 0]
    return torch.where(pl_valid, costs, 0.0)


def dual_filter(costs, scores, valid, gmm_thr: float, score_thr: float):
    """keep_sup = score filter (supervision / dn set, :336-343);
    keep_cons = GMM cost or score filter (consistency set, :332-348)."""
    keep_sup = valid & (scores >= score_thr)
    keep_cons = keep_sup | (valid & (costs <= gmm_thr))
    return keep_sup, keep_cons


# --------------------------------------------------------------------------
# consistency queries (reference prepare_unsup_cdn, :484-760)
# --------------------------------------------------------------------------

def inject_fake_consistency_roi(keep_cons, boxes_t, boxes_s, teacher_hw,
                                student_hw):
    """An image whose dual filter kept no pseudo box still contributes one
    fake center RoI [w/4, h/4, 3w/4, 3h/4] in slot 0 (reference :516-521,
    :575-581): it joins the Projector's batch statistics and holds a known
    slot with loss weight 0. Returns (keep_known, boxes_t', boxes_s')."""
    p = keep_cons.shape[1]
    empty = ~keep_cons.any(-1)
    fake = empty[:, None] & (torch.arange(p, device=keep_cons.device)
                             == 0)[None]

    def fake_box(hw):
        h, w = hw[:, 0].float(), hw[:, 1].float()
        return torch.stack([w / 4, h / 4, 3 * w / 4, 3 * h / 4], -1)

    boxes_t = torch.where(fake[..., None], fake_box(teacher_hw)[:, None],
                          boxes_t)
    boxes_s = torch.where(fake[..., None], fake_box(student_hw)[:, None],
                          boxes_s)
    return keep_cons | fake, boxes_t, boxes_s


def consistency_partition(packed_valid, cons_groups: int, capacity: int):
    """The adaptive consistency partition (reference single_pad_1 =
    max(known_num), :537): group size = the batch's largest kept count,
    clipped to [1, capacity // cons_groups]; `cons_groups` groups; slots
    past cons_groups * size are inactive.

    packed_valid: (B, P) prefix-packed kept mask. Returns (size () tensor,
    slot_idx (capacity,) slot -> packed pseudo index, slot weights
    (B, capacity) bool)."""
    size = packed_valid.sum(1).max().clamp(1, capacity // cons_groups)
    s = torch.arange(capacity, device=packed_valid.device)
    slot_idx = s % size
    active = s < cons_groups * size
    return size, slot_idx, packed_valid[:, slot_idx] & active[None]


def scatter_to_slots(packed, slot_idx, slot_weights):
    """Packed per-pseudo rows (B, P, ...) -> the consistency slot layout
    (B, capacity, ...): slot s takes row slot_idx[s]; weight-0 slots are 0."""
    slots = packed[:, slot_idx]
    w = slot_weights.reshape(slot_weights.shape + (1,) * (packed.dim() - 2))
    return torch.where(w, slots, 0.0)


def consistency_positions(packed_boxes_xyxy_abs, img_hw, slot_weights,
                          slot_idx):
    """(B, P, 4) packed abs boxes -> (B, capacity, 4) unsigmoided positions
    in the slot layout; weight-0 slots 0 (the reference's zero padding)."""
    norm = normalize_boxes(packed_boxes_xyxy_abs, img_hw).clamp(0.0, 1.0)
    return scatter_to_slots(inverse_sigmoid(norm), slot_idx, slot_weights)


def combined_attn_mask(cons_pad: int, cons_groups: int, dn_single_pad,
                       dn_groups, num_queries: int, dn_capacity: int,
                       cons_single_pad):
    """The [consistency | dn | matching] self-attention mask, True = blocked
    (reference :722-743): each consistency group and each dn group sees only
    itself among the front blocks; matching sees only matching.

    dn_single_pad / dn_groups: the CDN partition (ints or 0-d tensors) in
    `dn_capacity` static slots. cons_single_pad: the adaptive consistency
    group size (`consistency_partition`); slots past cons_groups * size get
    unique isolated ids."""
    device = None
    for t in (cons_single_pad, dn_single_pad):
        if isinstance(t, torch.Tensor):
            device = t.device
    s = torch.arange(cons_pad, device=device)
    chunk = torch.div(s, cons_single_pad, rounding_mode="floor")
    # inactive ids start past every shifted dn id (< 1.5 * dn_capacity)
    cons_group = torch.where(chunk < cons_groups, chunk,
                             cons_groups + 2 * dn_capacity + s)
    dn_group = cons_groups + dn_slot_groups(dn_single_pad, dn_groups,
                                            dn_capacity, device)
    return front_attn_mask(torch.cat([cons_group, dn_group]), num_queries)


def consistency_loss(hs_student, hs_teacher, cons_weights, cons_counts,
                     cfg: SsodConfig, weight: float):
    """Per-decoder-layer MSE of L2-normalized consistency embeddings,
    teacher detached, x weight (reference :472-481).

    hs_*: (n_dec, B, cons_pad, C); cons_weights: (B, cons_pad) per-slot
    weights; cons_counts: (B,) known slots per image (>= 1: an empty image's
    fake slot enters the denominator). Float32 losses."""
    n_dec, _, _, c = hs_student.shape
    w = cons_weights.float()
    denom = (cons_counts.sum() * cfg.cons_groups * c).float().clamp(min=1.0)

    def unit(h):
        return h / torch.linalg.vector_norm(h, dim=-1, keepdim=True).clamp(
            min=1e-12)

    se = ((unit(hs_student) - unit(hs_teacher).detach()) ** 2).float() * w[
        None, :, :, None]
    return {f"consis_loss.d{lid}": weight * se[lid].sum() / denom
            for lid in range(n_dec)}
