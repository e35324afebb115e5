"""Contrastive denoising (CDN) queries: a static slot budget whose
partition adapts to the batch.

Counterpart of `semi_detr_tpu/models/dn.py`, with its layout slot for
slot. Reference `prepare_for_cdn_plus`
(`detr_od/models/dense_heads/dn_components.py:128-275`): single_pad = the
batch's largest GT count, groups = budget // (2 * single_pad). Here the
slot count is fixed, `capacity = 2 * dn_single_pad * dn_groups` (the
reference's 2 * dn_number), and the partition of those slots is computed
per batch, as 0-d tensors on the device:

    single_pad = min(max GT count in the batch, capacity // 2, G)
    groups     = capacity // (2 * single_pad)
    slot s -> chunk = s // single_pad, gt = s % single_pad
    active slots: chunk < 2 * groups

Within the active prefix, chunks (2g, 2g+1) hold the positives and the
negatives of group g, and slot j of a chunk holds GT j. An image with no
GT gets the reference's fake box [.5, .5, .5, .5] with a random label in
slot 0, masked out of the loss by `pad_mask`.

Noise (reference `:193-223`): a label is redrawn uniformly with
probability label_noise_ratio / 2; box corners move by
sign * u * half-extent * box_noise_scale, u in [0, 1) for positives and
[1, 2) for negatives, then clamp to [0, 1]. The random numbers come from
one `torch.Generator` (`draw_cdn_noise`), so a run is reproducible from
its seed; `build_cdn_queries` is a plain function of them.

Data parallel: the batch is the global batch of the JAX package's step. Each
rank draws the noise of all W * B images from the shared (seed, step)
generator and keeps its rows, and single_pad is the largest GT count over
all ranks (`parallel.dist.all_max`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..parallel import dist
from .transformer import inverse_sigmoid


class CdnBatch(NamedTuple):
    query_label: torch.Tensor   # (B, capacity, C) content queries
    query_bbox: torch.Tensor    # (B, capacity, 4) unsigmoided positions
    gt_idx: torch.Tensor        # (capacity,) slot -> gt index
    is_positive: torch.Tensor   # (capacity,) True in active positive chunks
    slot_valid: torch.Tensor    # (B, capacity) slot holds a (real/fake) gt
    pad_mask: torch.Tensor      # (B,) True = image had no real gt (fake dn)
    slot_active: Optional[torch.Tensor] = None  # (capacity,)
    single_pad: Optional[torch.Tensor] = None   # () per-batch single_pad
    groups: Optional[torch.Tensor] = None       # () per-batch groups


class CdnNoise(NamedTuple):
    """The random numbers of one CDN draw, in the JAX package's order."""
    fake_label: torch.Tensor    # (B,) label of the fake gt, in [0, K)
    relabel_u: torch.Tensor     # (B, capacity) uniform [0, 1)
    new_label: torch.Tensor     # (B, capacity) redrawn label, in [0, K)
    sign: torch.Tensor          # (B, capacity, 4) +-1.0
    part: torch.Tensor          # (B, capacity, 4) uniform [0, 1)


def draw_cdn_noise(generator: torch.Generator, batch: int, capacity: int,
                   num_classes: int, device) -> CdnNoise:
    """Draw one step's CDN noise from `generator` (on `device`) for this
    rank's `batch` images: the global batch's draw, this rank's rows."""
    g, dev, n = generator, device, batch * dist.world()
    noise = CdnNoise(
        fake_label=torch.randint(0, num_classes, (n,), generator=g,
                                 device=dev),
        relabel_u=torch.rand((n, capacity), generator=g, device=dev),
        new_label=torch.randint(0, num_classes, (n, capacity),
                                generator=g, device=dev),
        sign=torch.randint(0, 2, (n, capacity, 4), generator=g,
                           device=dev).float() * 2.0 - 1.0,
        part=torch.rand((n, capacity, 4), generator=g, device=dev))
    return CdnNoise(*map(dist.rank_rows, noise))


def dn_slot_groups(single_pad, groups, capacity: int, device=None):
    """Slot -> dn group id under the adaptive partition. Active slots map
    pos/neg chunk pairs to group chunk // 2; inactive slots get unique ids
    >= groups (fully isolated). single_pad/groups: ints or 0-d tensors."""
    if isinstance(single_pad, torch.Tensor):
        device = single_pad.device
    s = torch.arange(capacity, device=device)
    chunk = torch.div(s, single_pad, rounding_mode="floor")
    active = chunk < 2 * groups
    return torch.where(active, torch.div(chunk, 2, rounding_mode="floor"),
                       groups + s)


def front_attn_mask(front_group: torch.Tensor, num_queries: int):
    """The [front | matching] self-attention mask, True = blocked: front
    slot i sees front slot j iff group[i] == group[j]; matching sees only
    matching; front also sees all of matching."""
    front = front_group.shape[0]
    dev = front_group.device
    block = front_group[:, None] != front_group[None, :]
    top = torch.cat(
        [block, torch.zeros((front, num_queries), dtype=torch.bool,
                            device=dev)], 1)
    bottom = torch.cat(
        [torch.ones((num_queries, front), dtype=torch.bool, device=dev),
         torch.zeros((num_queries, num_queries), dtype=torch.bool,
                     device=dev)], 1)
    return torch.cat([top, bottom], 0)


def cdn_attn_mask(single_pad, groups, num_queries: int,
                  capacity: Optional[int] = None, device=None):
    """Self-attention mask over [dn | matching], True = blocked (reference
    `:246-257`). capacity defaults to 2*single_pad*groups (int args)."""
    if capacity is None:
        capacity = 2 * int(single_pad) * int(groups)
    return front_attn_mask(dn_slot_groups(single_pad, groups, capacity,
                                          device), num_queries)


def pack_order(valid: torch.Tensor) -> torch.Tensor:
    """Stable valid-first permutation along axis 1."""
    return torch.argsort((~valid).to(torch.int8), dim=1, stable=True)


def compact_gt(boxes, labels, valid, order: Optional[torch.Tensor] = None):
    """Prefix-pack a scattered GT set: valid entries move to the front (in
    stable order) and invalid slots are zeroed. `build_cdn_queries` assumes
    prefix-packed validity."""
    if order is None:
        order = pack_order(valid)
    v = torch.gather(valid, 1, order)
    b = torch.where(v[..., None],
                    torch.gather(boxes, 1, order[..., None].expand(
                        -1, -1, boxes.shape[-1])), 0.0)
    l = torch.where(v, torch.gather(labels, 1, order), 0)
    return b, l, v


def build_cdn_queries(noise: CdnNoise, gt_boxes: torch.Tensor,
                      gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                      label_enc: torch.Tensor, num_classes: int,
                      single_pad: int, groups: int,
                      label_noise_ratio: float = 0.5,
                      box_noise_scale: float = 0.4) -> CdnBatch:
    """The CDN block for one batch.

    noise: `draw_cdn_noise(generator, B, 2*single_pad*groups, K, device)`.
    gt_boxes (B, G, 4) normalized cxcywh; gt_labels (B, G) int in [0, K);
    gt_valid (B, G) bool, prefix-packed (see `compact_gt`); label_enc
    (dn_labelbook_size+1, C), looked up differentiably. single_pad,
    groups: the static slot budget, 2*single_pad*groups slots.
    """
    B, G = gt_valid.shape
    capacity = 2 * single_pad * groups
    dev = gt_boxes.device

    # fake gt for images with no gt (reference `:141-160`)
    no_gt = ~gt_valid.any(1)                                    # (B,)
    inject = no_gt[:, None] & (torch.arange(G, device=dev) == 0)[None]
    fake_box = torch.full((4,), 0.5, device=dev)
    boxes = torch.where(inject[..., None], fake_box, gt_boxes)
    labels = torch.where(inject, noise.fake_label[:, None].to(
        gt_labels.dtype), gt_labels)
    valid = gt_valid | inject

    # adaptive partition (reference `:164-180`), over the global batch
    counts = valid.sum(1)                                        # >= 1
    sp = dist.all_max(counts.max()).clamp(1, min(capacity // 2, G))
    n_groups = torch.div(capacity, 2 * sp, rounding_mode="floor")

    s = torch.arange(capacity, device=dev)
    chunk = torch.div(s, sp, rounding_mode="floor")
    gt_idx = s % sp                                              # (cap,)
    active = chunk < 2 * n_groups
    is_neg = chunk % 2 == 1
    is_positive = ~is_neg & active

    boxes_s = boxes[:, gt_idx]                                   # (B,cap,4)
    labels_s = labels[:, gt_idx]
    slot_valid = valid[:, gt_idx] & active[None]

    # label noise, the same for positive and negative chunks
    labels_s = torch.where(noise.relabel_u < label_noise_ratio * 0.5,
                           noise.new_label.to(labels_s.dtype), labels_s)

    # box noise in corner coordinates (reference `:206-223`)
    xy, wh = boxes_s[..., :2], boxes_s[..., 2:]
    corners = torch.cat([xy - wh / 2, xy + wh / 2], -1)
    diff = torch.cat([wh / 2, wh / 2], -1)
    part = noise.part + is_neg[None, :, None].float()
    noised = (corners + noise.sign * part * diff
              * box_noise_scale).clamp(0.0, 1.0)
    lo, hi = noised[..., :2], noised[..., 2:]
    noised_cxcywh = torch.cat([(lo + hi) / 2, hi - lo], -1)

    content = label_enc[labels_s.long()]                        # (B,cap,C)
    position = inverse_sigmoid(noised_cxcywh)
    keep = slot_valid[..., None]
    return CdnBatch(
        query_label=torch.where(keep, content, 0.0),
        query_bbox=torch.where(keep, position, 0.0),
        gt_idx=gt_idx,
        is_positive=is_positive,
        slot_valid=slot_valid,
        pad_mask=no_gt,
        slot_active=active,
        single_pad=sp,
        groups=n_groups,
    )
