"""The Semi-DETR SSOD train step: one teacher-student iteration.

Counterpart of `semi_detr_tpu/train/ssod.py:make_ssod_train_step`, the
reference's hot loop (`detr_ssod/models/dino_detr_ssod.py`): the EMA of the
teacher, the supervised DINO loss, then the unlabeled branch:

1. teacher (no grad): encoder once, matching decode, NMS + mean + std
   pseudo labels, carried into the student view (`ssod.teacher`,
   `ssod.pseudo_labels`);
2. student: encoder once; a no-grad matching decode prices each pseudo box
   (Hungarian on the host), and a GMM over the batch's cost pool gives the
   threshold of the dual filter (`ssod.student`, `ssod.gmm`);
3. warm-up only: RoIAlign of the teacher's features at the kept boxes, the
   Projector, and the consistency block prepended to the CDN block
   (`ssod.consistency`); after the warm-up the block is skipped (the
   reference zeroes its loss; the attention mask keeps it from every other
   query, so skipping it changes nothing else);
4. student training decode and `detection_loss(is_pseudo_label=True)` on
   the supervision set; in warm-up the teacher decodes the same content
   queries at teacher-frame positions with its own CDN block, and the
   consistency loss compares the two;
5. backward, global-norm clip and AdamW over the detector and the
   projector.

The supervised and the unlabeled losses go backward one after the other
(their gradients add, as the JAX package's one gradient of their sum), so
the supervised graph is freed before the unlabeled forward. The JAX
package's two fault-isolation switches (SDT_FUSED_ENCODE,
SDT_FAKE_CONS_ROI) are fixed at their defaults: two encodes, the fake RoI
on.

Randomness: the three CDN draws of a step (supervised, unlabeled student,
unlabeled teacher) come from a generator seeded by (seed, step), or from
the caller as three prebuilt `CdnNoise`s.

Spans (`torch.profiler.record_function`): train.ema, train.forward_loss,
train.backward, train.optimizer, ssod.teacher, ssod.pseudo_labels,
ssod.gmm, ssod.student, ssod.consistency and hungarian.solve_batch, which
`tools/profile_train.py --ssod` reads.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch.profiler import record_function

from ..models.criterion import detection_loss
from ..models.dn import (CdnNoise, build_cdn_queries, cdn_attn_mask,
                         compact_gt, draw_cdn_noise, pack_order)
from ..models.ssod import (SsodConfig, combined_attn_mask, consistency_loss,
                           consistency_partition, consistency_positions,
                           decode_pseudo_labels, dual_filter,
                           inject_fake_consistency_roi, normalize_boxes,
                           pseudo_matching_costs, scatter_to_slots,
                           transform_pseudo_to_student)
from ..ops.gmm import fit_gmm_threshold
from ..ops.roi_align import multi_level_roi_align
from .state import TrainState, ema_update
from .supervised import loss_and_grads


def _cdn(cfg: SsodConfig, noise: CdnNoise, gt, label_enc):
    c = cfg.dino
    return build_cdn_queries(noise, gt["boxes"], gt["labels"], gt["valid"],
                             label_enc, c.num_classes, c.dn_single_pad,
                             c.dn_groups, c.dn_label_noise_ratio,
                             c.dn_box_noise_scale)


def _take(x, order):
    """x (B, P, ...) rows in `order` (B, P)."""
    idx = order.reshape(order.shape + (1,) * (x.dim() - 2)).expand(
        *order.shape, *x.shape[2:])
    return torch.gather(x, 1, idx)


def unsup_forward_and_loss(model, projector, teacher, un: Dict[str, Any],
                           cfg: SsodConfig, warm_up: bool,
                           noise_student: CdnNoise, noise_teacher: CdnNoise):
    """The unlabeled branch: (losses, unweighted, with grad; metrics)."""
    c = cfg.dino
    with torch.no_grad():
        with record_function("ssod.teacher"):
            t_enc = teacher.encode_images(un["teacher_images"],
                                          un["teacher_hw"])
            t_match = teacher.decode_queries(t_enc)
        with record_function("ssod.pseudo_labels"):
            pl = decode_pseudo_labels(t_match["cls"][-1],
                                      t_match["coord"][-1],
                                      un["teacher_hw"], cfg)
            pl = transform_pseudo_to_student(pl, un["teacher_tmat"],
                                             un["student_tmat"],
                                             un["student_hw"])
            pl_norm_s = normalize_boxes(pl.boxes_s, un["student_hw"])

    with record_function("ssod.student"):
        # one encode serves the no-grad matching decode and the training
        # decode
        s_enc = model.encode_images(un["student_images"], un["student_hw"])
        with torch.no_grad():
            s_match = model.decode_queries(s_enc)
            costs = pseudo_matching_costs(s_match["cls"][-1],
                                          s_match["coord"][-1], pl_norm_s,
                                          pl.labels, pl.valid)
    with record_function("ssod.gmm"):
        # the reference all-gathers the costs: here the batch is the pool
        gmm_thr = fit_gmm_threshold(costs.reshape(-1), pl.valid.reshape(-1))
    keep_sup, keep_cons = dual_filter(costs, pl.scores, pl.valid, gmm_thr,
                                      cfg.score_thr)

    # the CDN layout needs prefix-packed validity
    sup_boxes, sup_labels, sup_valid = compact_gt(pl_norm_s, pl.labels,
                                                  keep_sup)
    unsup_gt = {"boxes": sup_boxes, "labels": sup_labels,
                "valid": sup_valid}
    label_enc = model.bbox_head.label_enc.weight
    cdn = _cdn(cfg, noise_student, unsup_gt, label_enc)

    if warm_up:
        with record_function("ssod.consistency"):
            keep_known, boxes_t, boxes_s = inject_fake_consistency_roi(
                keep_cons, pl.boxes_t, pl.boxes_s, un["teacher_hw"],
                un["student_hw"])
            b, p = keep_known.shape
            # content: RoIAlign of the teacher's features at teacher-frame
            # boxes -> Projector (trainable), reference :563-607
            roi = multi_level_roi_align(t_enc["srcs"], boxes_t)
            content = projector(roi.reshape(b * p, *roi.shape[2:]),
                                keep_known.reshape(-1)).reshape(b, p, -1)
            content = torch.where(keep_known[..., None], content, 0.0)
            # kept slots packed to the front (the order compact_gt gives the
            # teacher-view CDN), groups sized to the batch's largest count
            order = pack_order(keep_known)
            cons_sp, slot_idx, slot_w = consistency_partition(
                torch.gather(keep_known, 1, order), cfg.cons_groups,
                cfg.cons_pad)
            # the fake slots carry loss weight 0 (reference :577-581)
            loss_w = torch.gather(keep_cons, 1, order)[:, slot_idx] & slot_w
            content_slots = scatter_to_slots(_take(content, order), slot_idx,
                                             slot_w)
            pos_s = consistency_positions(_take(boxes_s, order),
                                          un["student_hw"], slot_w, slot_idx)
            attn_mask = combined_attn_mask(
                cfg.cons_pad, cfg.cons_groups, cdn.single_pad, cdn.groups,
                c.num_queries, dn_capacity=c.dn_pad_size,
                cons_single_pad=cons_sp)
            extra_tgt = torch.cat([content_slots, cdn.query_label], 1)
            extra_ref = torch.cat([pos_s, cdn.query_bbox], 1)
    else:
        attn_mask = cdn_attn_mask(cdn.single_pad, cdn.groups, c.num_queries,
                                  capacity=c.dn_pad_size)
        extra_tgt, extra_ref = cdn.query_label, cdn.query_bbox

    with record_function("ssod.student"):
        s_out = model.decode_queries(s_enc, extra_tgt, extra_ref, attn_mask)
        s_out["cdn"] = cdn
        # the criterion sees [dn | matching]
        n_cons = cfg.cons_pad if warm_up else 0
        crit_out = dict(s_out)
        if n_cons:
            crit_out["front_cls"] = s_out["front_cls"][:, :, n_cons:]
            crit_out["front_coord"] = s_out["front_coord"][:, :, n_cons:]
        losses = detection_loss(
            crit_out, unsup_gt, c.num_classes, warm_up, is_pseudo_label=True,
            cls_group=cfg.cls_avg_groups[1] if cfg.cls_avg_groups else None)
        losses.pop("total")

    if warm_up:
        with record_function("ssod.consistency"):
            with torch.no_grad():
                # the teacher decodes the same content at teacher-frame
                # positions, with a CDN block of its own from the student's
                # label embedding (reference :446-456); its partition can
                # differ from cdn's, hence its own mask
                pl_norm_t = normalize_boxes(pl.boxes_t, un["teacher_hw"])
                t_gt = compact_gt(pl_norm_t, pl.labels, keep_cons,
                                  order=order)
                cdn2 = _cdn(cfg, noise_teacher, dict(zip(
                    ("boxes", "labels", "valid"), t_gt)), label_enc.detach())
                pos_t = consistency_positions(_take(boxes_t, order),
                                              un["teacher_hw"], slot_w,
                                              slot_idx)
                attn_mask2 = combined_attn_mask(
                    cfg.cons_pad, cfg.cons_groups, cdn2.single_pad,
                    cdn2.groups, c.num_queries, dn_capacity=c.dn_pad_size,
                    cons_single_pad=cons_sp)
                t_out = teacher.decode_queries(
                    t_enc, torch.cat([content_slots.detach(),
                                      cdn2.query_label], 1),
                    torch.cat([pos_t, cdn2.query_bbox], 1), attn_mask2)
            losses.update(consistency_loss(
                s_out["hs"][:, :, :n_cons], t_out["hs"][:, :, :n_cons],
                loss_w, keep_cons.sum(-1).clamp(min=1), cfg,
                cfg.consistency_weight))

    b = pl.valid.shape[0]
    metrics = {
        "pseudo_per_img": pl.valid.sum() / b,
        "sup_set_per_img": keep_sup.sum() / b,
        "cons_set_per_img": keep_cons.sum() / b,
        "gmm_thr": torch.tensor(gmm_thr, dtype=torch.float32),
        # the first image's pseudo labels in the student frame, for the
        # reference's throttled visualization (`log_image_with_boxes`)
        "pseudo_vis": {"boxes": pl.boxes_s[0], "labels": pl.labels[0],
                       "scores": pl.scores[0], "keep": keep_sup[0]},
        # every image's pseudo slots, the two kept sets (B, P) bool, and
        # the matching costs (B, P), the GMM's pool
        "pseudo_sets": {"valid": pl.valid, "keep_sup": keep_sup,
                        "keep_cons": keep_cons, "costs": costs},
    }
    return losses, metrics


def make_ssod_train_step(cfg: SsodConfig, warm_up: bool, seed: int = 0):
    """Returns step(state, batch, noises=None) -> metrics,
    which updates `state` (a TrainState with a projector) in place.

    batch (tensors on the model's device, `data.pipeline.to_device`):
      sup:   images (Bs,H,W,3), img_hw (Bs,2), gt {boxes, labels, valid};
      unsup: student_images (Bu,H,W,3), student_hw, student_tmat (Bu,3,3),
             teacher_images, teacher_hw, teacher_tmat.
    noises: optional (supervised, unlabeled student, unlabeled teacher)
    CdnNoise triple; else drawn in that order from a generator seeded by
    (seed, step).

    metrics: sup_* losses, unsup_* losses times unsup_weight
    (unsup_consis_loss.d{l} in warm-up), total_loss, grad_norm (the
    trainable gradients' norm before the clip), ema_momentum,
    pseudo_per_img, sup_set_per_img, cons_set_per_img, gmm_thr,
    pseudo_vis, and pseudo_sets (the per-image valid / supervision /
    consistency masks and the matching costs)."""
    c = cfg.dino

    def step(state: TrainState, batch: Dict[str, Any],
             noises: Optional[Sequence[CdnNoise]] = None) -> Dict[str, Any]:
        model, projector, teacher = state.model, state.projector, \
            state.teacher
        sup, un = batch["sup"], batch["unsup"]
        if noises is None:                     # seeded by (seed, step)
            dev = sup["images"].device
            generator = torch.Generator(device=dev).manual_seed(
                (seed << 32) + state.step)
            noises = [draw_cdn_noise(generator, n, c.dn_pad_size,
                                     c.num_classes, dev)
                      for n in (sup["images"].shape[0],
                                un["student_images"].shape[0],
                                un["student_images"].shape[0])]
        noise_sup, noise_student, noise_teacher = noises
        with record_function("train.ema"):
            m = ema_update(teacher, model, state.step, cfg.ema_momentum,
                           decay_intervals=cfg.ema_decay_intervals,
                           decay_factor=cfg.ema_decay_factor)
        state.optimizer.zero_grad()

        cdn = _cdn(cfg, noise_sup, sup["gt"],
                   model.bbox_head.label_enc.weight)
        sup_losses = loss_and_grads(
            model, sup, warm_up, cls_group=(cfg.cls_avg_groups[0]
                                            if cfg.cls_avg_groups else None),
            extra_queries={
                "content": cdn.query_label, "bbox_unsig": cdn.query_bbox,
                "attn_mask": cdn_attn_mask(cdn.single_pad, cdn.groups,
                                           c.num_queries,
                                           capacity=c.dn_pad_size),
                "cdn": cdn})
        sup_losses.pop("total")

        unsup_losses, metrics = unsup_forward_and_loss(
            model, projector, teacher, un, cfg, warm_up, noise_student,
            noise_teacher)
        unsup_losses = {k: cfg.unsup_weight * v
                        for k, v in unsup_losses.items()}
        with record_function("train.backward"):
            sum(v for k, v in unsup_losses.items() if "loss" in k).backward()
        with record_function("train.optimizer"):
            grad_norm = state.optimizer.step(state.step)
        state.step += 1

        losses = {f"sup_{k}": v.detach() for k, v in sup_losses.items()}
        losses.update({f"unsup_{k}": v.detach()
                       for k, v in unsup_losses.items()})
        metrics.update(losses)
        metrics["total_loss"] = sum(v for k, v in losses.items()
                                    if "loss" in k)
        metrics["grad_norm"] = grad_norm
        metrics["ema_momentum"] = torch.tensor(float(m))
        return metrics

    return step
