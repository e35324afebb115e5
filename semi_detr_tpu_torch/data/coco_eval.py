"""COCO-style detection mAP: a numpy implementation of the COCOeval bbox
protocol, without pycocotools.

The port's own copy of `semi_detr_tpu/data/coco_eval.py` (the port imports
nothing of the JAX package); its results equal that module's, dict for
dict, on the same inputs.

Reproduces the evaluation the reference runs every 4000 iters
(`detr_ssod/utils/hooks/submodules_evaluation.py:71-112` ->
mmdet `CocoDataset.evaluate(metric='bbox', classwise=True)` ->
pycocotools COCOeval): IoU thresholds .5:.05:.95, 101-point recall grid,
area ranges all/small/medium/large, maxDets (1, 10, 100), greedy
score-ordered matching with crowd/ignore regions matched but not counted.
Reports the full 12-number COCO summary: AP family plus AR@[1,10,100]
and AR_s/m/l (mmdet prints both, `submodules_evaluation.py:107-112`).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = 100
AR_MAX_DETS = (1, 10, 100)


def box_iou_xyxy(a: np.ndarray, b: np.ndarray,
                 b_crowd: Optional[np.ndarray] = None) -> np.ndarray:
    """(N,4)x(M,4) -> (N,M). For crowd GTs, IoU = intersection / det area
    (pycocotools iscrowd semantics)."""
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(
        a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(
        b[:, 3] - b[:, 1], 0, None)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    if b_crowd is not None and b_crowd.any():
        union = np.where(b_crowd[None, :], area_a[:, None], union)
    return inter / np.maximum(union, 1e-10)


def _evaluate_img(ious, d_area, g_crowd, g_area, gt_ignore, area_rng):
    """Greedy matching for one (image, category, area range).

    ious: (D, G) precomputed with CROWD (not area-ignore) semantics and
    dets already score-sorted/truncated — pycocotools computes IoUs once
    per (img, cat) and only re-sorts GTs per area range.
    Returns (dt_matches (T, D), dt_ignore (T, D), gt_count)."""
    lo, hi = area_rng
    g_ig = gt_ignore | (g_area < lo) | (g_area > hi)
    # sort gts: non-ignored first (pycocotools gtind)
    g_order = np.argsort(g_ig, kind="stable")
    g_ig = g_ig[g_order]
    g_crowd = g_crowd[g_order]

    T, D, G = len(IOU_THRS), ious.shape[0], ious.shape[1]
    dtm = -np.ones((T, D), np.int64)
    dt_ig = np.zeros((T, D), bool)
    if G:
        ious_a = ious[:, g_order]
        for ti, thr in enumerate(IOU_THRS):
            gtm = -np.ones(G, np.int64)
            for di in range(D):
                best, best_iou = -1, min(thr, 1 - 1e-10)
                for gi in range(G):
                    # matched gts can only re-match if CROWD
                    # (pycocotools: `if gtm[...]>0 and not iscrowd`)
                    if gtm[gi] >= 0 and not g_crowd[gi]:
                        continue
                    # stop at ignored gts once matched to a real gt
                    if best >= 0 and not g_ig[best] and g_ig[gi]:
                        break
                    if ious_a[di, gi] < best_iou:
                        continue
                    best_iou = ious_a[di, gi]
                    best = gi
                if best >= 0:
                    gtm[best] = di
                    dtm[ti, di] = best
                    dt_ig[ti, di] = g_ig[best]
    # unmatched dets outside the area range are ignored
    out_rng = (d_area < lo) | (d_area > hi)
    dt_ig |= (dtm < 0) & out_rng[None, :]
    return dtm, dt_ig, int((~g_ig).sum())


def coco_map(detections: Dict[int, Tuple[np.ndarray, np.ndarray,
                                         np.ndarray]],
             groundtruth: Dict[int, Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]],
             num_classes: int,
             class_names: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Compute COCO bbox AP.

    Args:
      detections: image_id -> (boxes (N,4) xyxy, scores (N,), labels (N,)).
      groundtruth: image_id -> (boxes (M,4) xyxy, labels (M,),
        crowd (M,) bool) or (boxes, labels, crowd, areas (M,)) — areas
        are COCO ann['area'] (segmentation) used for s/m/l bucketing;
        bbox areas are the fallback.
      num_classes: contiguous label count.

    Returns dict: mAP, mAP_50, mAP_75, mAP_s, mAP_m, mAP_l, AP_per_class.
    """
    img_ids = sorted(groundtruth.keys())
    T, R = len(IOU_THRS), len(REC_THRS)
    areas = list(AREA_RNG)
    # precision[t, r, k, a]; recall[t, k, a] at maxDets=100 and
    # recall_md[t, k, m] (area=all) at maxDets AR_MAX_DETS
    precision = -np.ones((T, R, num_classes, len(areas)))
    recall = -np.ones((T, num_classes, len(areas)))
    recall_md = -np.ones((T, num_classes, len(AR_MAX_DETS)))
    ap_per_class = np.full(num_classes, np.nan)

    for k in range(num_classes):
        per_area_stats = {a: [] for a in areas}
        n_gt = {a: 0 for a in areas}
        for img_id in img_ids:
            rec = groundtruth[img_id]
            gt_b, gt_l, gt_crowd = rec[0], rec[1], rec[2]
            if len(rec) > 3:
                gt_area = np.asarray(rec[3], np.float64)
            else:
                gt_area = (np.clip(gt_b[:, 2] - gt_b[:, 0], 0, None)
                           * np.clip(gt_b[:, 3] - gt_b[:, 1], 0, None))
            det = detections.get(img_id)
            sel_g = gt_l == k
            if det is None:
                d_b = np.zeros((0, 4), np.float32)
                d_s = np.zeros(0, np.float32)
            else:
                d_b, d_s, d_l = det
                sel_d = d_l == k
                d_b, d_s = d_b[sel_d], d_s[sel_d]
            if not sel_g.any() and len(d_b) == 0:
                continue
            # hoisted per (img, cat): det score sort + IoUs with crowd
            # semantics (pycocotools computeIoU runs once per img/cat)
            d_order = np.argsort(-d_s, kind="stable")[:MAX_DETS]
            d_b = d_b[d_order]
            scores = d_s[d_order]
            d_area = (np.clip(d_b[:, 2] - d_b[:, 0], 0, None)
                      * np.clip(d_b[:, 3] - d_b[:, 1], 0, None))
            g_crowd_k = gt_crowd[sel_g]
            ious = box_iou_xyxy(d_b, gt_b[sel_g], g_crowd_k)
            for ai, a in enumerate(areas):
                dtm, dt_ig, ng = _evaluate_img(
                    ious, d_area, g_crowd_k, gt_area[sel_g],
                    g_crowd_k.copy(), AREA_RNG[a])
                per_area_stats[a].append((dtm, dt_ig, scores))
                n_gt[a] += ng

        for ai, a in enumerate(areas):
            stats = per_area_stats[a]
            if n_gt[a] == 0:
                continue
            # recall at each maxDets: truncate per IMAGE before pooling
            # (pycocotools applies maxDets per image)
            for mi, md in enumerate(AR_MAX_DETS):
                if ai != 0 and md != MAX_DETS:
                    continue
                tp_total = sum(
                    ((dtm_i[:, :md] >= 0) & ~ig_i[:, :md]).sum(1)
                    for dtm_i, ig_i, _ in stats)
                rc_md = tp_total / n_gt[a]
                if ai == 0:
                    recall_md[:, k, mi] = rc_md
                if md == MAX_DETS:
                    recall[:, k, ai] = rc_md
            dtm = np.concatenate([s[0] for s in stats], axis=1)
            dt_ig = np.concatenate([s[1] for s in stats], axis=1)
            scores = np.concatenate([s[2] for s in stats])
            order = np.argsort(-scores, kind="mergesort")
            dtm, dt_ig = dtm[:, order], dt_ig[:, order]
            tps = (dtm >= 0) & ~dt_ig
            fps = (dtm < 0) & ~dt_ig
            tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
            for ti in range(T):
                tp, fp = tp_cum[ti], fp_cum[ti]
                rc = tp / n_gt[a]
                pr = tp / np.maximum(tp + fp, np.spacing(1))
                # monotone non-increasing precision envelope
                for i in range(len(pr) - 1, 0, -1):
                    pr[i - 1] = max(pr[i - 1], pr[i])
                inds = np.searchsorted(rc, REC_THRS, side="left")
                q = np.zeros(R)
                valid = inds < len(pr)
                q[valid] = pr[inds[valid]]
                precision[ti, :, k, ai] = q

        p_all = precision[:, :, k, 0]
        if (p_all > -1).any():
            ap_per_class[k] = p_all[p_all > -1].mean()

    def _ap(t_slice=slice(None), area="all"):
        ai = areas.index(area)
        p = precision[t_slice, :, :, ai]
        p = p[p > -1]
        return float(p.mean()) if p.size else float("nan")

    def _ar(mi=None, area="all"):
        if mi is not None:
            r = recall_md[:, :, mi]
        else:
            r = recall[:, :, areas.index(area)]
        r = r[r > -1]
        return float(r.mean()) if r.size else float("nan")

    out = {
        "mAP": _ap(),
        "mAP_50": _ap(slice(0, 1)),
        "mAP_75": _ap(slice(5, 6)),
        "mAP_s": _ap(area="small"),
        "mAP_m": _ap(area="medium"),
        "mAP_l": _ap(area="large"),
        "AR_1": _ar(0),
        "AR_10": _ar(1),
        "AR_100": _ar(2),
        "AR_s": _ar(area="small"),
        "AR_m": _ar(area="medium"),
        "AR_l": _ar(area="large"),
    }
    if class_names is not None:
        out["AP_per_class"] = {
            class_names[k]: (None if np.isnan(ap_per_class[k])
                             else float(ap_per_class[k]))
            for k in range(num_classes)}
    return out
