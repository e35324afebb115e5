"""How often the static capacity bounds bind on a dataset (and checkpoint).

Counterpart of `tools/misc/capacity_probe.py`. The design bounds several
quantities the reference leaves dynamic; this measures each:

1. GT packing: images and GTs beyond `max_gt` (pack() keeps the first
   max_gt) and beyond the CDN budget's half (models/dn.py).
2. The pseudo-label path (needs --ckpt): per-image NMS survivors, the
   survivors after the mean+std filter against `ssod.max_pseudo`, and the
   recall of the `pre_topk`-capped NMS (ops/nms.py) against an exact
   uncapped pass over every score > 0.01 candidate, as the reference's
   pseudo path (dino_detr_ssod_head.py:1368-1399).

Usage:
  python -m semi_detr_tpu_torch.tools.capacity_probe --ann ANN.json \\
      [--max-gt 100] [--dn-budget 200]
      [--ckpt work_dir/ckpt --config configs/... --images PREFIX \\
       --num-images 50 --max-pseudo 32 --pre-topk 2000 --device cuda]

--ckpt is a checkpoint file or directory of this package, or a reference
`.pth`; its teacher is probed.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def gt_stats(ann_path: str, max_gt: int, dn_budget: int) -> dict:
    """Prints, and returns, the GT-per-image statistics and how many
    images and GTs each bound clips."""
    with open(ann_path) as f:
        coco = json.load(f)
    counts: dict = {}
    for a in coco.get("annotations", []):
        if a.get("iscrowd", 0):
            continue
        counts[a["image_id"]] = counts.get(a["image_id"], 0) + 1
    n_img = len(coco.get("images", []))
    # annotations may name images outside the (filtered) images list
    c = np.zeros(max(n_img, len(counts)), np.int64)
    c[:len(counts)] = sorted(counts.values(), reverse=True)
    total_gt = int(c.sum())
    dn_cap = dn_budget // 2
    out = {"images": n_img, "annotated": len(counts), "gts": total_gt,
           "mean": float(c.mean()), "p50": float(np.percentile(c, 50)),
           "p99": float(np.percentile(c, 99)), "max": int(c.max()),
           "caps": {}}
    print(f"images: {n_img}, annotated: {len(counts)}, GTs: {total_gt}")
    print(f"GT/image: mean {c.mean():.2f}, p50 {np.percentile(c, 50):.0f}, "
          f"p99 {np.percentile(c, 99):.0f}, max {c.max()}")
    for cap, name in ((max_gt, f"max_gt={max_gt}"),
                      (dn_cap, f"dn capacity//2={dn_cap}")):
        over_img = int((c > cap).sum())
        over_pct = over_img / max(n_img, 1)
        lost = int(np.maximum(c - cap, 0).sum())
        out["caps"][name] = {"images_over": over_img, "gts_clipped": lost}
        print(f"{name}: {over_img} images over ({over_pct:.4%}), "
              f"{lost} GTs clipped ({lost / max(total_gt, 1):.4%})")
    return out


def exact_multiclass_nms_np(boxes_xyxy, scores, score_thr, iou_thr,
                            max_out):
    """Exact multiclass NMS in numpy: every candidate above score_thr (no
    pre_topk), class-wise greedy, the top max_out by score. Returns the
    survivors as a set of (box index, class) and their scores."""
    bi, ci = np.nonzero(scores > score_thr)
    s = scores[bi, ci]
    order = np.argsort(-s, kind="stable")
    bi, ci, s = bi[order], ci[order], s[order]
    cand = boxes_xyxy[bi]
    keep_ids = []
    for cls in np.unique(ci):
        m = ci == cls
        b, ids, sc = cand[m], bi[m], s[m]
        alive = np.ones(len(b), bool)
        area = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(
            b[:, 3] - b[:, 1], 0)
        for i in range(len(b)):
            if not alive[i]:
                continue
            keep_ids.append((int(ids[i]), int(cls), float(sc[i])))
            xx1 = np.maximum(b[i, 0], b[i + 1:, 0])
            yy1 = np.maximum(b[i, 1], b[i + 1:, 1])
            xx2 = np.minimum(b[i, 2], b[i + 1:, 2])
            yy2 = np.minimum(b[i, 3], b[i + 1:, 3])
            inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
            iou = inter / np.maximum(area[i] + area[i + 1:] - inter, 1e-9)
            alive[i + 1:] &= iou <= iou_thr
    keep_ids.sort(key=lambda t: -t[2])
    keep_ids = keep_ids[:max_out]
    return ({(b, c_) for b, c_, _ in keep_ids},
            np.asarray([sc for _, _, sc in keep_ids]))


def pseudo_stats(args) -> dict:
    import torch

    from ..api import init_detector
    from ..core import boxes as box_ops
    from ..data.coco import CocoDataset
    from ..data.pipeline import make_test_batch
    from ..ops.nms import multiclass_nms
    from ..utils.config import parse_cfg_options

    ds = CocoDataset(args.ann, args.images, test_mode=True,
                     filter_empty_gt=False)
    det = init_detector(args.config, args.ckpt, args.device,
                        cfg_options=parse_cfg_options(
                            args.cfg_options)).detector
    n = min(args.num_images, len(ds))
    nms_counts, filt_counts, hits, total = [], [], 0, 0
    for i in range(n):
        batch = make_test_batch(ds, [i], bucket=(800, 1344))
        with torch.inference_mode():
            out = det(torch.from_numpy(batch["images"]).to(args.device),
                      torch.from_numpy(batch["img_hw"]).to(args.device))
            scores = out["cls"][-1][0].sigmoid()
            boxes = box_ops.cxcywh_to_xyxy(out["coord"][-1][0]).clamp(0, 1)
            capped = multiclass_nms(boxes, scores, 0.01, 0.6, 300,
                                    pre_topk=args.pre_topk)
        exact_ids, exact_scores = exact_multiclass_nms_np(
            boxes.cpu().numpy(), scores.cpu().numpy(), 0.01, 0.6, 300)
        # survivor identity (candidate box, class), not counts: a swapped
        # suppression chain counts as lost recall
        capped_ids = {(int(b), int(c)) for b, c, v in zip(
            capped["box_idx"].tolist(), capped["labels"].tolist(),
            capped["valid"].tolist()) if v}
        hits += len(exact_ids & capped_ids)
        total += len(exact_ids)
        nms_counts.append(len(exact_ids))
        # mean+std filter (extract_teacher_info, dino_detr_ssod.py:918-927)
        if len(exact_scores):
            thr = exact_scores.mean() + exact_scores.std()
            filt_counts.append(int((exact_scores >= thr).sum()))
    nms_counts = np.asarray(nms_counts)
    filt_counts = np.asarray(filt_counts or [0])
    print(f"NMS survivors/image: mean {nms_counts.mean():.1f}, "
          f"p99 {np.percentile(nms_counts, 99):.0f}, max {nms_counts.max()}"
          f" (reference cap 300)")
    print(f"pre_topk={args.pre_topk} recall vs exact: {hits}/{total} = "
          f"{hits / max(total, 1):.4%}")
    print(f"post mean+std filter/image: mean {filt_counts.mean():.1f}, "
          f"max {filt_counts.max()} (max_pseudo={args.max_pseudo}: "
          f"{(filt_counts > args.max_pseudo).mean():.4%} of images clipped)")
    return {"nms_survivors": nms_counts.tolist(), "recall_hits": hits,
            "recall_total": total, "filtered": filt_counts.tolist()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ann", required=True)
    p.add_argument("--max-gt", type=int, default=100)
    p.add_argument("--dn-budget", type=int, default=200)
    p.add_argument("--ckpt")
    p.add_argument("--config")
    p.add_argument("--cfg-options", nargs="+", default=[])
    p.add_argument("--images")
    p.add_argument("--num-images", type=int, default=50)
    p.add_argument("--max-pseudo", type=int, default=32)
    p.add_argument("--pre-topk", type=int, default=2000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    out = {"gt": gt_stats(args.ann, args.max_gt, args.dn_budget)}
    if args.ckpt:
        out["pseudo"] = pseudo_stats(args)
    return out


if __name__ == "__main__":
    main()
