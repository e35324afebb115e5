"""Render the augmentation pipeline's output with its GT boxes.

Counterpart of `tools/misc/browse_dataset.py` (reference
tools/misc/browse_dataset.py), without cv2: the boxes are drawn by
`api.save_result` (green outlines, 2 pixels) and the JPEG is encoded by
the host library.

Usage:
  python -m semi_detr_tpu_torch.tools.browse_dataset --ann ANN.json \\
      --prefix IMG_DIR --pipeline strong --out viz/ --num 10
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    from ..api import save_result
    from ..data.augment import (make_sample, strong_augment, sup_augment,
                                weak_augment)
    from ..data.coco import CocoDataset

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ann", required=True)
    p.add_argument("--prefix", default="")
    p.add_argument("--pipeline", default="strong",
                   choices=["weak", "strong", "sup"])
    p.add_argument("--out", default="browse_out")
    p.add_argument("--num", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    ds = CocoDataset(args.ann, args.prefix, filter_empty_gt=False,
                     test_mode=True)
    aug = {"weak": weak_augment, "strong": strong_augment,
           "sup": sup_augment}[args.pipeline]
    rng = np.random.default_rng(args.seed)
    written = []
    for i in range(min(args.num, len(ds))):
        rec = ds[i]
        s = aug(rng, make_sample(ds.load_image(i), rec.boxes, rec.labels))
        dst = os.path.join(args.out, f"{args.pipeline}_{i}.jpg")
        boxes = np.asarray(s.boxes, np.float32).reshape(-1, 4)
        save_result(s.img, (boxes, np.ones(len(boxes)), s.labels), (), dst,
                    score_thr=0.0)
        print(dst, s.img.shape, len(boxes), "boxes")
        written.append(dst)
    return written


if __name__ == "__main__":
    main()
