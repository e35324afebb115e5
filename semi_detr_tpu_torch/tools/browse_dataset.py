"""Render the augmentation pipeline's output with its GT boxes.

Counterpart of `tools/misc/browse_dataset.py` (reference
tools/misc/browse_dataset.py), without cv2: the GT boxes drawn as its
cv2.rectangle draws them (green outlines, 2 pixels, `utils.logging.
draw_rect`), without text, and the JPEG encoded by the host library (the
JAX tool's cv2.imwrite bytes).

Usage:
  python -m semi_detr_tpu_torch.tools.browse_dataset --ann ANN.json \\
      --prefix IMG_DIR --pipeline strong --out viz/ --num 10
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    from ..data.augment import (make_sample, strong_augment, sup_augment,
                                weak_augment)
    from ..data.coco import CocoDataset
    from ..data.image_io import write_image
    from ..utils.logging import draw_rect

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
    os.makedirs(args.out, exist_ok=True)
    written = []
    for i in range(min(args.num, len(ds))):
        rec = ds[i]
        s = aug(rng, make_sample(ds.load_image(i), rec.boxes, rec.labels))
        img = np.array(s.img, np.uint8)
        for b in s.boxes:
            draw_rect(img, *(int(v) for v in b[:4]), color=(0, 255, 0),
                      thickness=2)
        dst = os.path.join(args.out, f"{args.pipeline}_{i}.jpg")
        write_image(dst, img)
        print(dst, img.shape, len(s.boxes), "boxes")
        written.append(dst)
    return written


if __name__ == "__main__":
    main()
