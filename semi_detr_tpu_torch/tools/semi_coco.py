"""COCO semi-supervised splits (the twin of tools/dataset/semi_coco.py, the
reference's tools/dataset/semi_coco.py): for each percent and fold, the
labelled `instances_train2017.{fold}@{percent}.json` and the unlabelled
`...@{percent}-unlabeled.json`.

    python -m semi_detr_tpu_torch.tools.semi_coco \
        --ann data/coco/annotations/instances_train2017.json \
        --out data/coco/annotations/semi_supervised
"""
from __future__ import annotations

import argparse

from ..data.semi_split import generate_splits


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ann", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--percents", type=float, nargs="+",
                   default=[1, 5, 10])
    p.add_argument("--folds", type=int, nargs="+", default=[1, 2, 3, 4, 5])
    args = p.parse_args(argv)
    generate_splits(args.ann, args.out, args.percents, args.folds)
    print(f"splits written to {args.out}")
    return args.out


if __name__ == "__main__":
    main()
