"""VOC XML -> COCO JSON converter (the twin of tools/dataset/voc_to_coco.py,
the reference's scripts/voc_to_coco.py).

    python -m semi_detr_tpu_torch.tools.voc_to_coco \
        --ann-dir VOCdevkit/VOC2007/Annotations \
        --ids-file VOCdevkit/VOC2007/ImageSets/Main/trainval.txt \
        --out data/voc/annotations/voc07_trainval.json
"""
from __future__ import annotations

import argparse

from ..data.voc import convert_and_save


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ann-dir", required=True,
                   help="VOCdevkit/VOC2007/Annotations")
    p.add_argument("--ids-file", default=None,
                   help="ImageSets/Main/trainval.txt")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    convert_and_save(args.ann_dir, args.out, args.ids_file)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
