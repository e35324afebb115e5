"""Semi-supervised COCO split generation.

Counterpart of `semi_detr_tpu/data/semi_split.py` (the port keeps its own
copy). Behaviour parity with the reference's
`tools/dataset/semi_coco.py:28-118`: a seeded random
permutation of train2017 image ids selects `percent`% as labeled; the
rest become the unlabeled split (annotations stripped). Output naming
follows the reference convention
`instances_train2017.{fold}@{percent}.json` /
`...@{percent}-unlabeled.json`, consumed via the `${fold}`/`${percent}`
config variables. Also builds `instances_unlabeled2017.json` from an
image_info file for the coco-full recipe.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np


def split_coco(coco: Dict, percent: float, seed: int) -> Tuple[Dict, Dict]:
    """Returns (labeled_json, unlabeled_json) dicts."""
    rng = np.random.RandomState(seed)
    image_ids = [img["id"] for img in coco["images"]]
    n_label = int(len(image_ids) * percent / 100.0)
    perm = rng.permutation(len(image_ids))
    labeled_ids = {image_ids[i] for i in perm[:n_label]}

    lab_imgs = [im for im in coco["images"] if im["id"] in labeled_ids]
    unl_imgs = [im for im in coco["images"] if im["id"] not in labeled_ids]
    lab_anns = [a for a in coco.get("annotations", [])
                if a["image_id"] in labeled_ids]

    base = {k: v for k, v in coco.items()
            if k not in ("images", "annotations")}
    labeled = dict(base, images=lab_imgs, annotations=lab_anns)
    unlabeled = dict(base, images=unl_imgs, annotations=[])
    return labeled, unlabeled


def generate_splits(ann_file: str, out_dir: str,
                    percents=(1, 5, 10), folds=(1, 2, 3, 4, 5),
                    name: str = "instances_train2017"):
    """Writes {name}.{fold}@{percent}[-unlabeled].json for each combo
    (reference `prepare_coco_data.sh:10-60` loop)."""
    with open(ann_file) as f:
        coco = json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    for percent in percents:
        for fold in folds:
            labeled, unlabeled = split_coco(coco, percent, seed=fold)
            for suffix, data in (("", labeled), ("-unlabeled", unlabeled)):
                path = os.path.join(
                    out_dir, f"{name}.{fold}@{percent}{suffix}.json")
                with open(path, "w") as f:
                    json.dump(data, f)
    return out_dir


def unlabeled_from_image_info(image_info_file: str, out_file: str):
    """Build instances_unlabeled2017.json (images only, no annotations)."""
    with open(image_info_file) as f:
        info = json.load(f)
    out = {k: v for k, v in info.items() if k != "annotations"}
    out["annotations"] = []
    with open(out_file, "w") as f:
        json.dump(out, f)
    return out_file
