"""VOC XML -> COCO-format JSON conversion.

Counterpart of `semi_detr_tpu/data/voc.py` (the port keeps its own copy).
Behaviour parity with the reference's `scripts/voc_to_coco.py:16-239`:
parses VOC Annotations/*.xml, maps the 20 VOC classes to category ids,
marks `difficult` objects as ignore regions, and emits a COCO dict usable
by `CocoDataset` — enabling COCO-style mAP evaluation on VOC (the
reference's VOC recipe evaluates AP50 and COCO-mAP this way).
"""
from __future__ import annotations

import glob
import json
import os
import xml.etree.ElementTree as ET
from typing import Dict, Optional, Sequence

from .coco import VOC_CLASSES


def parse_voc_xml(path: str) -> Dict:
    root = ET.parse(path).getroot()
    size = root.find("size")
    out = {
        "file_name": root.findtext("filename"),
        "width": int(size.findtext("width")),
        "height": int(size.findtext("height")),
        "objects": [],
    }
    for obj in root.iter("object"):
        name = obj.findtext("name")
        bb = obj.find("bndbox")
        # VOC pixel indices are 1-based inclusive
        x0 = float(bb.findtext("xmin")) - 1
        y0 = float(bb.findtext("ymin")) - 1
        x1 = float(bb.findtext("xmax"))
        y1 = float(bb.findtext("ymax"))
        out["objects"].append({
            "name": name,
            "bbox": [x0, y0, x1 - x0, y1 - y0],
            "difficult": int(obj.findtext("difficult") or 0),
        })
    return out


def voc_to_coco(ann_dir: str, ids: Optional[Sequence[str]] = None,
                classes: Sequence[str] = VOC_CLASSES) -> Dict:
    """ann_dir: VOC Annotations directory. ids: image stems to include
    (e.g. from ImageSets/Main/trainval.txt); default all."""
    name_to_cat = {n: i + 1 for i, n in enumerate(classes)}
    images, annotations = [], []
    ann_id = 1
    if ids is None:
        files = sorted(glob.glob(os.path.join(ann_dir, "*.xml")))
    else:
        files = [os.path.join(ann_dir, f"{i}.xml") for i in ids]
    for img_id, path in enumerate(files, start=1):
        rec = parse_voc_xml(path)
        images.append({
            "id": img_id, "file_name": rec["file_name"],
            "width": rec["width"], "height": rec["height"],
        })
        for obj in rec["objects"]:
            if obj["name"] not in name_to_cat:
                continue
            w, h = obj["bbox"][2], obj["bbox"][3]
            annotations.append({
                "id": ann_id, "image_id": img_id,
                "category_id": name_to_cat[obj["name"]],
                "bbox": obj["bbox"], "area": w * h,
                "iscrowd": 0,
                # difficult -> ignore region (reference: difficult->ignore)
                "ignore": obj["difficult"],
            })
            ann_id += 1
    return {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": v, "name": k}
                       for k, v in name_to_cat.items()],
    }


def convert_and_save(ann_dir: str, out_file: str,
                     ids_file: Optional[str] = None) -> str:
    ids = None
    if ids_file:
        with open(ids_file) as f:
            ids = [line.strip() for line in f if line.strip()]
    coco = voc_to_coco(ann_dir, ids)
    with open(out_file, "w") as f:
        json.dump(coco, f)
    return out_file
