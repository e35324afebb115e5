"""COCO-format dataset reader and the class names.

Counterpart of `semi_detr_tpu/data/coco.py` (mmdet `CocoDataset` as the
reference consumes it): contiguous labels from category names,
`filter_empty_gt`, the minimum image size, aspect-ratio flags for the
group sampler, crowd and ignore annotations as ignore regions. Pure numpy
and JSON; images are read by `data/image_io.py` (PNG here, JPEG through
cv2 where it can be imported).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from .image_io import read_image

COCO_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush")

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor")


@dataclass
class ImageRecord:
    id: int
    file_name: str
    width: int
    height: int
    boxes: np.ndarray          # (n, 4) xyxy float32 (valid, non-ignore)
    labels: np.ndarray         # (n,) int64 contiguous labels
    boxes_ignore: np.ndarray   # (m, 4) iscrowd/ignore boxes
    labels_ignore: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    ann_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # COCO ann['area'] (segmentation area): the protocol buckets GTs into
    # s/m/l by this, not by the box area
    areas: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    areas_ignore: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.float64))

    @property
    def aspect_flag(self) -> int:
        """mmdet group flag: 1 if w/h > 1 else 0."""
        return int(self.width / self.height > 1)


class CocoDataset:
    """Loads a COCO-format annotation JSON.

    Args:
      ann_file: path to instances json (or a dict already parsed).
      img_prefix: directory joined to file_name.
      classes: class-name tuple; category ids are mapped to this order.
      filter_empty_gt: drop images without annotations of these classes
        (train mode).
      min_size: drop images smaller than this on either side.
    """

    def __init__(self, ann_file, img_prefix: str = "",
                 classes: Sequence[str] = COCO_CLASSES,
                 filter_empty_gt: bool = True, min_size: int = 32,
                 test_mode: bool = False):
        self.img_prefix = img_prefix
        self.classes = tuple(classes)
        if isinstance(ann_file, (str, os.PathLike)):
            with open(ann_file) as f:
                coco = json.load(f)
        else:
            coco = ann_file
        name_to_contig = {n: i for i, n in enumerate(self.classes)}
        self.cat_id_to_label: Dict[int, int] = {}
        self.label_to_cat_id: Dict[int, int] = {}
        for cat in coco.get("categories", []):
            if cat["name"] in name_to_contig:
                lbl = name_to_contig[cat["name"]]
                self.cat_id_to_label[cat["id"]] = lbl
                self.label_to_cat_id[lbl] = cat["id"]

        anns_by_img: Dict[int, list] = {}
        for ann in coco.get("annotations", []):
            anns_by_img.setdefault(ann["image_id"], []).append(ann)

        self.records: List[ImageRecord] = []
        for img in coco.get("images", []):
            w, h = img["width"], img["height"]
            if min(w, h) < min_size and not test_mode:
                continue
            boxes, labels, ann_ids, areas = [], [], [], []
            ignores, ig_labels, ig_areas = [], [], []
            has_cat_ann = False     # any raw ann of a relevant category
            for ann in anns_by_img.get(img["id"], []):
                if ann.get("category_id") not in self.cat_id_to_label:
                    continue
                has_cat_ann = True
                # mmdet _parse_ann_info (coco.py:216-231): zero image
                # intersection, area <= 0 and sub-pixel w/h dropped. An
                # explicit ignore flag makes an ignore region, as crowd
                # does (the JAX package's deviation from mmdet, which drops
                # them: VOC-difficult boxes carry the flag there)
                x, y, bw, bh = ann["bbox"]
                inter_w = max(0.0, min(x + bw, w) - max(x, 0.0))
                inter_h = max(0.0, min(y + bh, h) - max(y, 0.0))
                if inter_w * inter_h == 0:
                    continue
                if ann.get("area", bw * bh) <= 0 or bw < 1 or bh < 1:
                    continue
                box = [x, y, x + bw, y + bh]
                area = float(ann.get("area", bw * bh))
                if ann.get("iscrowd", 0) or ann.get("ignore", 0):
                    ignores.append(box)
                    ig_labels.append(self.cat_id_to_label[ann["category_id"]])
                    ig_areas.append(area)
                else:
                    boxes.append(box)
                    labels.append(self.cat_id_to_label[ann["category_id"]])
                    ann_ids.append(ann.get("id", 0))
                    areas.append(area)
            # mmdet _filter_imgs: keep any image with a raw annotation of a
            # relevant category (crowd-only images stay in the set)
            if filter_empty_gt and not test_mode and not has_cat_ann:
                continue
            self.records.append(ImageRecord(
                id=img["id"], file_name=img["file_name"], width=w, height=h,
                boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                labels=np.asarray(labels, np.int64),
                boxes_ignore=np.asarray(ignores, np.float32).reshape(-1, 4),
                labels_ignore=np.asarray(ig_labels, np.int64),
                ann_ids=np.asarray(ann_ids, np.int64),
                areas=np.asarray(areas, np.float64),
                areas_ignore=np.asarray(ig_areas, np.float64)))

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i) -> ImageRecord:
        return self.records[i]

    @property
    def flags(self) -> np.ndarray:
        return np.asarray([r.aspect_flag for r in self.records], np.int64)

    def load_image(self, i) -> np.ndarray:
        """Returns HWC uint8 RGB."""
        return read_image(os.path.join(self.img_prefix,
                                       self.records[i].file_name))
