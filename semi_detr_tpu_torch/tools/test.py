"""Evaluation CLI (reference: tools/test.py).

    python -m semi_detr_tpu_torch.tools.test <config> \
        [--checkpoint FILE_OR_DIR] [--inference-on teacher|student] \
        [--out results.json] [--device cpu]

Evaluates a checkpoint on the val set. Inference runs on the teacher by
default (the reference forces inference_on='teacher', tools/test.py:
195-200). A checkpoint of this package decodes with NMS while its step is
below `ssod.warm_up_step` and with top-k after (`:235-241`); a
reference-layout `.pth` is taken as fully trained (top-k). Prints the
summary JSON and the classwise AP table.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import torch

from ..models.dino_head import DINODetector
from ..models.inference import evaluate_detector
from ..train.checkpoint import CheckpointManager, load_warm_start
from .common import (base_parser, build_dataset, class_names, load_cfg,
                     scales_of, ssod_config)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = base_parser(__doc__)
    p.add_argument("--checkpoint", default=None,
                   help="a checkpoint file or directory of this package "
                        "(default: work_dir/ckpt) or a reference .pth")
    p.add_argument("--inference-on", default="teacher",
                   choices=["teacher", "student"])
    p.add_argument("--out", default=None, help="json results path")
    args = p.parse_args(argv)
    cfg = load_cfg(args)
    names = class_names(cfg)
    scfg = ssod_config(cfg)
    val = build_dataset(cfg["data"]["val_ann"], cfg["data"]["val_prefix"],
                        names, train=False)

    src = args.checkpoint or args.load_from
    if src and os.path.isfile(src):
        loaded = load_warm_start(src)
    else:
        loaded = CheckpointManager(
            src or os.path.join(cfg["work_dir"], "ckpt")).load()
    # a reference .pth carries no step: fully trained, top-k decode
    use_nms = ("step" in loaded
               and int(loaded["step"]) < scfg.warm_up_step)
    sd = (loaded["teacher"] if args.inference_on == "teacher"
          and loaded.get("teacher") is not None else loaded["student"])
    detector = DINODetector(scfg.dino)
    missing, _ = detector.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys, e.g. "
                       f"{missing[:3]}")
    detector.to(torch.device(args.device))
    res = evaluate_detector(
        detector, val, use_nms=use_nms,
        bucket=tuple(cfg.get("bucket", (800, 1344))),
        test_scale=(max(scales_of(cfg)) if cfg.get("scales") else None),
        num_classes=scfg.dino.num_classes, class_names=names)
    print(json.dumps({k: v for k, v in res.items()
                      if k != "AP_per_class"}, indent=2))
    # classwise AP table (the reference prints one, mmdet classwise=True)
    per_cls = [(n, ap) for n, ap in res.get("AP_per_class", {}).items()
               if ap is not None]
    if per_cls:
        width = max(len(n) for n, _ in per_cls)
        print("\nclasswise AP:")
        for i in range(0, len(per_cls), 4):
            print("  " + " | ".join(
                f"{n:<{width}} {ap:0.3f}" for n, ap in per_cls[i:i + 4]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
