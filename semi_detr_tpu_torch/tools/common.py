"""Shared CLI plumbing: config -> datasets and model configs.

Counterpart of `tools/common.py`: the same flags, plus `--device` (the
card by default; `cpu` runs the same path on the CPU). Launched by
`python -m torch.distributed.run --nproc-per-node N -m
semi_detr_tpu_torch.tools.<cli> ...`, `load_cfg` joins the process group
first (as the JAX CLIs join the multi-host runtime): rank r runs on
cuda:LOCAL_RANK over NCCL, or with `--device cpu` on the CPU over gloo.
"""
from __future__ import annotations

import argparse

from ..data.coco import COCO_CLASSES, VOC_CLASSES, CocoDataset
from ..models.dino_head import DinoConfig
from ..models.ssod import SsodConfig
from ..parallel.dist import maybe_initialize_distributed
from ..utils.config import load_config, parse_cfg_options


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("config", help="config file path")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--load-from", default=None,
                   help="warm-start detector weights: a reference-layout "
                        ".pth (teacher/student duplication rule) or a "
                        "checkpoint file or directory of this package")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--cfg-options", nargs="+", default=[],
                   help="override config entries, key=value (dotted keys)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card)")
    return p


def load_cfg(args) -> dict:
    # the process group forms before any work, from torch.distributed.run's
    # environment (a no-op without it); a device without an index becomes
    # this rank's card
    device = maybe_initialize_distributed(args.device)
    if device is not None:
        args.device = str(device)
    cfg = load_config(args.config, parse_cfg_options(args.cfg_options))
    if args.work_dir:
        cfg["work_dir"] = args.work_dir
    if args.seed is not None:
        cfg["seed"] = args.seed
    if getattr(args, "load_from", None):
        cfg["load_from"] = args.load_from
    return cfg


def class_names(cfg) -> tuple:
    """data.classes: 'voc', an explicit name list/tuple (names absent from
    the list are dropped by CocoDataset's category mapping), or unset ->
    COCO."""
    c = cfg["data"].get("classes")
    if c == "voc":
        return VOC_CLASSES
    if isinstance(c, (list, tuple)):
        if not c:
            raise ValueError("data.classes is an empty list")
        return tuple(c)
    return COCO_CLASSES


def dino_config(cfg) -> DinoConfig:
    m = dict(cfg["model"])
    m.pop("type", None)
    return DinoConfig(**m)


def ssod_config(cfg) -> SsodConfig:
    s = dict(cfg.get("ssod", {}))
    s.pop("type", None)
    if "ema_decay_intervals" in s:
        s["ema_decay_intervals"] = tuple(s["ema_decay_intervals"] or ())
    if s.get("cls_avg_groups") is not None:
        s["cls_avg_groups"] = tuple(s["cls_avg_groups"])
    return SsodConfig(dino=dino_config(cfg), **s)


def build_dataset(ann, prefix, names, train=True):
    return CocoDataset(ann, prefix, classes=names,
                       filter_empty_gt=train, test_mode=not train)


def scales_of(cfg):
    return [tuple(s) for s in cfg["scales"]] if cfg.get("scales") else None
