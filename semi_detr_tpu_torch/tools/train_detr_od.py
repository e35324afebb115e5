"""Supervised training entry (reference: tools/train_detr_od.py).

    python -m semi_detr_tpu_torch.tools.train_detr_od \
        configs/dino_detr/dino_detr_r50_coco.py [--device cpu]

Resumes from `work_dir/ckpt` when it holds a checkpoint.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..train.loop import SupervisedTrainer
from .common import (base_parser, build_dataset, class_names, dino_config,
                     load_cfg, scales_of)


def main(argv: Optional[Sequence[str]] = None) -> SupervisedTrainer:
    args = base_parser(__doc__).parse_args(argv)
    cfg = load_cfg(args)
    names = class_names(cfg)
    data = cfg["data"]
    train = build_dataset(data["train_ann"], data["train_prefix"], names)
    val = None
    if data.get("val_ann"):
        val = build_dataset(data["val_ann"], data["val_prefix"], names,
                            train=False)

    sched = cfg["schedule"]
    trainer = SupervisedTrainer(
        dino_config(cfg), train, val,
        work_dir=cfg["work_dir"],
        total_steps=sched["total_steps"],
        batch_size=sched.get("batch_size", 16),
        lr=cfg["optimizer"]["lr"],
        lr_boundaries=tuple(sched.get("lr_boundaries", ())),
        warm_up_step=cfg.get("ssod", {}).get("warm_up_step", 0),
        eval_interval=cfg.get("eval_interval", 4000),
        ckpt_interval=cfg.get("ckpt_interval", 4000),
        bucket=tuple(cfg.get("bucket", (800, 1344))),
        scales=scales_of(cfg),
        seed=cfg.get("seed", 0),
        backbone_init=cfg.get("backbone_init"),
        load_from=cfg.get("load_from"),
        multi_bucket=bool(cfg.get("multi_bucket", False)),
        fsdp=bool(cfg.get("fsdp", False)),
        tp=int(cfg.get("tp", 1)),
        donate=bool(cfg.get("donate", False)),
        # opt-in reference-exact per-GPU cls avg factor (its
        # samples_per_gpu); default None = the global factor
        cls_avg_group=cfg.get("cls_avg_group"),
        device=args.device,
        log_interval=int(cfg.get("log_interval", 50)),
        use_wandb=bool(cfg.get("use_wandb", False)))
    if args.resume_from:
        trainer.resume(args.resume_from)
    elif trainer.ckpt.latest_step() is not None:
        trainer.resume()
    trainer.train(max_steps=args.max_steps)
    return trainer


if __name__ == "__main__":
    main()
