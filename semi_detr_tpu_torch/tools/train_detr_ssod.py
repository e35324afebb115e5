"""Semi-supervised training entry (reference: tools/train_detr_ssod.py).

    python -m semi_detr_tpu_torch.tools.train_detr_ssod \
        configs/detr_ssod/semi_detr_r50_coco_120k.py \
        --cfg-options fold=1 percent=10 [--device cpu]

Resumes from `work_dir/ckpt` when it holds a checkpoint.
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..train.loop import SsodTrainer
from .common import (base_parser, build_dataset, class_names, load_cfg,
                     scales_of, ssod_config)


def main(argv: Optional[Sequence[str]] = None) -> SsodTrainer:
    args = base_parser(__doc__).parse_args(argv)
    cfg = load_cfg(args)
    names = class_names(cfg)
    data = cfg["data"]
    sup = build_dataset(data["train_sup_ann"], data["train_prefix"], names)
    unsup = build_dataset(data["train_unsup_ann"],
                          data.get("unsup_prefix", data["train_prefix"]),
                          names, train=False)
    val = None
    if data.get("val_ann"):
        val = build_dataset(data["val_ann"], data["val_prefix"], names,
                            train=False)

    sched = cfg["schedule"]
    trainer = SsodTrainer(
        ssod_config(cfg), sup, unsup, val,
        work_dir=cfg["work_dir"],
        total_steps=sched["total_steps"],
        lr=cfg["optimizer"]["lr"],
        lr_boundaries=tuple(sched.get("lr_boundaries", ())),
        samples_per_batch=sched.get("samples_per_batch", 5),
        sample_ratio=tuple(sched.get("sample_ratio", (1, 4))),
        by_prob=bool(sched.get("by_prob", False)),
        eval_interval=cfg.get("eval_interval", 4000),
        ckpt_interval=cfg.get("ckpt_interval", 4000),
        bucket=tuple(cfg.get("bucket", (800, 1344))),
        scales=scales_of(cfg),
        seed=cfg.get("seed", 0),
        backbone_init=cfg.get("backbone_init"),
        load_from=cfg.get("load_from"),
        multi_bucket=bool(cfg.get("multi_bucket", False)),
        epoch_length=int(sched.get("epoch_length", 7330)),
        image_log_interval=int(cfg.get("image_log_interval", 2000)),
        fsdp=bool(cfg.get("fsdp", False)),
        tp=int(cfg.get("tp", 1)),
        donate=bool(cfg.get("donate", False)),
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
