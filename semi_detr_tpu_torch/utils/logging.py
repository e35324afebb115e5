"""Logging: text log, metrics JSONL, TensorBoard where it can be imported,
the weight summary, device memory and the pseudo-label render (boxes and
labels drawn to the JAX render's pixels: `draw_rect`, `utils.text`).

Counterpart of `semi_detr_tpu/utils/logging.py` (the reference's mmcv
TextLoggerHook + TensorboardLoggerHook + WandbLoggerHook,
`base_dino_detr_ssod_coco.py:254-271`, and `WeightSummary`,
`weights_summary.py:61-101`). The wandb sink, like TensorBoard, is used
only where its package can be imported (`use_wandb`, config key of the
same name). Under data parallelism rank 0 alone logs and writes files: the
other ranks' logger keeps warnings only, and their `MetricsLogger` writes
nothing.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data.image_io import write_image
from ..parallel import dist
from .text import put_text


def get_logger(name: str = "semi_detr_tpu_torch",
               log_file: Optional[str] = None) -> logging.Logger:
    """The package's logger, to stdout and, when given, to `log_file` (a
    second trainer in the process moves the file handler to its own
    work dir). On a rank other than 0: warnings only, and no file."""
    logger = logging.getLogger(name)
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if not logger.handlers:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    logger.setLevel(logging.INFO if dist.is_main() else logging.WARNING)
    if log_file and dist.is_main():
        path = os.path.abspath(log_file)
        have = [h for h in logger.handlers
                if isinstance(h, logging.FileHandler)]
        if not any(h.baseFilename == path for h in have):
            for h in have:
                logger.removeHandler(h)
                h.close()
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


def device_memory_summary(device=None) -> Optional[Dict[str, float]]:
    """Peak allocated device memory, and the card's total and headroom, in
    GiB; None on the CPU."""
    if device is None or torch.device(device).type != "cuda":
        return None
    gb = 1024 ** 3
    peak = torch.cuda.max_memory_allocated(device)
    _, total = torch.cuda.mem_get_info(device)
    return {"peak_gb": round(peak / gb, 3), "total_gb": round(total / gb, 3),
            "headroom_gb": round((total - peak) / gb, 3)}


def _scalar(v) -> Optional[float]:
    if isinstance(v, torch.Tensor):
        return float(v) if v.dim() == 0 else None
    return float(v) if np.ndim(v) == 0 else None


class MetricsLogger:
    """Text + JSONL + optional TensorBoard metric sink: `train.log` and
    `metrics.jsonl` under `work_dir`, written by rank 0 only."""

    def __init__(self, work_dir: str, use_tensorboard: bool = True,
                 interval: int = 50, use_wandb: bool = False):
        self.work_dir = work_dir
        self.enabled = dist.is_main()
        self.logger = get_logger(
            log_file=os.path.join(work_dir, "train.log"))
        self.interval = interval
        self.jsonl = self.tb = self.wandb = None
        if not self.enabled:
            return
        os.makedirs(work_dir, exist_ok=True)
        self.jsonl = open(os.path.join(work_dir, "metrics.jsonl"), "a")
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
                self.tb = SummaryWriter(os.path.join(work_dir, "tb"))
            except ImportError:
                self.logger.warning("tensorboardX unavailable; TB disabled")
        # the reference's WandbLoggerHook (`base_dino_detr_ssod_coco.py:
        # 258-268`), gated on the package being importable
        if use_wandb:
            try:
                import wandb
            except ImportError:
                self.logger.warning("wandb unavailable; wandb disabled")
            else:
                wandb.init(dir=work_dir)
                self.wandb = wandb
        self._t_last = time.perf_counter()
        self._step_last = 0

    def log_step(self, step: int, metrics: Dict[str, Any],
                 lr: Optional[float] = None, prefix: str = "train"):
        """Every `interval`-th step: the scalar metrics (one host sync),
        the mean step time since the last logged step, to all sinks."""
        if not self.enabled or step % self.interval != 0:
            return
        now = time.perf_counter()
        dt = (now - self._t_last) / max(step - self._step_last, 1)
        self._t_last, self._step_last = now, step
        scalars = {k: s for k, s in ((k, _scalar(v))
                                     for k, v in metrics.items())
                   if s is not None}
        scalars["time"] = dt
        if lr is not None:
            scalars["lr"] = lr
        msg = f"Iter [{step}] " + " ".join(
            f"{k}: {v:.4f}" for k, v in sorted(scalars.items())
            if k in ("total_loss", "grad_norm", "time", "lr",
                     "sup_loss_cls", "unsup_loss_cls", "gmm_thr",
                     "pseudo_per_img", "data_wait"))
        self.logger.info(msg)
        self.jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
        self.jsonl.flush()
        if self.tb:
            for k, v in scalars.items():
                self.tb.add_scalar(f"{prefix}/{k}", v, step)
        if self.wandb:
            self.wandb.log({f"{prefix}/{k}": v for k, v in scalars.items()},
                           step=step)

    def log_eval(self, step: int, results: Dict[str, Any],
                 tag: str = "teacher"):
        if not self.enabled:
            return
        msg = f"Eval[{tag}] iter {step}: " + " ".join(
            f"{k}={v:.4f}" for k, v in results.items()
            if isinstance(v, float))
        self.logger.info(msg)
        if self.tb:
            for k, v in results.items():
                if isinstance(v, float):
                    self.tb.add_scalar(f"eval_{tag}/{k}", v, step)
        if self.wandb:
            self.wandb.log({f"eval_{tag}/{k}": v for k, v in results.items()
                            if isinstance(v, float)}, step=step)

    def close(self):
        if self.jsonl:
            self.jsonl.close()
        if self.tb:
            self.tb.close()
        if self.wandb:
            self.wandb.finish()


def draw_rect(img: np.ndarray, x0, y0, x1, y1, color, thickness: int = 2):
    """`cv2.rectangle(img, (x0, y0), (x1, y1), color, thickness)` (LINE_8)
    in place, for thickness 1 and 2, on the `int()` of each coordinate.

    The rule, found by probing cv2 5.0 (bit-equal on 6,000 seeded boxes
    on a 60x80 image, coordinates -10..90, swapped, degenerate and
    off-image): thickness 1 paints the four edges' pixels; thickness 2
    paints each edge as a band 3 pixels wide centred on it (the edge +- 1)
    that ends at the corners, plus a plus-shaped cap (the corner and its
    four neighbours) at each corner: the filled polygon of the thick line
    and its round caps of radius 1, so each outer corner pixel stays
    unpainted. Everything clips at the image's edges."""
    if thickness not in (1, 2):
        raise ValueError(f"draw_rect draws thickness 1 or 2, not "
                         f"{thickness}")
    h, w = img.shape[:2]
    x0, x1 = sorted((int(x0), int(x1)))
    y0, y1 = sorted((int(y0), int(y1)))

    def paint(ya, yb, xa, xb):          # inclusive ranges
        ya, yb, xa, xb = max(ya, 0), min(yb, h - 1), max(xa, 0), min(xb,
                                                                     w - 1)
        if ya <= yb and xa <= xb:
            img[ya:yb + 1, xa:xb + 1] = color

    r = thickness // 2
    paint(y0 - r, y0 + r, x0, x1)
    paint(y1 - r, y1 + r, x0, x1)
    paint(y0, y1, x0 - r, x0 + r)
    paint(y0, y1, x1 - r, x1 + r)
    if r:
        for cx, cy in ((x0, y0), (x1, y0), (x0, y1), (x1, y1)):
            paint(cy - r, cy + r, cx, cx)
            paint(cy, cy, cx - r, cx + r)


def draw_detection(img: np.ndarray, box, label_text: str, color=(0, 255, 0)
                   ) -> None:
    """One detection as the JAX renders draw it, in place: the box's
    outline 2 pixels thick, then `label_text` at (x0, max(y0 - 4, 0)) in
    cv2.putText's FONT_HERSHEY_SIMPLEX at scale 0.5, thickness 1
    (`utils.text`)."""
    x0, y0, x1, y1 = (int(v) for v in box)
    draw_rect(img, x0, y0, x1, y1, color, 2)
    put_text(img, label_text, (x0, max(y0 - 4, 0)), color)


def log_image_with_boxes(work_dir: str, tag: str, step: int,
                         image: np.ndarray, boxes: np.ndarray,
                         labels: np.ndarray, scores: np.ndarray = None,
                         keep: np.ndarray = None, class_names=None,
                         denormalize: bool = True) -> str:
    """Draw the boxes and their labels onto a training image and save it as
    `work_dir/tag/step_N.jpg`: the file backend of the reference's
    `log_image_with_boxes` (detr_ssod/utils/logger.py:91-161), to eyeball
    the teacher's pseudo labels. The pixels are the JAX function's: each
    kept box's outline and its label, `name:score`, or `name` without
    scores, or the label number without class names; the JPEG is the host
    library's (quality 95, cv2.imwrite's bytes).

    image: (H, W, 3) uint8 RGB, or float normalized with the ImageNet
    mean/std (then denormalized). boxes: (P, 4) xyxy pixels; labels: (P,);
    scores: (P,) or None; keep: (P,) bool, the boxes drawn (the kept pseudo
    labels)."""
    from ..data.augment import IMG_MEAN, IMG_STD
    image = np.asarray(image)
    if denormalize and image.dtype != np.uint8:
        image = np.clip(image * IMG_STD + IMG_MEAN, 0, 255).astype(np.uint8)
    img = np.array(image, np.uint8)
    n = len(boxes)
    keep = np.ones(n, bool) if keep is None else np.asarray(keep)
    for i in range(n):
        if not keep[i]:
            continue
        name = (class_names[int(labels[i])] if class_names
                else str(int(labels[i])))
        txt = name if scores is None else f"{name}:{float(scores[i]):.2f}"
        draw_detection(img, boxes[i], txt)
    out_dir = os.path.join(work_dir, tag)
    os.makedirs(out_dir, exist_ok=True)
    return write_image(os.path.join(out_dir, f"step_{step}.jpg"), img)


def weight_summary(model) -> str:
    """Parameter table: name, shape, #params, trainable, as the reference
    WeightSummary hook, over `model.named_parameters()`."""
    lines = [f"{'name':<72}{'shape':<24}{'#params':>12}  trainable"]
    total = trainable = 0
    for name, p in model.named_parameters():
        n = p.numel()
        total += n
        trainable += n if p.requires_grad else 0
        lines.append(f"{name:<72}{str(tuple(p.shape)):<24}{n:>12}  "
                     f"{p.requires_grad}")
    lines.append(f"TOTAL: {total:,} parameters ({trainable:,} trainable)")
    return "\n".join(lines)
