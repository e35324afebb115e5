"""The supervised DINO train step.

Counterpart of `semi_detr_tpu/train/supervised.py`: one iteration of the
supervised path (reference `tools/train_detr_od.py` ->
`DINODETRHead.forward_train`): EMA of the teacher (before the update, as
`mean_teacher.py:37-50`), CDN noise, forward, `detection_loss`, backward,
global-norm clip, AdamW. `warm_up` picks O2M + task-aligned focal loss
(True) or Hungarian + focal loss (False), the reference's `in_warm_up`.

The CDN noise of step t comes from a generator seeded by (seed, t), as the
JAX step folds the step into its key, unless the caller passes one.

Data parallel (`parallel.dist`): with W ranks of B images the step computes
the JAX step's result on the global batch of W * B images: each rank draws
the global batch's CDN noise and keeps its rows, the CDN partition and the
loss factors are global, the gradients are summed before the clip, and
the logged losses are the global batch's. Sharded
(`parallel.sharding`), the same step over the layout's shards.

Each part of a step runs under a `torch.profiler.record_function` span
(train.ema, train.forward_loss, train.backward, train.optimizer; the
Hungarian solve adds hungarian.solve_batch), which
`tools/profile_train.py` reads; outside a profiler they cost nothing
measurable.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from torch.profiler import record_function

from ..models.criterion import detection_loss
from ..parallel import dist
from .state import TrainState, ema_update


def global_losses(losses: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Detached float32 losses summed over the ranks in one collective:
    each rank's loss is its share of the global batch's."""
    keys = list(losses)
    vals = dist.all_sum(torch.stack([losses[k].detach().float()
                                     for k in keys]))
    return dict(zip(keys, vals.unbind(0)))


def loss_and_grads(model, batch: Dict[str, Any], warm_up: bool,
                   generator: Optional[torch.Generator] = None,
                   extra_queries=None, cls_group: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
    """Forward and `detection_loss` of one batch (images, img_hw, gt), then
    the backward into the parameters' .grad. The CDN block comes from gt
    and `generator`, or prebuilt from `extra_queries` (with its cdn
    entry). Returns the loss dict."""
    with record_function("train.forward_loss"):
        out = model(batch["images"], batch["img_hw"], gt=batch["gt"],
                    generator=generator, extra_queries=extra_queries)
        losses = detection_loss(out, batch["gt"], model.cfg.num_classes,
                                warm_up, cls_group=cls_group)
    with record_function("train.backward"):
        losses["total"].backward()
    return losses


def make_supervised_train_step(warm_up: bool = False,
                               ema_momentum: float = 0.999,
                               ema_warm: int = 0, seed: int = 0,
                               cls_avg_group: Optional[int] = None):
    """Returns step(state, batch, generator=None) -> metrics, which
    updates `state` in place.

    batch: {images (B,H,W,3) uint8 or float, img_hw (B,2),
            gt: {boxes (B,G,4) cxcywh-normalized, labels (B,G), valid
            (B,G)}} on the model's device (`data.pipeline.to_device`).
    cls_avg_group: opt-in reference-exact per-GPU cls avg factor (images
    per reference GPU); None keeps the global factor.
    metrics: the loss dict with `total_loss`, and `grad_norm`, the norm of
    the trainable gradients before the clip (0-d tensors on the device).
    """
    def step(state: TrainState, batch: Dict[str, Any],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        model = state.model
        if generator is None:                 # seeded by (seed, step)
            generator = torch.Generator(
                device=batch["images"].device).manual_seed(
                    (seed << 32) + state.step)
        if state.teacher is not None:
            with record_function("train.ema"):
                ema_update(state.teacher, model, state.step, ema_momentum,
                           ema_warm)
        state.optimizer.zero_grad()
        losses = loss_and_grads(model, batch, warm_up, generator,
                                cls_group=cls_avg_group)
        with record_function("train.optimizer"):
            grad_norm = state.optimizer.step(state.step)
        state.step += 1
        metrics = global_losses(losses)
        metrics["total_loss"] = metrics.pop("total")
        metrics["grad_norm"] = grad_norm
        return metrics

    return step
