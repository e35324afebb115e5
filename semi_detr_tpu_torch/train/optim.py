"""Optimizer: AdamW over the reference's parameter groups, with a global
gradient-norm clip.

Counterpart of `semi_detr_tpu/train/optim.py`, after
`configs/dino_detr/dino_detr_ssod_r50_coco_120k.py:130-139`: AdamW lr 1e-4,
weight decay 1e-4, backbone lr x0.1, global-norm clip 0.1, and mmdet's
`frozen_stages=1` (the ResNet stem and layer1 receive no updates). Over the
reference's parameter names:

* frozen: `backbone.conv1`, `backbone.bn1`, `backbone.layer1.*`; these get
  `requires_grad=False`, so they have no gradient at all;
* backbone: the rest of `backbone.*`, at lr x backbone_lr_mult;
* head: everything else, `label_enc` included, and every parameter of
  the `head_modules` (the SSOD projector, as the JAX package labels its
  `projector` subtree), whose names the rules above never see.

optax's chain (scale_by_adam, add_decayed_weights, scale_by_learning_rate)
is the same update as `torch.optim.AdamW`: p <- p - lr * (adam(g) + wd * p).
The clip is optax's `clip_by_global_norm`: grads are scaled by
max_norm / norm only when norm >= max_norm, with no eps (`clip_grad_norm_`
adds 1e-6). The norm is over the trainable gradients only, as the JAX
package's clip sees them (it zeroes the frozen ones first); the JAX step's
logged `grad_norm` also counts the frozen leaves' gradients, which the
port does not compute. A trainable parameter that got no gradient (the
projector after the SSOD warm-up) gets a zero one: optax still applies
Adam's moments and the weight decay to it, and `torch.optim.AdamW` would
skip it.

Data parallel: each rank's backward leaves the gradient of its share of
the global loss, and the step sums the trainable gradients over the ranks
(`parallel.dist.all_sum_`, flat buckets, span `dist.grad_allreduce`) before
the clip, so the norm and the clip are global as `optax.global_norm` of the
JAX step's gradient is, and every rank applies the same update. The sum runs
after the step's last backward (the SSOD step's two backwards add first);
overlapping it with the backward is later work.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from ..parallel import dist

FROZEN_PREFIXES = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")


def is_frozen(name: str) -> bool:
    """mmdet frozen_stages=1: the ResNet stem and layer1."""
    return name.startswith(FROZEN_PREFIXES)


def is_backbone(name: str) -> bool:
    return name.startswith("backbone.")


def param_group(name: str) -> str:
    return ("frozen" if is_frozen(name) else
            "backbone" if is_backbone(name) else "head")


def step_lr(base_lr: float, boundaries: Sequence[int], gamma: float = 0.1):
    """lr(count) = base_lr * gamma ** (number of boundaries <= count), in
    float32 as the JAX schedule computes it."""
    def sched(count: int) -> np.float32:
        factor = np.float32(1.0)
        for b in boundaries:
            factor = factor * np.float32(gamma if count >= b else 1.0)
        return np.float32(base_lr) * factor
    return sched


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g <- g / norm * max_norm when
    norm >= max_norm. Returns the norm before the clip (0-d float32 tensor,
    on the grads' device; no host sync)."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    under = norm < max_norm
    torch._foreach_div_(grads, torch.where(under, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(under, 1.0, max_norm))
    return norm


class GroupedAdamW:
    """AdamW with the head/backbone learning rates, the step schedule and
    the global-norm clip. Freezes the frozen group on construction."""

    def __init__(self, model: nn.Module, base_lr: float = 1e-4,
                 weight_decay: float = 1e-4, backbone_lr_mult: float = 0.1,
                 clip_norm: float = 0.1, lr_boundaries: Sequence[int] = (),
                 head_modules: Sequence[nn.Module] = ()):
        groups: Dict[str, List[nn.Parameter]] = {
            "head": [], "backbone": [], "frozen": []}
        for name, p in model.named_parameters():
            groups[param_group(name)].append(p)
        for m in head_modules:
            groups["head"].extend(m.parameters())
        for p in groups["frozen"]:
            p.requires_grad_(False)
        self.adamw = torch.optim.AdamW(
            [{"params": groups["head"], "lr_mult": 1.0},
             {"params": groups["backbone"], "lr_mult": backbone_lr_mult}],
            lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay)
        self.sched = step_lr(base_lr, lr_boundaries)
        self.clip_norm = clip_norm

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    def step(self, count: int) -> torch.Tensor:
        """Sum the gradients over the ranks, clip, then update at the
        learning rate of update `count` (0 for the first). Returns the
        trainable gradients' global norm before the clip."""
        params = [p for g in self.adamw.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        with record_function("dist.grad_allreduce"):
            dist.all_sum_(grads)
        norm = clip_by_global_norm_(grads, self.clip_norm)
        lr = self.sched(count)
        for g in self.adamw.param_groups:
            g["lr"] = float(lr * np.float32(g["lr_mult"]))
        self.adamw.step()
        return norm


# the JAX package's name for the optimizer's constructor
make_optimizer = GroupedAdamW
