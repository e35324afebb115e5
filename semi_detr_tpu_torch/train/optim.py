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

Sharded (`parallel.sharding.shard_state`): the optimizer holds each
parameter's local tensor (a shard's own storage, or the parameter itself),
so AdamW updates the shards in place and its moments are shards too. FSDP's
reduce-scatter has already summed the gradients of the leaves it shards;
the other leaves (replicated, and TP's shards, which every data rank holds
alike) are summed over the data group as in data parallel. The clip's norm
counts each element of the global gradient once: each leaf's local sum of
squares, summed over the mesh axes the leaf is split over. Before it,
every gradient but a TP shard is taken from the first rank of each model
group, so the TP ranks, which compute those alike only up to the card's
atomic sums, apply one update. `rebuilt`,
`moments_by_name` and `full_state_dict` carry the moments between layouts
as full tensors (the checkpoint holds those).

The update runs in place (AdamW, and the EMA in `train.state`), so no
second copy of the state lives across a step: what the JAX steps'
`donate_argnums` buys. Its temporaries (AdamW's denominators, the EMA's
products) are made `UPDATE_CHUNK` elements at a time, so none of them is a
copy of the whole state within the step either; the same elementwise
operations as one call over the state, so the same update to the bit.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from ..parallel import dist, sharding

FROZEN_PREFIXES = ("backbone.conv1.", "backbone.bn1.", "backbone.layer1.")

# elements per temporary of the update (64 MiB of float32; `chip_smoke.py`
# phase 8c times the update so against the whole state in one call)
UPDATE_CHUNK = 2 ** 24


def chunk_slices(tensors: Sequence[torch.Tensor]) -> List[slice]:
    """Consecutive runs of `tensors` of at most UPDATE_CHUNK elements in
    all (a larger tensor alone)."""
    out, start, size = [], 0, 0
    for i, t in enumerate(tensors):
        if i > start and size + t.numel() > UPDATE_CHUNK:
            out.append(slice(start, i))
            start, size = i, 0
        size += t.numel()
    if start < len(tensors):
        out.append(slice(start, len(tensors)))
    return out


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


@torch.no_grad()
def clip_sharded_(grads: List[torch.Tensor], axes: List[Tuple[str, ...]],
                  max_norm: float) -> torch.Tensor:
    """`clip_by_global_norm_` of local gradients laid out on the mesh:
    grads[i] is this rank's part of a leaf split over the mesh axes
    axes[i]. The squared norm sums each leaf's local squares over those
    axes' groups, so every element of the global gradient counts once."""
    sq = {}
    for g, ax in zip(grads, axes):
        sq.setdefault(frozenset(ax), []).append(
            torch.linalg.vector_norm(g.float()) ** 2)
    parts = {k: torch.stack(v).sum() for k, v in sq.items()}
    total = parts.pop(frozenset(), torch.zeros((), device=grads[0].device))
    for k, v in parts.items():
        for axis in sorted(k):
            group = (dist.data_group() if axis == "data"
                     else dist.model_group())
            v = v.clone()
            torch.distributed.all_reduce(v, group=group)
        total = total + v
    norm = total.sqrt()
    under = norm < max_norm
    torch._foreach_div_(grads, torch.where(under, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(under, 1.0, max_norm))
    return norm


class GroupedAdamW:
    """AdamW with the head/backbone learning rates, the step schedule and
    the global-norm clip. Freezes the frozen group on construction. Over a
    sharded model it holds the parameters' local tensors."""

    def __init__(self, model: nn.Module, base_lr: float = 1e-4,
                 weight_decay: float = 1e-4, backbone_lr_mult: float = 0.1,
                 clip_norm: float = 0.1, lr_boundaries: Sequence[int] = (),
                 head_modules: Sequence[nn.Module] = ()):
        self._args = (model, dict(
            base_lr=base_lr, weight_decay=weight_decay,
            backbone_lr_mult=backbone_lr_mult, clip_norm=clip_norm,
            lr_boundaries=tuple(lr_boundaries),
            head_modules=tuple(head_modules)))
        groups: Dict[str, List[Tuple[str, nn.Parameter]]] = {
            "head": [], "backbone": [], "frozen": []}
        for name, p in model.named_parameters():
            groups[param_group(name)].append((name, p))
        for i, m in enumerate(head_modules):
            groups["head"].extend((f"head{i}.{n}", p)
                                  for n, p in m.named_parameters())
        for _, p in groups["frozen"]:
            p.requires_grad_(False)
        # (name, parameter, the tensor AdamW steps) in AdamW's order
        self.params = [(n, p, sharding.local(p))
                       for g in ("head", "backbone") for n, p in groups[g]]
        self.sharded = any(sharding.is_sharded(p) for _, p, _ in self.params)
        self.adamw = torch.optim.AdamW(
            [{"params": [t for _, _, t in self.params[:len(groups["head"])]],
              "lr_mult": 1.0},
             {"params": [t for _, _, t in self.params[len(groups["head"]):]],
              "lr_mult": backbone_lr_mult}],
            lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay)
        self.sched = step_lr(base_lr, lr_boundaries)
        self.clip_norm = clip_norm

    def zero_grad(self):
        for _, p, _ in self.params:
            p.grad = None
        self.adamw.zero_grad(set_to_none=True)

    def _grads(self) -> List[torch.Tensor]:
        """The local gradient of every parameter (zeros where none), summed
        over the data group where FSDP has not already done so (all of them
        in data parallel, in flat buckets)."""
        grads, to_sum = [], []
        for _, p, t in self.params:
            g = p.grad
            if g is None:
                g = torch.zeros_like(t)
                if not sharding.is_sharded(p):
                    p.grad = g
            # FSDP's reduce-scatter has summed the leaves split over `data`
            if "data" not in sharding.sharded_axes(p):
                to_sum.append(sharding.local(g))
            grads.append(sharding.local(g))
        with record_function("dist.grad_allreduce"):
            dist.all_sum_(to_sum)
            # every gradient but a TP shard, alike over the model group
            dist.align_model_group_([
                g for (_, p, _), g in zip(self.params, grads)
                if "model" not in sharding.sharded_axes(p)])
        return grads

    def step(self, count: int) -> torch.Tensor:
        """Sum the gradients over the ranks, clip, then update at the
        learning rate of update `count` (0 for the first), UPDATE_CHUNK
        elements at a time. Returns the trainable gradients' global norm
        before the clip."""
        grads = self._grads()
        if not self.sharded:
            norm = clip_by_global_norm_(grads, self.clip_norm)
        else:
            norm = clip_sharded_(
                grads, [sharding.sharded_axes(p) for _, p, _ in self.params],
                self.clip_norm)
            for (_, _, t), g in zip(self.params, grads):
                t.grad = g
        lr = self.sched(count)
        groups = self.adamw.param_groups
        for g in groups:
            g["lr"] = float(lr * np.float32(g["lr_mult"]))
        full = [g["params"] for g in groups]
        try:
            for i, ps in enumerate(full):
                for part in chunk_slices(ps):
                    for j, g in enumerate(groups):
                        g["params"] = ps[part] if j == i else []
                    self.adamw.step()
        finally:
            for g, ps in zip(groups, full):
                g["params"] = ps
        return norm

    # ---- the moments between layouts, as full tensors

    def moments_by_name(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{parameter name: its AdamW state, moments as full tensors}; a
        collective over the mesh where the optimizer is sharded."""
        out = {}
        for name, p, t in self.params:
            st = self.adamw.state.get(t)
            if st:
                out[name] = {k: (sharding.full_tensor(v, p)
                                 if k != "step" else v.clone())
                             for k, v in st.items()}
        return out

    def rebuilt(self, moments: Dict[str, Dict[str, torch.Tensor]]
                ) -> "GroupedAdamW":
        """A new optimizer with this one's settings over the model's current
        parameters (after sharding), its state cut from `moments` (full
        tensors by name, from `moments_by_name`)."""
        model, kw = self._args
        new = GroupedAdamW(model, **kw)
        for name, p, t in new.params:
            if name in moments:
                new.adamw.state[t] = {
                    k: (v.to(t.device) if k == "step"
                        else sharding.local_slice(v, p).to(t.device))
                    for k, v in moments[name].items()}
        return new

    def full_state_dict(self) -> dict:
        """`adamw.state_dict()` with every moment a full tensor (the
        checkpoint's layout whatever the mesh; a collective where the
        optimizer is sharded)."""
        sd = self.adamw.state_dict()
        if self.sharded:
            for i, (_, p, _) in enumerate(self.params):
                if i in sd["state"]:
                    sd["state"][i] = {
                        k: (sharding.full_tensor(v, p) if k != "step" else v)
                        for k, v in sd["state"][i].items()}
        return sd


# the JAX package's name for the optimizer's constructor
make_optimizer = GroupedAdamW
