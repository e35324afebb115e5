"""Train state: the student model, its optimizer, an optional EMA teacher
copy, the SSOD projector when there is one, and the step.

Counterpart of `semi_detr_tpu/train/state.py`:
* the teacher is an EMA copy of the student, updated before every train
  iteration (`detr_ssod/utils/hooks/mean_teacher.py:37-64`) with the
  momentum ramp m = min(momentum, 1 - (1 + warm) / (step + 1 + warm));
* at step 0 the ramp gives m = 0, so the teacher becomes an exact clone.
The update runs in place on the teacher's float32 parameters. Under data
parallelism every rank updates its teacher from identical parameters;
`check_replicas` holds the ranks to that cheaply. Sharded
(`parallel.sharding`), the teacher is laid out like the student and the
update runs on the local shards, pairs taken by parameter order.

The update runs in place and makes its products `optim.UPDATE_CHUNK`
elements at a time (`train.optim`: what the JAX steps' `donate_argnums`
buys), rounded as one call over the state would round them.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..models.dino_head import DinoConfig, DINODetector
from ..models.ssod import Projector, SsodConfig
from ..parallel import dist, sharding
from ..utils.config import load_config
from .optim import GroupedAdamW, chunk_slices, make_optimizer


@dataclass
class TrainState:
    step: int                         # curr_step of the reference
    model: nn.Module                  # the student
    optimizer: GroupedAdamW
    teacher: Optional[nn.Module] = None   # EMA copy; None when unused
    projector: Optional[nn.Module] = None  # SSOD consistency projector

    @classmethod
    def create(cls, model: nn.Module, optimizer: GroupedAdamW,
               with_teacher: bool = True,
               projector: Optional[nn.Module] = None) -> "TrainState":
        """The teacher is a copy of the detector only."""
        teacher = None
        if with_teacher:
            teacher = copy.deepcopy(model)
            teacher.requires_grad_(False)
        return cls(step=0, model=model, optimizer=optimizer,
                   teacher=teacher, projector=projector)


def _optimizer(cfg, model, head_modules=()) -> GroupedAdamW:
    """The config's `optimizer` section and `schedule.lr_boundaries`."""
    o = cfg["optimizer"]
    return make_optimizer(model, base_lr=o["lr"],
                          weight_decay=o["weight_decay"],
                          backbone_lr_mult=o["backbone_lr_mult"],
                          clip_norm=o["clip_norm"],
                          lr_boundaries=cfg["schedule"]["lr_boundaries"],
                          head_modules=head_modules)


def _detector(cfg, device, seed: int) -> DINODetector:
    m = {k: v for k, v in cfg["model"].items() if k != "type"}
    return DINODetector(DinoConfig(**m)).init_weights(seed=seed).to(device)


def init_train_state(config: str, device="cuda", seed: int = 0,
                     with_teacher: bool = True,
                     cfg_options: Optional[Dict[str, Any]] = None
                     ) -> TrainState:
    """The supervised train state of a config file of the repo's
    `configs/`: the detector with the JAX package's seeded init (float32
    parameters, computing in the config's dtype) on `device`, the
    optimizer from the config's `optimizer` section and
    `schedule.lr_boundaries`, and the EMA teacher."""
    cfg = load_config(config, cfg_options)
    model = _detector(cfg, device, seed)
    return TrainState.create(model, _optimizer(cfg, model), with_teacher)


def init_ssod_state(config: str, device="cuda", seed: int = 0,
                    cfg_options: Optional[Dict[str, Any]] = None):
    """The SSOD train state of a `configs/detr_ssod` file: the detector as
    in `init_train_state`, the Projector (float32, the JAX package's
    initializers, drawn from seed + 1), the optimizer over both (the
    projector in the head group) and the EMA teacher, a copy of the
    detector. Returns (state, SsodConfig)."""
    cfg = load_config(config, cfg_options)
    model = _detector(cfg, device, seed)
    scfg = SsodConfig(dino=model.cfg, **cfg.get("ssod", {}))
    projector = Projector(model.cfg.d_model).init_weights(
        torch.Generator().manual_seed(seed + 1)).to(device)
    state = TrainState.create(model, _optimizer(cfg, model, (projector,)),
                              projector=projector)
    return state, scfg


def refine_boxes(det: DINODetector, seed: int) -> DINODetector:
    """Fill the last layer of both box MLPs, which the seeded init zeroes,
    from a seeded draw: every box then goes through the decoder's
    refinement instead of staying an encoder proposal (the setup of
    `chip_smoke.py` and `tools/profile_train.py`)."""
    g = torch.Generator().manual_seed(seed)
    head = det.bbox_head
    with torch.no_grad():
        for reg in (head.fc_reg[0], head.fc_enc_reg):
            for p in (reg.layers[-1].weight, reg.layers[-1].bias):
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    return det


def ema_momentum(step: int, momentum: float = 0.999, warm_up: int = 0,
                 decay_intervals: Sequence[int] = (),
                 decay_factor: float = 0.1) -> np.float32:
    """Reference `MeanTeacher` momentum at `step`, in float32 as the JAX
    package computes it: min(momentum, 1 - (1+warm)/(step+1+warm)).

    `decay_intervals`/`decay_factor` reproduce `after_train_iter`
    (`mean_teacher.py:52-57`), which divides 1 - m by
    f^bisect_right(intervals, step) every iteration, cumulatively; closed
    form 1 - m(t) = (1 - m0) / f^E(t), E(t) = sum_i max(0, t - interval_i).
    """
    f32 = np.float32
    stepf = f32(step)
    m0 = f32(momentum)
    if decay_intervals:
        iv = np.asarray(decay_intervals, np.float32)
        exponent = np.maximum(stepf - iv, f32(0)).sum(dtype=np.float32)
        m0 = f32(1) - (f32(1) - m0) * f32(decay_factor) ** (-exponent)
    ramp = f32(1) - f32(1.0 + warm_up) / (stepf + f32(1) + f32(warm_up))
    return min(m0, ramp)


@torch.no_grad()
def ema_update(teacher: nn.Module, student: nn.Module, step: int,
               momentum: float = 0.999, warm_up: int = 0,
               decay_intervals: Sequence[int] = (),
               decay_factor: float = 0.1) -> np.float32:
    """teacher <- m * teacher + (1 - m) * student, parameter by parameter
    (`mean_teacher.py:60-64`), rounded as the JAX formula t*m + s*(1-m):
    each product, then the sum, the products s * (1 - m) made UPDATE_CHUNK
    elements at a time. Sharded, on the local shards. Returns m."""
    m = ema_momentum(step, momentum, warm_up, decay_intervals, decay_factor)
    one_minus = float(np.float32(1) - m)
    sharding.reshard(teacher, student)
    t_params = [sharding.local(t) for t in teacher.parameters()]
    s_params = [sharding.local(s).detach().to(t.dtype) for s, t in
                zip(student.parameters(), t_params)]
    torch._foreach_mul_(t_params, float(m))
    for part in chunk_slices(t_params):
        torch._foreach_add_(t_params[part], torch._foreach_mul(
            s_params[part], one_minus))
    return m


def check_replicas(state: TrainState):
    """Raise unless the ranks hold the student and teacher they should: the
    bit checksums of their first, middle and last parameters, compared
    across the ranks that hold the same part of each (every rank for a
    replicated leaf, the ranks of one shard for a sharded one; a no-op in
    one process)."""
    sharding.reshard(state.model, state.teacher)
    leaves = []
    for module in (state.model, state.teacher):
        if module is not None:
            params = list(module.parameters())
            leaves += [params[0], params[len(params) // 2], params[-1]]
    keys = None
    if any(sharding.is_sharded(p) for p in leaves):
        keys = [sharding.shard_key(p) for p in leaves]
    dist.assert_replicated([sharding.local(p) for p in leaves],
                           f"the train state at step {state.step}", keys)
