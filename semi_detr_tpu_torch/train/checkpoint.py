"""Checkpoint and resume, and warm starts from reference `.pth` files.

Counterpart of `semi_detr_tpu/train/checkpoint.py` on `torch.save` /
`torch.load(weights_only=True)` (the reference's checkpoint subsystem):

* save every `interval` steps and keep the last `max_keep` (mmcv
  CheckpointHook, interval 4000, max_keep_ckpts=5): one file per saved step,
  `step_<N>.pt`, holding the student, the teacher, the projector, the
  optimizer state (moments and per-parameter step) and the step. A file is
  written under a temporary name and then renamed, so a run killed while
  saving leaves no half-written latest file;
* a re-save of a step already on disk is skipped (the end-of-run save
  lands on an interval step);
* resume falls back to the parameters and the step, with a fresh
  optimizer, when the saved optimizer state does not fit (the reference's
  `resume_optimizer=False` retry, `detr_ssod/apis/train.py:210-222`);
* a plain detector checkpoint warm-starts the student and the teacher (the
  reference's duplication rule, `dino_detr_ssod.py:953-978`);
* data parallel: rank 0 alone writes (and creates the directory), every
  rank waits for the save at a barrier, and every rank reads the same
  files on resume (the trainer then broadcasts rank 0's state);
* sharded (FSDP, TP): the file is the same, full tensors of the parameters,
  the teacher and the moments, gathered from the shards by every rank and
  written by rank 0. A run resumes on any layout: the trainer restores the
  full state, broadcasts it and shards it again.

Reading the JAX package's orbax directories is not supported.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional

import torch

from ..parallel import dist, sharding
from ..utils.torch_weights import split_teacher_student
from .state import TrainState

_FILE_RE = re.compile(r"step_(\d+)\.pt")


def _state_dict(module) -> Optional[Dict[str, torch.Tensor]]:
    """Full tensors on the CPU (gathered from a sharded module's shards: a
    collective)."""
    if module is None:
        return None
    sharding.reshard(module)
    return {k: sharding.full_tensor(v).detach().cpu()
            for k, v in module.state_dict().items()}


def full_blob(state: TrainState, step: int) -> dict:
    """The checkpoint's content: full tensors on the CPU, whatever the
    layout (a collective where the state is sharded)."""
    return {"step": step, "student": _state_dict(state.model),
            "teacher": _state_dict(state.teacher),
            "projector": _state_dict(state.projector),
            "optimizer": _cpu(state.optimizer.full_state_dict())}


def _cpu(sd: dict) -> dict:
    """An optimizer state dict with its tensors on the CPU."""
    return {**sd, "state": {i: {k: v.cpu() for k, v in st.items()}
                            for i, st in sd["state"].items()}}


class CheckpointManager:
    def __init__(self, directory: str, interval: int = 4000,
                 max_keep: int = 5):
        self.directory = os.path.abspath(directory)
        if dist.is_main():
            os.makedirs(self.directory, exist_ok=True)
        self.interval = interval
        self.max_keep = max_keep

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self):
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(
            _FILE_RE.fullmatch, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def maybe_save(self, state: TrainState, force: bool = False) -> bool:
        """Save when the step is due (every rank calls this at the same
        steps); returns whether this rank wrote a file."""
        step = int(state.step)
        if not force and (step == 0 or step % self.interval != 0):
            return False
        saved = False
        due = step not in self.all_steps()
        # a sharded state is gathered by every rank; rank 0 writes
        blob = (full_blob(state, step) if due and state.optimizer.sharded
                else None)
        if dist.is_main() and due:
            blob = blob or full_blob(state, step)
            tmp = self.path(step) + ".tmp"
            torch.save(blob, tmp)
            os.replace(tmp, self.path(step))
            for old in self.all_steps()[:-self.max_keep]:
                os.remove(self.path(old))
            saved = True
        dist.barrier()
        return saved

    def load(self, step: Optional[int] = None) -> dict:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)

    def restore(self, state: TrainState,
                step: Optional[int] = None) -> TrainState:
        """Load a saved step (the latest by default) into `state` in place.
        An optimizer state that does not fit the optimizer's parameters
        is dropped: the optimizer starts fresh."""
        blob = self.load(step)
        state.model.load_state_dict(blob["student"])
        if state.teacher is not None and blob["teacher"] is not None:
            state.teacher.load_state_dict(blob["teacher"])
        if state.projector is not None and blob["projector"] is not None:
            state.projector.load_state_dict(blob["projector"])
        state.step = int(blob["step"])
        if _optimizer_fits(state.optimizer.adamw, blob["optimizer"]):
            state.optimizer.adamw.load_state_dict(blob["optimizer"])
        else:
            state.optimizer.adamw.state.clear()
        return state


def _optimizer_fits(adamw: torch.optim.Optimizer, saved: dict) -> bool:
    """The saved groups hold as many parameters as the optimizer's, and
    every saved moment has its parameter's shape."""
    groups = adamw.param_groups
    if len(saved["param_groups"]) != len(groups):
        return False
    for g, sg in zip(groups, saved["param_groups"]):
        if len(g["params"]) != len(sg["params"]):
            return False
        for p, i in zip(g["params"], sg["params"]):
            st = saved["state"].get(i, {})
            if "exp_avg" in st and st["exp_avg"].shape != p.shape:
                return False
    return True


def duplicate_into_teacher(state: TrainState) -> TrainState:
    """Warm-start rule: a plain detector checkpoint (student only) is
    duplicated into the teacher (`dino_detr_ssod.py:963-968`)."""
    state.teacher.load_state_dict(state.model.state_dict())
    return state


def load_warm_start(path: str) -> dict:
    """Detector weights for `load_from` warm starts: {"student", "teacher",
    "projector" (or None)} state dicts on the CPU.

    `path` is a reference-layout `.pth` (a plain detector, duplicated into
    both copies, or an SSOD wrapper with teacher./student. prefixes and its
    projector), or one of this package's checkpoint files or directories."""
    if os.path.isdir(path):
        return CheckpointManager(path).load()
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "student" in sd and "teacher" in sd:           # this package's file
        return sd
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)
          and not k.endswith("num_batches_tracked")}
    teacher, student, rest = split_teacher_student(sd)
    projector = {k[len("projector."):]: v for k, v in rest.items()
                 if k.startswith("projector.")}
    return {"student": student, "teacher": teacher,
            "projector": projector or None}


def _load_detector(module, sd):
    """Load a detector state dict; keys the module has no place for
    (wrapper aliases) are ignored, a missing one raises."""
    missing, _ = module.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys, e.g. "
                       f"{missing[:3]}")


def apply_warm_start(state: TrainState, loaded: dict) -> TrainState:
    """Install `load_warm_start` output into `state` in place: the student,
    the teacher where the state has one, and the projector where both have
    one."""
    _load_detector(state.model, loaded["student"])
    if state.teacher is not None:
        _load_detector(state.teacher, loaded["teacher"] or loaded["student"])
    if state.projector is not None and loaded.get("projector"):
        state.projector.load_state_dict(loaded["projector"])
    return state


def apply_backbone_init(state: TrainState, path: str) -> TrainState:
    """Install torchvision ResNet-50 weights (reference `init_cfg
    checkpoint='torchvision://resnet50'`,
    `configs/dino_detr/dino_detr_ssod_r50_coco_120k.py:16-18`) from a local
    `.pth` into the student's backbone and the teacher's."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)
          and not k.startswith("fc.")
          and not k.endswith("num_batches_tracked")}
    for model in (state.model, state.teacher):
        if model is not None:
            missing, unexpected = model.backbone.load_state_dict(
                sd, strict=False)
            if missing or unexpected:
                raise KeyError(f"{path}: not a torchvision ResNet-50 state "
                               f"dict (missing {missing[:3]}, unexpected "
                               f"{unexpected[:3]})")
    return state
