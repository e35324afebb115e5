"""Training loops: the supervised and the semi-supervised trainers.

Counterpart of `semi_detr_tpu/train/loop.py` (the reference's
IterBasedRunner and hooks, inlined into a plain loop):

* the EMA update lives inside the step;
* eval every `eval_interval` steps on the teacher and the student
  (SubModulesDistEvalHook), NMS decode in the warm-up and top-k after it;
  checkpoint every `ckpt_interval` steps, keep 5; a step logged every
  `log_interval` steps (to wandb too with `use_wandb`, where it can be
  imported); device memory every 1,000 steps and at the end of the run;
  the weight summary at the start; the pseudo-label render every
  `image_log_interval` steps;
* the warm-up -> Hungarian switch takes a second step function
  (`make_ssod_train_step(cfg, warm_up=...)`, one per stage, cached).

Host -> device: a background thread builds each numpy batch (decode,
augment, pack) and, when the device is CUDA, copies it into page-locked
memory; the loop copies it to the device with `non_blocking=True` on the
current stream, the stream the step then runs on, so the step reads the
copied data. Taking the next batch runs under the host span
`train.data_wait`, and its wall time is kept per step in `timings`.

Data parallel (`parallel.dist`, launched by `torch.distributed.run`): each
rank takes its shard of every global step's draws (the sampler's
`num_shards` / `shard_id`, the supervised stream's slice of batch_size * W
indices), as the JAX trainers' processes do, and the steps compute the
global batch's update on every rank. The state is broadcast from rank 0
after init, warm starts and resume, and the ranks' student and teacher are
checked against each other every `logger.interval` steps. Rank 0 alone
writes the log, `metrics.jsonl`, the render and the checkpoints (the ranks
wait for a save at a barrier); eval is rank-sliced and every rank gets the
same mAP.

FSDP, TP and donation (`fsdp`, `tp`, `donate`, the JAX trainers' options):
the ranks form a `(data, model)` mesh, `data = W / tp` (`dist.make_mesh`,
the JAX `_build_mesh`: tp > 1 in one process, or W % tp != 0, raises; in one
process `fsdp` shards nothing). The sampler and the supervised stream shard
by data rank, so the `tp` ranks of a model group take the same batch. After
warm starts, the resume and its broadcast, the first `train` lays the state
out (`sharding.shard_state`, the JAX `_state_sharding`); the checkpoints
stay full tensors, so a run resumes on any layout. `donate` is accepted
and changes nothing: every step updates the state in place, with bounded
temporaries (`train.optim`), which is what donation buys the JAX step.
"""
from __future__ import annotations

import itertools
import json
import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..data.augment import COCO_SCALES
from ..data.pipeline import (make_sup_batch, make_unsup_batch,
                             pick_step_bucket, pin_batch, to_device)
from ..data.sampler import SemiBalanceSampler
from ..models.dino_head import DinoConfig, DINODetector
from ..models.inference import evaluate_teacher_and_student
from ..models.ssod import Projector, SsodConfig
from ..ops import ms_deform_attn_cuda as msda
from ..parallel import dist, sharding
from ..utils.logging import (MetricsLogger, device_memory_summary,
                             get_logger, log_image_with_boxes, weight_summary)
from .checkpoint import (CheckpointManager, apply_backbone_init,
                         apply_warm_start, load_warm_start)
from .optim import make_optimizer
from .ssod import make_ssod_train_step
from .state import TrainState, check_replicas
from .supervised import make_supervised_train_step


def _pad_indices(idx, n):
    idx = list(idx)
    while len(idx) < n:
        idx.append(idx[-1] if idx else 0)
    return idx[:n]


def _bucket_for_flag(bucket, flag):
    """Aspect-ratio group -> bucket orientation: flag 1 = landscape
    (w > h) uses (H, W); flag 0 = portrait uses the transposed bucket."""
    h, w = bucket
    land = (h, w) if w >= h else (w, h)
    return land if flag == 1 else (land[1], land[0])


def prefetch(iterator, depth: int = 2, transform=None):
    """Background-thread prefetch: overlaps the host's decode, augment and
    pack with the device's steps. `transform` runs on each item in the
    worker (the trainers pin the batch there). A worker exception re-raises
    in the consumer (a swallowed loader error would end training as a clean
    end of stream), and closing the generator stops the worker and waits
    for it: a worker left inside a torch call (the pinning) when the
    interpreter exits is ended there, and the process aborts
    ("terminate called without an active exception")."""
    q = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if transform is not None:
                    item = transform(item)
                if not put(item):
                    return
            put(end)
        except BaseException as e:                      # noqa: BLE001
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()


class _Trainer:
    """What both trainers share: device, logger, checkpoints, warm starts,
    the host -> device path and the loop."""

    def _layout(self, fsdp: bool, tp: int, donate: bool):
        """The mesh of the options (raising as the JAX `_build_mesh`
        asserts), before the state or the streams read the data rank."""
        self.fsdp, self.tp, self.donate = bool(fsdp), int(tp), bool(donate)
        self.mesh = (dist.make_mesh(self.tp, self.device)
                     if self.fsdp or self.tp > 1 else dist.drop_mesh())
        self._sharded = False

    def _shard(self):
        """Lay the state out on the mesh, once (after warm starts and the
        resume's broadcast)."""
        if not self._sharded:
            sharding.shard_state(self.state, self.mesh, self.fsdp, self.tp)
            self._sharded = True
            if self.mesh is not None:
                self.logger.logger.info(
                    f"layout: mesh (data {self.mesh.size(0)}, model "
                    f"{self.mesh.size(1)}), fsdp={self.fsdp}, tp={self.tp},"
                    f" donate={self.donate}; local state "
                    f"{sharding.local_state_bytes(self.state)} bytes")

    def _setup(self, state: TrainState, work_dir: str, ckpt_interval: int,
               backbone_init, load_from, log_interval: int = 50,
               use_wandb: bool = False):
        self.state = state
        self.work_dir = work_dir
        self.logger = MetricsLogger(work_dir, interval=log_interval,
                                    use_wandb=use_wandb)
        self.ckpt = CheckpointManager(os.path.join(work_dir, "ckpt"),
                                      interval=ckpt_interval)
        # warm starts only on a fresh run: resume() overwrites them anyway
        if self.ckpt.latest_step() is None:
            if backbone_init:
                apply_backbone_init(self.state, backbone_init)
            if load_from:
                apply_warm_start(self.state, load_warm_start(load_from))
        dist.broadcast_state(self.state)
        if dist.backend() is not None:
            self.logger.logger.info(
                f"data parallel: backend {dist.backend()}, world "
                f"{dist.world()}, rank {dist.rank()}, device {self.device}")
        self._steps = {}
        # per step: {"step", "data_wait_s", "step_s"} (host clock)
        self.timings = []

    def resume(self, path: Optional[str] = None):
        """Restore the latest checkpoint from `path` (--resume-from) or the
        work dir (into the full state: before `train` lays it out)."""
        if self._sharded:
            raise RuntimeError("resume before train: the state is laid "
                               "out already")
        mgr = self.ckpt if path is None else CheckpointManager(path)
        if mgr.latest_step() is not None:
            mgr.restore(self.state)
            dist.broadcast_state(self.state)
            self.logger.logger.info(f"resumed from step {self.state.step}")
        elif path is not None:
            raise FileNotFoundError(f"--resume-from: no checkpoint in {path}")

    def _host_batch(self, batch):
        """Worker-side: pin the batch for the non-blocking copy; keep a host
        copy of the first unlabeled student image for the render."""
        vis = (batch["unsup"]["student_images"][0].copy()
               if "unsup" in batch else None)
        if self.device.type == "cuda":
            batch = pin_batch(batch)
        return batch, vis

    def _loop(self, total: int, run_step):
        self._shard()
        gen = prefetch(self.batches(start_step=self.state.step),
                       transform=self._host_batch)
        try:
            while self.state.step < total:
                step = self.state.step
                t0 = time.perf_counter()
                with record_function("train.data_wait"):
                    host, vis_img = next(gen)
                wait = time.perf_counter() - t0
                batch = to_device(host, self.device, non_blocking=True)
                metrics = run_step(step, batch, vis_img)
                self.timings.append({"step": step, "data_wait_s": wait,
                                     "step_s": time.perf_counter() - t0})
                metrics["data_wait"] = wait
                self.logger.log_step(step, metrics)
                if step % self.logger.interval == 0:
                    check_replicas(self.state)
                if step % 1000 == 0:
                    mem = device_memory_summary(self.device)
                    if mem:
                        self.logger.logger.info(f"device memory: {mem}")
                self.ckpt.maybe_save(self.state)
                if (self.val_dataset is not None and step > 0
                        and step % self.eval_interval == 0):
                    self.evaluate(step, self._warm_up(step))
        finally:
            gen.close()
        self.ckpt.maybe_save(self.state, force=True)
        mem = device_memory_summary(self.device)
        if mem:
            self.logger.logger.info(f"device memory: {mem}")
        # the process's MSDA kernel launches: the run went through them
        fwd, bwd = msda.ms_deform_attn_cuda, msda.ms_deform_attn_bwd_cuda
        self.logger.logger.info("msda launches: " + json.dumps(
            {"fwd": fwd.launches, "bwd": bwd.launches,
             "fwd_by_width": fwd.launches_by_width,
             "bwd_by_width": bwd.launches_by_width}))
        return self.state

    def evaluate(self, step: int, warm_up: bool):
        test_scale = max(self.scales) if self.scales else None
        results = evaluate_teacher_and_student(
            self.state, self.val_dataset, use_nms=warm_up,
            bucket=self.bucket, test_scale=test_scale,
            num_classes=self.num_classes)
        for tag, res in results.items():
            self.logger.log_eval(step, res, tag)
        return results


class SsodTrainer(_Trainer):
    """Semi-supervised trainer: the COCO-partial 120k recipe."""

    def __init__(self, cfg: SsodConfig, sup_dataset, unsup_dataset,
                 val_dataset=None, work_dir: str = "work_dir",
                 total_steps: int = 120000,
                 lr: float = 1e-4, lr_boundaries=(),
                 samples_per_batch: int = 5, sample_ratio=(1, 4),
                 eval_interval: int = 4000, ckpt_interval: int = 4000,
                 bucket=(800, 1344), scales=None, seed: int = 0,
                 backbone_init: Optional[str] = None,
                 load_from: Optional[str] = None,
                 multi_bucket: bool = False,
                 epoch_length: int = 7330,
                 image_log_interval: int = 2000,
                 fsdp: bool = False, tp: int = 1,
                 donate: bool = False,
                 by_prob: bool = False, device="cuda",
                 log_interval: int = 50, use_wandb: bool = False):
        self.cfg = cfg
        # reference multinomial batch mixing (semi_sampler.py:113-135)
        self.by_prob = by_prob
        if by_prob and cfg.cls_avg_groups:
            get_logger().warning(
                "cls_avg_groups with by_prob=True: per-GPU cls "
                "normalization silently degrades to the global factor on "
                "steps whose drawn sup/unsup composition is not divisible "
                "by the group size; prefer exact-ratio mixing "
                "(by_prob=False) when cls_avg_groups is set")
        self.device = torch.device(device)
        self._layout(fsdp, tp, donate)
        # pseudo-label render interval, 0 = off (reference
        # log_image_with_boxes, detr_ssod/utils/logger.py:91-161)
        self.image_log_interval = image_log_interval
        self.multi_bucket = multi_bucket
        self.epoch_length = epoch_length
        self.scales = scales
        self.sup_dataset = sup_dataset
        self.unsup_dataset = unsup_dataset
        self.val_dataset = val_dataset
        self.total_steps = total_steps
        self.eval_interval = eval_interval
        self.bucket = bucket
        self.seed = seed
        self.samples_per_batch = samples_per_batch
        self.sample_ratio = sample_ratio
        self.num_classes = cfg.dino.num_classes

        model = DINODetector(cfg.dino).init_weights(seed=seed).to(
            self.device)
        projector = Projector(cfg.dino.d_model).init_weights(
            torch.Generator().manual_seed(seed + 1)).to(self.device)
        optimizer = make_optimizer(model, base_lr=lr,
                                   lr_boundaries=lr_boundaries,
                                   head_modules=(projector,))
        self._setup(TrainState.create(model, optimizer, projector=projector),
                    work_dir, ckpt_interval, backbone_init, load_from,
                    log_interval, use_wandb)

    def _warm_up(self, step: int) -> bool:
        return step < self.cfg.warm_up_step

    def _get_step(self, warm_up: bool):
        if warm_up not in self._steps:
            self._steps[warm_up] = make_ssod_train_step(
                self.cfg, warm_up=warm_up, seed=self.seed)
        return self._steps[warm_up]

    def batches(self, start_step: int = 0):
        """Epoch-seeded batch stream (the reference's semi sampler
        reshuffles every `epoch_length` steps, semi_sampler.py:82-84).

        Resume is O(epoch): the replay skips at most epoch_length - 1
        sampler draws, and the augment and bucket generators are seeded per
        global step, so a resumed run gets the exact batches of an
        uninterrupted one."""
        r_sup, r_unsup = self.sample_ratio
        scale = self.samples_per_batch / (r_sup + r_unsup)
        n_sup = max(int(round(r_sup * scale)), 1)
        n_unsup = self.samples_per_batch - n_sup
        sampler = SemiBalanceSampler(
            len(self.sup_dataset), len(self.unsup_dataset),
            self.sup_dataset.flags, self.unsup_dataset.flags,
            self.samples_per_batch, (n_sup, n_unsup),
            epoch_length=self.epoch_length, seed=self.seed,
            by_prob=self.by_prob,
            # this rank's disjoint slice of each global step's draw, as the
            # JAX trainer's processes take theirs
            num_shards=dist.world(), shard_id=dist.rank())
        ep0, off = divmod(start_step, self.epoch_length)
        for ep in itertools.count(ep0):
            for i, (sup_idx, unsup_idx, flag) in enumerate(sampler.epoch(ep)):
                if ep == ep0 and i < off:
                    continue
                step = ep * self.epoch_length + i
                scales = self.scales
                if self.multi_bucket:
                    # per-image scales drawn from the bucket's class
                    scales, bucket = pick_step_bucket(
                        np.random.default_rng((self.seed, 99, step)),
                        self.scales or COCO_SCALES, self.bucket, flag)
                else:
                    bucket = _bucket_for_flag(self.bucket, flag)
                rng = np.random.default_rng((self.seed, 7, step))
                # by_prob: batch shapes follow the drawn composition
                b_sup = len(sup_idx) if self.by_prob else n_sup
                b_unsup = len(unsup_idx) if self.by_prob else n_unsup
                sup = make_sup_batch(rng, self.sup_dataset,
                                     _pad_indices(sup_idx, b_sup), bucket,
                                     self.cfg.dino.max_gt, scales=scales)
                unsup = make_unsup_batch(rng, self.unsup_dataset,
                                         _pad_indices(unsup_idx, b_unsup),
                                         bucket, self.cfg.dino.max_gt,
                                         scales=scales)
                sup.pop("image_ids", None)
                unsup.pop("image_ids", None)
                yield {"sup": sup, "unsup": unsup}

    def _run_step(self, step, batch, vis_img):
        metrics = self._get_step(self._warm_up(step))(self.state, batch)
        vis = metrics.pop("pseudo_vis")
        metrics.pop("pseudo_sets")
        if (self.image_log_interval and step % self.image_log_interval == 0
                and dist.is_main()):
            log_image_with_boxes(
                self.work_dir, "pseudo_vis", step, vis_img,
                vis["boxes"].cpu().numpy(), vis["labels"].cpu().numpy(),
                vis["scores"].float().cpu().numpy(),
                vis["keep"].cpu().numpy(),
                class_names=getattr(self.unsup_dataset, "classes", None))
        return metrics

    def train(self, max_steps: Optional[int] = None):
        self.logger.logger.info(
            weight_summary(self.state.model).split("TOTAL")[-1])
        total = min(self.total_steps, max_steps or self.total_steps)
        return self._loop(total, self._run_step)


class SupervisedTrainer(_Trainer):
    """Supervised DINO trainer (the 12-epoch recipe)."""

    def __init__(self, cfg: DinoConfig, dataset, val_dataset=None,
                 work_dir: str = "work_dir_sup", total_steps: int = 90000,
                 batch_size: int = 16, lr: float = 1e-4,
                 lr_boundaries=(82500,), warm_up_step: int = 0,
                 eval_interval: int = 4000, ckpt_interval: int = 4000,
                 bucket=(800, 1344), scales=None, seed: int = 0,
                 with_teacher: bool = False,
                 backbone_init: Optional[str] = None,
                 load_from: Optional[str] = None,
                 multi_bucket: bool = False,
                 fsdp: bool = False, tp: int = 1,
                 donate: bool = False,
                 cls_avg_group=None, device="cuda",
                 log_interval: int = 50, use_wandb: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self._layout(fsdp, tp, donate)
        self.cls_avg_group = cls_avg_group
        self.multi_bucket = multi_bucket
        self.scales = scales
        self.dataset = dataset
        self.val_dataset = val_dataset
        self.total_steps = total_steps
        self.batch_size = batch_size
        self.warm_up_step = warm_up_step
        self.eval_interval = eval_interval
        self.bucket = bucket
        self.seed = seed
        self.num_classes = cfg.num_classes

        model = DINODetector(cfg).init_weights(seed=seed).to(self.device)
        optimizer = make_optimizer(model, base_lr=lr,
                                   lr_boundaries=lr_boundaries)
        self._setup(TrainState.create(model, optimizer, with_teacher),
                    work_dir, ckpt_interval, backbone_init, load_from,
                    log_interval, use_wandb)

    def _warm_up(self, step: int) -> bool:
        return step < self.warm_up_step

    def _get_step(self, warm_up: bool):
        if warm_up not in self._steps:
            self._steps[warm_up] = make_supervised_train_step(
                warm_up=warm_up, seed=self.seed,
                cls_avg_group=self.cls_avg_group)
        return self._steps[warm_up]

    def batches(self, start_step: int = 0):
        """Aspect-ratio-homogeneous batches (mmdet GroupSampler): each
        batch draws from one orientation group and pads to that
        orientation's bucket.

        `start_step` replays the cheap bookkeeping (flag draw, cursors,
        bucket draw) without loading images, so a resumed run continues the
        exact schedule of an uninterrupted one; the augment generator is
        seeded per global step for the same reason. `batch_size` is per
        rank: each step draws batch_size * W indices and rank r keeps the
        r-th slice, as the JAX trainer's processes do."""
        order_rng = np.random.default_rng(self.seed)
        bucket_rng = np.random.default_rng(self.seed + 99)
        n_shards, shard = dist.world(), dist.rank()
        flags = np.asarray(self.dataset.flags)
        groups = {f: np.nonzero(flags == f)[0] for f in (0, 1)
                  if (flags == f).any()}
        perms = {f: order_rng.permutation(ids)
                 for f, ids in groups.items()}
        cursors = {f: 0 for f in groups}
        fl = list(groups)
        weights = np.asarray([len(groups[f]) for f in fl], np.float64)
        weights = weights / weights.sum()
        step = 0
        while True:
            f = int(order_rng.choice(fl, p=weights))
            idx = []
            for _ in range(self.batch_size * n_shards):
                if cursors[f] >= len(groups[f]):
                    perms[f] = order_rng.permutation(groups[f])
                    cursors[f] = 0
                idx.append(int(perms[f][cursors[f]]))
                cursors[f] += 1
            idx = idx[shard * self.batch_size:(shard + 1) * self.batch_size]
            scales = self.scales
            if self.multi_bucket:
                scales, bucket = pick_step_bucket(
                    bucket_rng, self.scales or COCO_SCALES, self.bucket, f)
            else:
                bucket = _bucket_for_flag(self.bucket, f)
            if step >= start_step:
                batch = make_sup_batch(
                    np.random.default_rng((self.seed, 7, step)),
                    self.dataset, idx, bucket, self.cfg.max_gt,
                    scales=scales)
                batch.pop("image_ids", None)
                yield batch
            step += 1

    def _run_step(self, step, batch, vis_img):
        return self._get_step(self._warm_up(step))(self.state, batch)

    def train(self, max_steps: Optional[int] = None):
        total = min(self.total_steps, max_steps or self.total_steps)
        return self._loop(total, self._run_step)
