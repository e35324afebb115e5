"""Rank bodies of the data-parallel tests (`tests/test_torch_dist.py` and
the 2-rank legs of `tests/test_torch_ssod_step.py` and
`tests/test_torch_train_step.py`).

Spawned processes import this module, so it imports torch and the port
only (no JAX). Each body joins a gloo group on the CPU, runs its part,
writes what the test compares to `out % rank` with `torch.save`, and
leaves the group. The `run_*` functions also run in the test process
without a group: one process on the global batch, the reference.

Even the tiny test model carries a full ResNet-50 (~94 MB of float32 per
copy), so only rank 0 returns parameters and gradients; every rank checks
in the group that the ranks hold the same state (`replicated` raises
otherwise).
"""
import copy
import os

import torch

from semi_detr_tpu_torch.models.dino_head import DinoConfig, DINODetector
from semi_detr_tpu_torch.models.dn import (CdnNoise, build_cdn_queries,
                                           cdn_attn_mask)
from semi_detr_tpu_torch.models.ssod import Projector, SsodConfig
from semi_detr_tpu_torch.parallel import dist
from semi_detr_tpu_torch.train import optim
from semi_detr_tpu_torch.train.ssod import make_ssod_train_step
from semi_detr_tpu_torch.train.state import TrainState
from semi_detr_tpu_torch.train.supervised import (global_losses,
                                                  loss_and_grads)


# each spawn is joined within this many seconds or killed, so a hung rank
# fails its test
SPAWN_TIMEOUT = 120
WORLD = 2


def spawn(tmp_path, body, spec):
    """Run BODIES[body] on WORLD gloo ranks; their results, by rank. The
    files that carry the spec and the results are removed once read."""
    spec_path = str(tmp_path / f"{body}_spec.pt")
    out = str(tmp_path / f"{body}_rank%d.pt")
    torch.save(spec, spec_path)
    try:
        dist.run_local(rank_main, WORLD, (body, spec_path, out),
                       timeout=SPAWN_TIMEOUT)
        return [torch.load(out % r, weights_only=False)
                for r in range(WORLD)]
    finally:
        for path in [spec_path] + [out % r for r in range(WORLD)]:
            if os.path.exists(path):
                os.remove(path)


def rank_main(rank, world, init_method, body, spec_path, out):
    """Spawned rank: join the group, run BODIES[body](rank, spec) on the
    spec the test saved, save the result to out % rank, leave."""
    torch.set_num_threads(1)
    dist.init_distributed("gloo", "cpu", rank, world, init_method)
    try:
        spec = torch.load(spec_path, weights_only=False)
        torch.save(BODIES[body](rank, spec), out % rank)
    finally:
        dist.destroy()


def _shard(batch):
    return dist.shard_batch(batch, dist.rank(), dist.world())


def _grads(modules):
    """{prefix + name: gradient (zeros where None)} of every parameter."""
    out = {}
    for prefix, m in modules.items():
        for name, p in m.named_parameters():
            out[prefix + name] = (torch.zeros_like(p) if p.grad is None
                                  else p.grad.detach().clone())
    return out


def _sd(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def replicated(modules):
    """Every rank holds the modules' state to the bit; raises otherwise (a
    no-op without a group)."""
    dist.assert_replicated([t for m in modules
                            for t in m.state_dict().values()],
                           "the ranks' state")
    return True


# --------------------------------------------------------------------------
# the SSOD step (test_torch_ssod_step.py)
# --------------------------------------------------------------------------

def ssod_state(cfg_kw, blob):
    """A TrainState with a projector from a checkpoint-layout blob; the
    frozen leaves take gradients (for the JAX step's grad_norm)."""
    model = DINODetector(DinoConfig(**cfg_kw)).train()
    projector = Projector(cfg_kw["d_model"])
    opt = optim.make_optimizer(model, head_modules=(projector,))
    state = TrainState.create(model, opt, projector=projector)
    model.load_state_dict(blob["student"])
    state.teacher.load_state_dict(blob["teacher"])
    projector.load_state_dict(blob["projector"])
    # a copy: the optimizer would take the blob's tensors as its own and
    # step them in place
    opt.adamw.load_state_dict(copy.deepcopy(blob["optimizer"]))
    state.step = blob["step"]
    frozen = [p for n, p in model.named_parameters()
              if optim.param_group(n) == "frozen"]
    for p in frozen:
        p.requires_grad_(True)
    return state, frozen


def run_ssod_cases(spec, full=True):
    """Each case of `spec` from its blob: one SSOD step on this rank's
    shard of the global batch, with this rank's rows of the case's global
    CDN noise (or the step's own seeded draw). With `full`, the cases that
    carry noise also return the parameters and gradients."""
    out = []
    for case in spec["cases"]:
        state, frozen = ssod_state(spec["cfg"], case["state"])
        pcfg = SsodConfig(dino=DinoConfig(**spec["cfg"]),
                          score_thr=case["score_thr"], **spec["ssod_kw"])
        noises = case["noises"]
        if noises is not None:
            noises = [CdnNoise(*map(dist.rank_rows, n)) for n in noises]
        pm = make_ssod_train_step(pcfg, case["warm_up"])(
            state, _shard(spec["batch"]), noises=noises)
        fg = [p.grad for p in frozen]
        dist.all_sum_(fg)
        rec = dict(
            metrics={k: float(v) for k, v in pm.items()
                     if k not in ("pseudo_vis", "pseudo_sets")},
            sets={k: v.clone() for k, v in pm["pseudo_sets"].items()},
            vis_keep=pm["pseudo_vis"]["keep"].clone(),
            frozen_sq=sum(float((g.double() ** 2).sum()) for g in fg),
            replicated=replicated((state.model, state.teacher,
                                   state.projector)))
        if full and case["noises"] is not None:
            rec.update(
                student=_sd(state.model), teacher=_sd(state.teacher),
                projector=_sd(state.projector),
                grads=_grads({"": state.model, "projector.": state.projector}))
        out.append(rec)
    return out


# --------------------------------------------------------------------------
# the supervised step (test_torch_train_step.py)
# --------------------------------------------------------------------------

def run_supervised_cases(spec, full=True):
    """loss_and_grads of this rank's shard with the CDN block built from
    this rank's rows of the global noise, the ranks' gradients summed,
    then the optimizer's update: global losses, the update's grad_norm,
    whether the ranks' parameters agree after it and, with `full`, the
    summed gradients before the clip and the parameters after."""
    cfg_kw, capacity = spec["cfg"], spec["capacity"]
    out = []
    for warm_up in spec["cases"]:
        model = DINODetector(DinoConfig(**cfg_kw)).train()
        model.load_state_dict(spec["state"])
        opt = optim.make_optimizer(model)
        tb = _shard(spec["batch"])
        noise = CdnNoise(*map(dist.rank_rows, spec["noise"]))
        cdn = build_cdn_queries(
            noise, tb["gt"]["boxes"], tb["gt"]["labels"], tb["gt"]["valid"],
            model.bbox_head.label_enc.weight, cfg_kw["num_classes"],
            cfg_kw["dn_single_pad"], cfg_kw["dn_groups"])
        extra = {"content": cdn.query_label, "bbox_unsig": cdn.query_bbox,
                 "attn_mask": cdn_attn_mask(cdn.single_pad, cdn.groups,
                                            cfg_kw["num_queries"],
                                            capacity=capacity),
                 "cdn": cdn}
        losses = global_losses(loss_and_grads(model, tb, warm_up,
                                              extra_queries=extra))
        grads = _grads({"": model})
        dist.all_sum_(list(grads.values()))
        grad_norm = float(opt.step(0))
        rec = dict(losses={k: float(v) for k, v in losses.items()},
                   grad_norm=grad_norm, replicated=replicated((model,)))
        if full:
            rec.update(grads=grads, params=_sd(model))
        out.append(rec)
    return out


# --------------------------------------------------------------------------
# collectives, the Projector, gather_results, eval (test_torch_dist.py)
# --------------------------------------------------------------------------

def projector_case(spec):
    """The Projector on this rank's RoIs (rows of the global x and mask):
    its output and, after a backward of a fixed weighting of the global
    output, the parameter gradients summed over the ranks."""
    projector = Projector(spec["features"]).init_weights(
        torch.Generator().manual_seed(spec["seed"]))
    x, mask, w = (dist.rank_rows(spec[k]) for k in ("x", "mask", "w"))
    out = projector(x, mask)
    (out * w).sum().backward()
    grads = _grads({"": projector})
    dist.all_sum_(list(grads.values()))
    return {"out": out.detach(), "grads": grads}


def _collectives_body(rank, spec):
    from semi_detr_tpu_torch.models.inference import (evaluate_detector,
                                                      gather_results)
    from semi_detr_tpu_torch.tools.common import build_dataset
    world = dist.world()
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (rank + 1)
    n = torch.tensor([rank * 3 - 1, 7 - rank], dtype=torch.int64)
    # several flat buckets of mixed dtypes and sizes
    dist.BUCKET_NUMEL = 5
    bucketed = [torch.full((k,), float(rank + k)) for k in (2, 7, 3)] + [
        torch.full((2, 2), rank + 1, dtype=torch.int64)]
    dist.all_sum_(bucketed)
    bcast = [torch.full((3,), float(rank)),
             torch.full((2,), rank + 5, dtype=torch.int64)]
    dist.broadcast_(bcast, src=1)
    out = {"sum": dist.all_sum(x), "max": dist.all_max(n),
           "gather": dist.all_gather(x), "cat": dist.all_cat(n[None]),
           "bucketed": bucketed, "broadcast": bcast,
           "rank_rows": dist.rank_rows(torch.arange(4 * world)),
           "projector": projector_case(spec["projector"]),
           "gathered": gather_results(spec["results"][rank])}
    ev = spec["eval"]
    detector = DINODetector(DinoConfig(**ev["cfg"])).init_weights(seed=0)
    val = build_dataset(ev["ann"], ev["prefix"], ("person",), train=False)
    out["eval"] = {nms: evaluate_detector(
        detector, val, batch_size=ev["batch_size"], use_nms=nms,
        bucket=ev["bucket"], test_scale=ev["bucket"], num_classes=1)
        for nms in (False, True)}
    try:
        dist.assert_replicated([torch.tensor([float(rank)])], "a probe")
        out["mismatch_raised"] = False
    except RuntimeError as e:
        out["mismatch_raised"] = "differs across ranks" in str(e)
    return out


# --------------------------------------------------------------------------
# the SSOD trainer through its CLI (test_torch_dist.py)
# --------------------------------------------------------------------------

def _trainer_body(rank, spec):
    from semi_detr_tpu_torch.tools import train_detr_ssod
    from semi_detr_tpu_torch.train import loop

    records = {}
    run_step = loop.SsodTrainer._run_step

    def recording_step(self, step, batch, vis_img):
        out = run_step(self, step, batch, vis_img)
        records[step] = {
            "metrics": {k: float(v) for k, v in out.items()},
            "replicated": replicated((self.state.model, self.state.teacher,
                                      self.state.projector)),
            "images": batch["unsup"]["teacher_images"].clone()}
        return out

    loop.SsodTrainer._run_step = recording_step
    try:
        runs = {}
        for name, argv in spec["runs"]:
            records.clear()
            t = train_detr_ssod.main(argv)
            runs[name] = {
                "records": dict(records),
                "timings": [r["step"] for r in t.timings],
                "final": torch.stack([
                    dist.bit_checksum(v) for m in (
                        t.state.model, t.state.teacher, t.state.projector)
                    for v in m.state_dict().values()]),
                "writes": t.logger.jsonl is not None}
    finally:
        loop.SsodTrainer._run_step = run_step
    return runs


BODIES = {"ssod": lambda rank, spec: run_ssod_cases(spec, rank == 0),
          "supervised": lambda rank, spec: run_supervised_cases(
              spec, rank == 0),
          "collectives": _collectives_body, "trainer": _trainer_body}
