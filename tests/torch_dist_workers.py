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
from semi_detr_tpu_torch.parallel import dist, sharding
from semi_detr_tpu_torch.train import optim
from semi_detr_tpu_torch.train.ssod import make_ssod_train_step
from semi_detr_tpu_torch.train.state import TrainState
from semi_detr_tpu_torch.train.supervised import (global_losses,
                                                  loss_and_grads)


# each spawn is joined within this many seconds or killed, so a hung rank
# fails its test
SPAWN_TIMEOUT = 120
WORLD = 2


def spawn(tmp_path, body, spec, world=WORLD, timeout=SPAWN_TIMEOUT):
    """Run BODIES[body] on `world` gloo ranks, joined within `timeout`
    seconds; their results, by rank. The files that carry the spec and the
    results are removed once read."""
    spec_path = str(tmp_path / f"{body}_spec.pt")
    out = str(tmp_path / f"{body}_rank%d.pt")
    torch.save(spec, spec_path)
    try:
        dist.run_local(rank_main, world, (body, spec_path, out),
                       timeout=timeout)
        return [torch.load(out % r, weights_only=False)
                for r in range(world)]
    finally:
        for path in [spec_path] + [out % r for r in range(world)]:
            if os.path.exists(path):
                os.remove(path)


def rank_main(rank, world, init_method, body, spec_path, out):
    """Spawned rank: join the group, run BODIES[body](rank, spec) on the
    spec the test saved, save the result to out % rank, leave. A spec with
    a `layout` ({"fsdp", "tp"}) makes the (data, model) mesh first."""
    torch.set_num_threads(1)
    dist.init_distributed("gloo", "cpu", rank, world, init_method)
    try:
        spec = torch.load(spec_path, weights_only=False)
        if spec.get("layout"):
            dist.make_mesh(spec["layout"]["tp"], "cpu")
        torch.save(BODIES[body](rank, spec), out % rank)
    finally:
        dist.destroy()


def _shard(batch):
    return dist.shard_batch(batch, dist.rank(), dist.world())


def _grads(modules):
    """{prefix + name: gradient (zeros where None)} of every parameter, the
    full tensors of a sharded one."""
    out = {}
    for prefix, m in modules.items():
        for name, p in m.named_parameters():
            out[prefix + name] = (
                torch.zeros(p.shape) if p.grad is None
                else sharding.full_tensor(p.grad).detach().clone())
    return out


def _sd(module):
    sharding.reshard(module)
    return {k: sharding.full_tensor(v).detach().clone()
            for k, v in module.state_dict().items()}


def replicated(modules):
    """Every rank holds the modules' state to the bit (the ranks of one
    shard, for a sharded leaf); raises otherwise (a no-op without a
    group)."""
    sharding.reshard(*modules)
    leaves = [t for m in modules for t in m.state_dict().values()]
    dist.assert_replicated([sharding.local(t) for t in leaves],
                           "the ranks' state",
                           [sharding.shard_key(t) for t in leaves])
    return True


def _global_grads(model):
    """{name: the global batch's gradient}, full tensors, before the
    optimizer's step: summed over the data ranks here, but where FSDP's
    reduce-scatter summed them already (the gradients stay as they are)."""
    out = {}
    for name, p in model.named_parameters():
        g = p.grad
        if g is None:
            out[name] = torch.zeros(p.shape)
        elif "data" in sharding.sharded_axes(g):
            out[name] = sharding.full_tensor(g).clone()
        else:
            out[name] = sharding.full_tensor(
                dist.all_sum(sharding.local(g)), g).clone()
    return out


def _lay_out(state, spec):
    """The state on the spec's layout (the mesh rank_main made), the frozen
    leaves taking gradients again (for the JAX step's grad_norm): the
    rebuilt optimizer freezes them. Returns the frozen leaves."""
    layout = spec.get("layout")
    if layout:
        sharding.shard_state(state, dist.mesh(), layout["fsdp"],
                             layout["tp"])
    frozen = [p for n, p in state.model.named_parameters()
              if optim.param_group(n) == "frozen"]
    for p in frozen:
        p.requires_grad_(True)
    return frozen


def _summed(grads):
    """The frozen leaves' gradients summed over the data ranks: FSDP's
    reduce-scatter did it for the leaves it shards."""
    plain = [g for g in grads if not sharding.is_sharded(g)]
    dist.all_sum_(plain)
    return [sharding.full_tensor(g) for g in grads]


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
    CDN noise (or the step's own seeded draw), on the spec's layout. With
    `full`, the cases that carry noise also return the parameters and
    gradients (full tensors, gathered by every rank)."""
    out = []
    for case in spec["cases"]:
        state, frozen = ssod_state(spec["cfg"], case["state"])
        if spec.get("layout"):
            frozen = _lay_out(state, spec)
        pcfg = SsodConfig(dino=DinoConfig(**spec["cfg"]),
                          score_thr=case["score_thr"], **spec["ssod_kw"])
        noises = case["noises"]
        if noises is not None:
            noises = [CdnNoise(*map(dist.rank_rows, n)) for n in noises]
        pm = make_ssod_train_step(pcfg, case["warm_up"])(
            state, _shard(spec["batch"]), noises=noises)
        fg = _summed([p.grad for p in frozen])
        rec = dict(
            metrics={k: float(v) for k, v in pm.items()
                     if k not in ("pseudo_vis", "pseudo_sets")},
            sets={k: v.clone() for k, v in pm["pseudo_sets"].items()},
            vis_keep=pm["pseudo_vis"]["keep"].clone(),
            frozen_sq=sum(float((g.double() ** 2).sum()) for g in fg),
            replicated=replicated((state.model, state.teacher,
                                   state.projector)),
            data_rank=dist.rank(), data_world=dist.world())
        if case["noises"] is not None and (full or spec.get("layout")):
            tensors = dict(
                student=_sd(state.model), teacher=_sd(state.teacher),
                projector=_sd(state.projector),
                grads=_grads({"": state.model, "projector.": state.projector}))
            if full:
                rec.update(tensors)
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
        if spec.get("layout"):
            state = TrainState.create(model, opt, with_teacher=False)
            sharding.shard_state(state, dist.mesh(), spec["layout"]["fsdp"],
                                 spec["layout"]["tp"])
            opt = state.optimizer
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
        grads = _global_grads(model)
        grad_norm = float(opt.step(0))
        rec = dict(losses={k: float(v) for k, v in losses.items()},
                   grad_norm=grad_norm, replicated=replicated((model,)))
        # a sharded model's tensors are gathered by every rank
        params = _sd(model) if full or spec.get("layout") else None
        if full:
            rec.update(grads=grads, params=params)
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
            if name.startswith("eval"):     # the eval CLI and its detections
                from semi_detr_tpu_torch.models import inference
                from semi_detr_tpu_torch.tools import test as test_cli
                gather, dets = inference.gather_results, []

                def gathered(results, **kw):
                    dets.append(gather(results, **kw))
                    return dets[-1]

                inference.gather_results = gathered
                try:
                    res = test_cli.main(argv)
                finally:
                    inference.gather_results = gather
                runs[name] = {"res": res, "dets": dets[0]}
                continue
            records.clear()
            t = train_detr_ssod.main(argv)
            runs[name] = {
                "records": dict(records),
                "timings": [r["step"] for r in t.timings],
                "final": torch.stack([
                    dist.bit_checksum(sharding.local(v)) for m in (
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
