"""Data parallelism (`semi_detr_tpu_torch.parallel.dist`) on the CPU: gloo
groups of 2 ranks, spawned by `dist.run_local` on 127.0.0.1 (each spawn
joined within `torch_dist_workers.SPAWN_TIMEOUT` seconds or killed, so a
hung rank fails its test), against one process on the global batch and
the JAX package. The SSOD and supervised steps on 2 ranks are held to the
JAX package in tests/test_torch_ssod_step.py and
tests/test_torch_train_step.py, beside the JAX trajectories they reuse.

* the collectives (sum, max, all-gather, bucketed sum and broadcast,
  rank rows, the replica check) and `shard_batch` against
  `mesh.shard_batch`'s per-device slices;
* the Projector's masked batch norm over 2 ranks against one process on
  the concatenated RoIs: output and parameter gradients within 1e-5
  relative;
* `gather_results` against the JAX package's own function run as two
  processes (two threads over a shared fake all-gather), and a 2-rank
  `evaluate_detector` whose mAP equals one process's exactly;
* the trainers' batch streams at rank r of 2 against the JAX trainers'
  with `jax.process_count` / `process_index` patched to (2, r), and the
  ranks' images disjoint within each step;
* the SSOD CLI on 2 ranks: parameters equal across the ranks, rank 0
  alone writes the work dir, resume reproduces the uninterrupted third
  step; the trainers refuse what the JAX trainers refuse (tp > 1 in one
  process, W % tp != 0);
* the same CLI under FSDP (2 ranks) and FSDP + TP (4 ranks, data 2 x
  model 2), with donation: each layout's checkpoint resumed data parallel,
  and a data-parallel checkpoint resumed under each layout, every run
  reproducing the uninterrupted data-parallel run's steps; under TP (tp 2,
  data 1) with an eval; the eval CLI on one checkpoint written under
  FSDP + TP, data parallel, under TP and under FSDP + TP: the same
  detections.
"""
import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

import jax

from semi_detr_tpu.models import inference as jax_inference
from semi_detr_tpu.parallel import mesh
from semi_detr_tpu_torch.data.synthetic import write_synthetic_coco
from semi_detr_tpu_torch.models.dino_head import DinoConfig, DINODetector
from semi_detr_tpu_torch.models.inference import evaluate_detector
from semi_detr_tpu_torch.parallel import dist
from semi_detr_tpu_torch.tools.common import build_dataset
from semi_detr_tpu_torch.train import loop

import torch_dist_workers as workers
from test_torch_data_stream import (FakeDs, _assert_batches,
                                    _stream_trainers)
from test_torch_trainer import MODEL, SSOD_CONFIG, SSOD_TINY

WORLD = workers.WORLD
EVAL_MODEL = dict(MODEL, dtype="float32")


def _results(rs, ids, counts):
    return {i: (rs.rand(k, 4).astype(np.float32) * 50,
                rs.rand(k).astype(np.float32),
                rs.randint(0, 3, k).astype(np.int32))
            for i, k in zip(ids, counts)}


@pytest.fixture(scope="module")
def val_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("val"))
    paths, img_dir = write_synthetic_coco(root, n=6, hw=(56, 72),
                                          max_boxes=2, distractors=1,
                                          splits={"val": range(6)})
    return paths["val"], img_dir


@pytest.fixture(scope="module")
def collectives(tmp_path_factory, val_set):
    rs = np.random.RandomState(0)
    n_roi = 6
    spec = {
        "projector": {"features": 8, "seed": 3,
                      "x": torch.from_numpy(rs.randn(n_roi, 8, 7, 7).astype(
                          np.float32)),
                      "mask": torch.tensor([1, 0, 1, 1, 1, 0], dtype=bool),
                      "w": torch.from_numpy(rs.randn(n_roi, 8).astype(
                          np.float32))},
        # ids 3 on both ranks (the later rank's entry wins), an image with
        # more than 300 detections, one with none; rank 1 has fewer images
        "results": [_results(rs, [5, 1, 3], [4, 305, 0]),
                    _results(rs, [3, 8], [2, 7])],
        "eval": {"cfg": EVAL_MODEL, "ann": val_set[0], "prefix": val_set[1],
                 "batch_size": 2, "bucket": (64, 80)},
    }
    return spec, workers.spawn(tmp_path_factory.mktemp("coll"), "collectives",
                               spec)


def test_collectives(collectives):
    _, outs = collectives
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for r, o in enumerate(outs):
        assert torch.equal(o["sum"], 3 * x)
        assert torch.equal(o["max"], torch.tensor([2, 7]))
        assert torch.equal(o["gather"], torch.stack([x, 2 * x]))
        assert torch.equal(o["cat"], torch.tensor([[-1, 7], [2, 6]]))
        assert [t.tolist() for t in o["bucketed"]] == [
            [5.0] * 2, [15.0] * 7, [7.0] * 3, [[3, 3], [3, 3]]]
        assert o["bucketed"][3].dtype == torch.int64
        assert [t.tolist() for t in o["broadcast"]] == [[1.0] * 3, [6, 6]]
        assert o["rank_rows"].tolist() == list(range(4 * r, 4 * r + 4))
        assert o["mismatch_raised"]


def test_bit_checksum_sees_every_bit():
    x = torch.linspace(-1, 1, 1000)
    ref = dist.bit_checksum(x)
    assert dist.bit_checksum(x.clone()) == ref
    y = x.clone()
    y[500] = torch.nextafter(y[500], torch.tensor(2.0))    # one ulp
    assert dist.bit_checksum(y) != ref
    assert dist.bit_checksum(x.flip(0)) != ref               # an order
    assert dist.bit_checksum(torch.tensor([0.0])) != dist.bit_checksum(
        torch.tensor([-0.0]))
    assert dist.bit_checksum(torch.arange(5)) != dist.bit_checksum(
        torch.arange(5).flip(0))


def test_shard_batch_matches_mesh_slices():
    batch = {"images": np.arange(4 * 6, dtype=np.float32).reshape(4, 6),
             "gt": {"valid": np.arange(4) % 3 == 0}}
    m = mesh.make_mesh((WORLD,), devices=jax.devices()[:WORLD])
    sharded = mesh.shard_batch(batch, m)
    for path in (("images",), ("gt", "valid")):
        arr, ref = sharded, batch
        for k in path:
            arr, ref = arr[k], ref[k]
        shards = sorted(arr.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        for r, s in enumerate(shards):
            got = dist.shard_batch(batch, r, WORLD)
            for k in path:
                got = got[k]
            np.testing.assert_array_equal(got, np.asarray(s.data))
    with pytest.raises(ValueError, match="does not split"):
        dist.shard_batch(batch, 0, 3)


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def test_projector_batch_norm_is_global(collectives):
    spec, outs = collectives
    ref = workers.projector_case(spec["projector"])
    got = torch.cat([o["projector"]["out"] for o in outs])
    assert _rel(got, ref["out"]) <= 1e-5
    for name, g in ref["grads"].items():
        if name == "fc1.bias":
            # it feeds a batch norm: its true gradient is 0, float noise
            # on both sides
            for o in outs:
                assert o["projector"]["grads"][name].norm() <= 1e-6 * \
                    ref["grads"]["fc1.weight"].norm()
            continue
        assert g.norm() > 0, name
        for o in outs:
            assert _rel(o["projector"]["grads"][name], g) <= 1e-5, name
    # each rank alone would normalise over its own RoIs
    alone = workers.projector_case(dict(
        spec["projector"], **{k: spec["projector"][k][:3]
                              for k in ("x", "mask", "w")}))
    assert _rel(alone["out"], ref["out"][:3]) > 1e-3


def _jax_gather(per_rank):
    """The JAX package's gather_results, run as WORLD processes: one
    thread per rank over a fake process_allgather that stacks every
    thread's payload in rank order."""
    from jax.experimental import multihost_utils as mh
    barrier = threading.Barrier(WORLD, timeout=60)
    slots, outs, local = [None] * WORLD, [None] * WORLD, threading.local()

    def allgather(x, tiled=False):
        slots[local.rank] = jax.tree.map(np.asarray, x)
        barrier.wait()
        out = jax.tree.map(lambda *xs: np.stack(xs), *slots)
        barrier.wait()
        return out

    def run(r):
        local.rank = r
        outs[r] = jax_inference.gather_results(per_rank[r])

    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "process_count", lambda: WORLD)
    mp.setattr(mh, "process_allgather", allgather)
    try:
        threads = [threading.Thread(target=run, args=(r,))
                   for r in range(WORLD)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        mp.undo()
    return outs


def test_gather_results_matches_jax(collectives):
    spec, outs = collectives
    ref = _jax_gather(spec["results"])
    assert ref[0].keys() == ref[1].keys() == {1, 3, 5, 8}
    assert len(ref[0][1][1]) == 300 and len(ref[0][3][1]) == 2
    for o in outs:
        got = o["gathered"]
        assert list(got) == list(ref[0])
        for i in ref[0]:
            for a, b in zip(got[i], ref[0][i]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_nms", [False, True], ids=["topk", "nms"])
def test_rank_sliced_eval_equals_one_process(collectives, val_set, use_nms):
    spec, outs = collectives
    ev = spec["eval"]
    detector = DINODetector(DinoConfig(**ev["cfg"])).init_weights(seed=0)
    val = build_dataset(ev["ann"], ev["prefix"], ("person",), train=False)
    ref = evaluate_detector(detector, val, batch_size=ev["batch_size"],
                            use_nms=use_nms, bucket=ev["bucket"],
                            test_scale=ev["bucket"], num_classes=1)
    assert np.isfinite(ref["mAP"])
    for o in outs:
        np.testing.assert_equal(o["eval"][use_nms], ref)


def _recording(mp, calls):
    """Record the dataset indices each batch function is given."""
    for name in ("make_sup_batch", "make_unsup_batch"):
        fn = getattr(loop, name)

        def rec(rng, ds, idx, *a, _fn=fn, _name=name, **kw):
            calls.append((_name, list(idx)))
            return _fn(rng, ds, idx, *a, **kw)
        mp.setattr(loop, name, rec)


def _at_rank(monkeypatch, r):
    monkeypatch.setattr(jax, "process_count", lambda: WORLD)
    monkeypatch.setattr(jax, "process_index", lambda: r)
    monkeypatch.setattr(dist, "world", lambda: WORLD)
    monkeypatch.setattr(dist, "rank", lambda: r)


def _disjoint(per_rank, n_steps):
    for step in range(n_steps):
        sets = [set(calls[step]) for calls in per_rank]
        assert not sets[0] & sets[1], (step, sets)


@pytest.mark.parametrize("multi_bucket", [False, True])
def test_ssod_stream_at_rank_r_equals_jax(monkeypatch, multi_bucket):
    steps, idx = 6, {}
    for r in range(WORLD):
        _at_rank(monkeypatch, r)
        jt, pt = _stream_trainers(multi_bucket)
        # 1 + 2 images per rank from 4 labelled and 8 unlabelled: each
        # step's draw covers whole permutations, so the ranks' images of
        # a step never repeat one another
        for t in (jt, pt):
            t.sup_dataset, t.unsup_dataset = FakeDs(4, 0), FakeDs(8, 1)
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            _recording(mp, calls)
            got = [b for _, b in zip(range(steps), pt.batches(0))]
        ref = [b for _, b in zip(range(steps), jt.batches(0))]
        for a, b in zip(got, ref):
            _assert_batches(a, b, strong=("student_images",))
        idx[r] = {k: [c for n, c in calls if n == k]
                  for k in ("make_sup_batch", "make_unsup_batch")}
    for k in ("make_sup_batch", "make_unsup_batch"):
        _disjoint([idx[r][k] for r in range(WORLD)], steps)


def test_supervised_stream_at_rank_r_equals_jax(monkeypatch):
    from semi_detr_tpu.models.dino_head import DinoConfig as JaxDinoConfig
    from semi_detr_tpu.train.loop import SupervisedTrainer as JaxSup
    steps, idx = 6, []
    for r in range(WORLD):
        _at_rank(monkeypatch, r)
        pair = []
        for cls, dcfg in ((JaxSup, JaxDinoConfig),
                          (loop.SupervisedTrainer, DinoConfig)):
            t = cls.__new__(cls)
            t.cfg = dcfg(num_classes=1, max_gt=4)
            t.dataset, t.batch_size, t.seed = FakeDs(8, 0), 2, 5
            t.scales, t.multi_bucket, t.bucket = [(24, 32)], False, (32, 40)
            pair.append(t)
        jt, pt = pair
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            _recording(mp, calls)
            got = [b for _, b in zip(range(steps), pt.batches(0))]
        ref = [b for _, b in zip(range(steps), jt.batches(0))]
        for a, b in zip(got, ref):
            _assert_batches(a, b)
        idx.append([c for _, c in calls])
        assert all(len(c) == 2 for c in idx[-1])
    _disjoint(idx, steps)


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory, val_set):
    root = tmp_path_factory.mktemp("train")
    paths, img_dir = write_synthetic_coco(
        str(root / "coco"), n=12, hw=(56, 72), max_boxes=2, distractors=1,
        splits={"sup": range(0, 4), "unsup": range(4, 8),
                "val": range(8, 12)})
    data = [f"data.train_sup_ann={paths['sup']}",
            f"data.train_unsup_ann={paths['unsup']}",
            f"data.val_ann={paths['val']}",
            f"data.train_prefix={img_dir}", f"data.val_prefix={img_dir}"]

    def argv(work, steps, *extra):
        return [SSOD_CONFIG, "--work-dir", str(root / work), "--max-steps",
                str(steps), "--device", "cpu", "--cfg-options", *SSOD_TINY,
                *data, *extra]

    spec = {"runs": [
        ("run", argv("run", 3, "eval_interval=2", "ckpt_interval=1",
                     "image_log_interval=1")),
        ("first", argv("stopped", 2, "ckpt_interval=2")),
        ("resumed", argv("stopped", 3, "ckpt_interval=2"))]}
    return root, workers.spawn(root, "trainer", spec)


def test_trainer_ranks_stay_equal_and_resume(trainer_runs):
    _, (r0, r1) = trainer_runs
    for name, steps in (("run", [0, 1, 2]), ("first", [0, 1]),
                        ("resumed", [2])):
        assert r0[name]["timings"] == r1[name]["timings"] == steps
        for step in steps:
            a, b = r0[name]["records"][step], r1[name]["records"][step]
            # global metrics, equal parameters, disjoint data
            assert a["metrics"] == b["metrics"], (name, step)
            assert a["replicated"] and b["replicated"], (name, step)
            assert not torch.equal(a["images"], b["images"])
        assert torch.equal(r0[name]["final"], r1[name]["final"])
    # the stopped run resumed at step 2 takes the uninterrupted run's step
    # and ends with its state, to the bit
    run, resumed = r0["run"], r0["resumed"]
    assert resumed["records"][2]["metrics"] == run["records"][2]["metrics"]
    assert torch.equal(run["final"], resumed["final"])


def test_trainer_rank_zero_alone_writes(trainer_runs):
    root, (r0, r1) = trainer_runs
    assert r0["run"]["writes"] and not r1["run"]["writes"]
    work = root / "run"
    with open(work / "train.log") as f:
        log = f.read()
    assert log.count("Iter [0] ") == 1
    assert log.count("data parallel: backend gloo, world 2, rank 0") == 1
    assert "rank 1" not in log
    for tag in ("teacher", "student"):
        assert log.count(f"Eval[{tag}] iter 2: mAP=") == 1
    with open(work / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [x["step"] for x in lines] == [0]
    assert sorted(os.listdir(work / "ckpt")) == [
        "step_1.pt", "step_2.pt", "step_3.pt"]
    assert sorted(os.listdir(work / "pseudo_vis")) == [
        "step_0.jpg", "step_1.jpg", "step_2.jpg"]
    with open(root / "stopped" / "train.log") as f:
        assert f.read().count("resumed from step 2") == 1


def test_trainers_refuse_fsdp_tp_and_donation():
    """The JAX trainers' refusals (`_build_mesh`'s asserts): tp > 1 with one
    process, and a tp that does not divide the world; FSDP, TP and donation
    are otherwise accepted (`test_trainer_layouts_resume_across_layouts`
    trains under them)."""
    for kw in ({"tp": 2}, {"tp": 2, "fsdp": True, "donate": True}):
        with pytest.raises(ValueError, match="more than one process"):
            loop.SsodTrainer(None, None, None, **kw)
        with pytest.raises(ValueError, match="more than one process"):
            loop.SupervisedTrainer(None, None, **kw)
    assert dist.check_layout(4, 2) == (2, 2)
    assert dist.check_layout(2, 2) == (1, 2)
    assert dist.check_layout(1, 1) == (1, 1)
    for world, tp in ((4, 3), (2, 4), (6, 4), (3, 0)):
        with pytest.raises(ValueError, match="does not divide"):
            dist.check_layout(world, tp)
    # one process: no mesh, so fsdp shards nothing (JAX's mesh is None)
    assert dist.make_mesh(1) is None and dist.world() == 1


def test_maybe_initialize_distributed(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert dist.maybe_initialize_distributed("cpu") is None
    assert dist.backend() is None and dist.world() == 1
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(dist.free_port()))
    # no card at LOCAL_RANK: no silent modulo onto the cards there are
    with pytest.raises(RuntimeError, match="not one of the 0 CUDA devices"):
        dist.maybe_initialize_distributed()
    try:
        assert dist.maybe_initialize_distributed("cpu") == torch.device(
            "cpu")
        assert (dist.backend(), dist.world(), dist.rank()) == ("gloo", 1, 0)
        assert dist.maybe_initialize_distributed("cpu") is None
        assert torch.equal(dist.all_cat(torch.ones(2)), torch.ones(2))
    finally:
        dist.destroy()
    assert dist.backend() is None


LAYOUT_TIMEOUT = 420


@pytest.fixture(scope="module")
def layout_runs(tmp_path_factory, trainer_runs):
    """On the trainer_runs set, every run's checkpoint at step 2 resumed for
    a third step on another layout. Four ranks (data 2 x model 2): FSDP +
    TP (with donation) for 2 steps, a checkpoint and an eval; the data-
    parallel checkpoint of trainer_runs resumed under FSDP + TP; the eval
    CLI under FSDP + TP on the FSDP + TP checkpoint. Then two ranks: FSDP
    for 2 steps, resumed data parallel; the data-parallel checkpoint
    resumed under FSDP; the FSDP + TP checkpoint resumed data parallel;
    TP (tp 2, data 1) for 2 steps with an eval; the eval CLI on the FSDP +
    TP checkpoint, data parallel and under TP."""
    root = tmp_path_factory.mktemp("layouts")
    coco = trainer_runs[0] / "coco"
    data = [f"data.train_sup_ann={coco / 'sup.json'}",
            f"data.train_unsup_ann={coco / 'unsup.json'}",
            f"data.val_ann={coco / 'val.json'}",
            f"data.train_prefix={coco / 'images'}",
            f"data.val_prefix={coco / 'images'}"]

    def argv(work, steps, *extra):
        return [SSOD_CONFIG, "--work-dir", str(root / work), "--max-steps",
                str(steps), "--device", "cpu", "--cfg-options", *SSOD_TINY,
                *data, "ckpt_interval=2", *extra]

    def eval_argv(work, *extra):
        return [SSOD_CONFIG, "--work-dir", str(root / work), "--device",
                "cpu", "--cfg-options", *SSOD_TINY, *data, *extra]

    def resume_from(src, work):
        """A work dir holding only `src`'s step-2 checkpoint."""
        os.makedirs(root / work / "ckpt")
        shutil.copy(src / "ckpt" / "step_2.pt", root / work / "ckpt")

    fsdp = ("fsdp=True", "donate=True")
    fsdp_tp = ("fsdp=True", "tp=2", "donate=True")
    # trainer_runs' data-parallel run stopped at step 2
    resume_from(trainer_runs[0] / "stopped", "dp_to_fsdp_tp")
    resume_from(trainer_runs[0] / "stopped", "dp_to_fsdp")
    # three CLI runs on four ranks, then seven on two: about 25 s and 40 s
    # alone, above twice that beside a loaded test run
    runs4 = workers.spawn(root, "trainer", {"runs": [
        ("fsdp_tp_first", argv("from_fsdp_tp", 2, *fsdp_tp,
                               "eval_interval=1")),
        ("fsdp_tp_resumed", argv("dp_to_fsdp_tp", 3, *fsdp_tp)),
        ("eval_fsdp_tp", eval_argv("from_fsdp_tp", "tp=2", "fsdp=True"))]},
        world=4, timeout=LAYOUT_TIMEOUT)
    resume_from(root / "from_fsdp_tp", "fsdp_tp_to_dp")
    runs2 = workers.spawn(root, "trainer", {"runs": [
        ("fsdp_first", argv("from_fsdp", 2, *fsdp, "eval_interval=1")),
        ("dp_resumed", argv("from_fsdp", 3)),
        ("fsdp_resumed", argv("dp_to_fsdp", 3, *fsdp)),
        ("dp_resumed_from_fsdp_tp", argv("fsdp_tp_to_dp", 3)),
        ("tp", argv("tp", 2, "tp=2", "eval_interval=1")),
        ("eval_dp", eval_argv("from_fsdp_tp")),
        ("eval_tp", eval_argv("from_fsdp_tp", "tp=2"))]},
        timeout=LAYOUT_TIMEOUT)
    # the checkpoints (~0.4 GB each: a full ResNet-50 per copy) are read
    # no more; the logs stay
    for work in ("from_fsdp_tp", "dp_to_fsdp_tp", "dp_to_fsdp", "from_fsdp",
                 "fsdp_tp_to_dp", "tp"):
        shutil.rmtree(root / work / "ckpt")
    return root, runs4, runs2


# a step from a state written by another layout: the layouts' sums round
# differently (the metrics of the uninterrupted run's third step within
# this relative bound)
RTOL_ACROSS_LAYOUTS = 1e-4


def _near(got, want, what):
    for k, v in want.items():
        if k == "data_wait":
            continue
        assert abs(got[k] - v) <= RTOL_ACROSS_LAYOUTS * max(
            abs(v), 1e-3), (what, k, got[k], v)


def test_trainer_layouts_resume_across_layouts(trainer_runs, layout_runs):
    """Each layout's run against trainer_runs' uninterrupted data-parallel
    run: its first two steps, and every third step resumed from another
    layout's checkpoint (FSDP <-> data parallel, FSDP + TP <-> data
    parallel)."""
    _, (run0, _) = trainer_runs
    root, runs4, runs2 = layout_runs
    want = run0["run"]["records"]
    for ranks, name, steps in (
            (runs4, "fsdp_tp_first", [0, 1]), (runs4, "fsdp_tp_resumed", [2]),
            (runs2, "fsdp_first", [0, 1]), (runs2, "dp_resumed", [2]),
            (runs2, "fsdp_resumed", [2]),
            (runs2, "dp_resumed_from_fsdp_tp", [2]), (runs2, "tp", [0, 1])):
        for r in ranks:
            assert r[name]["timings"] == steps, name
            for step in steps:
                a, b = ranks[0][name]["records"][step], r[name]["records"][
                    step]
                assert a["metrics"] == b["metrics"], (name, step)
                assert b["replicated"], (name, step)
        if name != "tp":        # tp: data 1, another global batch
            for step in steps:
                _near(ranks[0][name]["records"][step]["metrics"],
                      want[step]["metrics"], (name, step))
    with open(root / "from_fsdp_tp" / "train.log") as f:
        log = f.read()
    assert "layout: mesh (data 2, model 2), fsdp=True, tp=2, donate=True" \
        in log
    assert log.count("Eval[teacher] iter 1: mAP=") == 1
    with open(root / "from_fsdp" / "train.log") as f:
        log = f.read()
    assert "layout: mesh (data 2, model 1), fsdp=True, tp=1, donate=True" \
        in log
    assert log.count("resumed from step 2") == 1
    for work in ("dp_to_fsdp_tp", "dp_to_fsdp", "fsdp_tp_to_dp"):
        with open(root / work / "train.log") as f:
            assert f.read().count("resumed from step 2") == 1, work
    # TP (the recipe's remat on): both ranks take the whole batch, and the
    # sharded teacher and student evaluate together
    with open(root / "tp" / "train.log") as f:
        log = f.read()
    assert "layout: mesh (data 1, model 2), fsdp=False, tp=2" in log
    assert log.count("Eval[student] iter 1: mAP=") == 1


def _same_detections(a, b, what):
    """Per image, each of a's detections has one in b with the same score
    and box up to the layouts' rounding; near ties may swap places, so it
    is looked for among b's neighbours in score order."""
    assert sorted(a) == sorted(b), what
    for iid in a:
        (ba, sa, la), (bb, sb, lb) = a[iid], b[iid]
        assert len(sa) == len(sb) > 0, (what, iid)
        np.testing.assert_allclose(np.sort(sa), np.sort(sb), rtol=0,
                                   atol=1e-5, err_msg=f"{what} {iid}")
        oa, ob = np.argsort(-sa, kind="stable"), np.argsort(-sb,
                                                           kind="stable")
        used = set()
        for i, ia in enumerate(oa):
            near = [ob[j] for j in range(max(0, i - 3), min(len(ob), i + 4))
                    if ob[j] not in used and lb[ob[j]] == la[ia]
                    and abs(sb[ob[j]] - sa[ia]) <= 1e-5]
            err = [np.abs(bb[j] - ba[ia]).max() for j in near]
            assert err and min(err) <= 1e-3 * max(1.0, np.abs(ba[ia]).max(
            )), (what, iid, i)
            used.add(near[int(np.argmin(err))])


def test_eval_cli_detections_across_layouts(layout_runs):
    """The eval CLI on one checkpoint (written under FSDP + TP): the same
    detections, boxes and scores per image, data parallel, under TP and
    under FSDP + TP, and the same mAP on every rank."""
    _, runs4, runs2 = layout_runs
    dp = runs2[0]["eval_dp"]
    assert any(s.max() > 0 for _, s, _ in dp["dets"].values())
    for ranks, name in ((runs2, "eval_dp"), (runs2, "eval_tp"),
                        (runs4, "eval_fsdp_tp")):
        for r in ranks:
            assert r[name]["res"]["mAP"] == ranks[0][name]["res"]["mAP"]
        _same_detections(dp["dets"], ranks[0][name]["dets"], name)
        assert abs(ranks[0][name]["res"]["mAP"] - dp["res"]["mAP"]) <= 1e-6
