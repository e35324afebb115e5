"""The port's trainers and CLIs on the CPU at tiny width, from COCO files
to checkpoints and mAP (`python -m semi_detr_tpu_torch.tools.*` with
`--device cpu`).

* the SSOD CLI for 3 steps across the warm-up boundary, with eval (NMS
  decode in the warm-up, top-k after) and checkpoints every step;
* a run stopped at step 2 and resumed reproduces the uninterrupted run's
  step-2 metrics and parameters exactly;
* the checkpoint manager keeps the newest N files, skips a re-save and
  falls back to a fresh optimizer when the saved one does not fit;
* `load_from` a reference-layout `.pth` written by the JAX package's
  `export_dino_detector` gives the student and the teacher the carried
  weights; `apply_backbone_init` installs what the JAX
  `load_backbone_from_pth` installs;
* the supervised CLI takes 2 steps, the eval CLI prints APs.
"""
import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from semi_detr_tpu.utils.torch_weights import (export_dino_detector,
                                               install_backbone,
                                               load_backbone_from_pth)
from semi_detr_tpu_torch.data.synthetic import write_synthetic_coco
from semi_detr_tpu_torch.models.resnet import ResNet
from semi_detr_tpu_torch.parallel import sharding
from semi_detr_tpu_torch.tools import test as test_cli
from semi_detr_tpu_torch.tools import train_detr_od, train_detr_ssod
from semi_detr_tpu_torch.train import checkpoint as ckpt
from semi_detr_tpu_torch.train import loop
from semi_detr_tpu_torch.train.optim import make_optimizer
from semi_detr_tpu_torch.train.state import TrainState
from semi_detr_tpu_torch.utils.torch_weights import state_dict_from_jax

from test_torch_detector import build_pair

SSOD_CONFIG = "configs/detr_ssod/semi_detr_r50_coco_120k.py"
OD_CONFIG = "configs/dino_detr/dino_detr_r50_coco.py"
MODEL = dict(d_model=32, n_heads=2, num_encoder_layers=1,
             num_decoder_layers=2, d_ffn=64, num_queries=24, dn_single_pad=4,
             dn_groups=2, max_gt=8, num_classes=1)
TINY = [f"model.{k}={v}" for k, v in MODEL.items()] + [
    "model.dtype=float32", "bucket=(64,80)", "scales=[[64,80]]",
    "data.classes=['person']"]
SSOD_TINY = TINY + ["ssod.max_pseudo=4", "ssod.cons_groups=2",
                    "ssod.warm_up_step=2", "schedule.samples_per_batch=3",
                    "schedule.sample_ratio=[1,2]"]


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    paths, img_dir = write_synthetic_coco(
        root, n=12, hw=(56, 72), max_boxes=2, distractors=1,
        splits={"sup": range(0, 4), "unsup": range(4, 8),
                "val": range(8, 12)})
    data = [f"data.train_sup_ann={paths['sup']}",
            f"data.train_unsup_ann={paths['unsup']}",
            f"data.train_ann={paths['sup']}",
            f"data.val_ann={paths['val']}",
            f"data.train_prefix={img_dir}", f"data.val_prefix={img_dir}"]
    return paths, img_dir, data


def _ssod(work, coco, steps, *extra):
    return train_detr_ssod.main(
        [SSOD_CONFIG, "--work-dir", str(work), "--max-steps", str(steps),
         "--device", "cpu", "--cfg-options", *SSOD_TINY, *coco[2], *extra])


@pytest.fixture(scope="module")
def recorded(tmp_path_factory, coco):
    """The uninterrupted 3-step SSOD run, its per-step metrics and the
    decode of each eval, recorded through the trainer's own methods."""
    work = tmp_path_factory.mktemp("ssod")
    mp = pytest.MonkeyPatch()
    metrics, decodes = {}, []
    run_step = loop.SsodTrainer._run_step
    evaluate = loop.evaluate_teacher_and_student

    def recording_step(self, step, batch, vis_img):
        out = run_step(self, step, batch, vis_img)
        metrics[step] = {k: float(v) for k, v in out.items()}
        return out

    def recording_eval(state, dataset, use_nms, **kw):
        decodes.append((state.step, use_nms))
        return evaluate(state, dataset, use_nms=use_nms, **kw)

    mp.setattr(loop.SsodTrainer, "_run_step", recording_step)
    mp.setattr(loop, "evaluate_teacher_and_student", recording_eval)
    try:
        trainer = _ssod(work, coco, 3, "eval_interval=1", "ckpt_interval=1",
                        "image_log_interval=1")
        # the resumed run of the next test, under the same recorders
        stopped = tmp_path_factory.mktemp("stopped")
        first = _ssod(stopped, coco, 2, "ckpt_interval=2")
        resumed_metrics = dict(metrics)
        metrics.clear()
        resumed = _ssod(stopped, coco, 3, "ckpt_interval=2")
        resumed_metrics = {"run": resumed_metrics, "resumed": dict(metrics)}
    finally:
        mp.undo()
    return dict(work=str(work), trainer=trainer, decodes=decodes,
                stopped=str(stopped), first=first, resumed=resumed,
                metrics=resumed_metrics)


def test_ssod_cli_across_the_warm_up(recorded):
    t, work = recorded["trainer"], recorded["work"]
    assert [r["step"] for r in t.timings] == [0, 1, 2]
    assert t.state.step == 3 and set(t._steps) == {True, False}
    assert t.ckpt.all_steps() == [1, 2, 3]
    # eval at steps 1 (warm-up: NMS) and 2 (top-k), teacher and student
    assert recorded["decodes"] == [(2, True), (3, False)]
    with open(os.path.join(work, "train.log")) as f:
        log = f.read()
    for tag in ("teacher", "student"):
        for step in (1, 2):
            assert f"Eval[{tag}] iter {step}: mAP=" in log
    with open(os.path.join(work, "metrics.jsonl")) as f:
        first = json.loads(f.readline())
    assert first["step"] == 0 and math.isfinite(first["total_loss"])
    assert first["data_wait"] >= 0
    for step in range(3):
        assert os.path.isfile(os.path.join(work, "pseudo_vis",
                                           f"step_{step}.jpg"))


def test_resume_reproduces_the_uninterrupted_run(recorded):
    first, resumed = recorded["first"], recorded["resumed"]
    assert [r["step"] for r in first.timings] == [0, 1]
    assert [r["step"] for r in resumed.timings] == [2]
    with open(os.path.join(recorded["stopped"], "train.log")) as f:
        assert "resumed from step 2" in f.read()
    # the run with eval and checkpoints every step, and the stopped one,
    # take the same steps
    run, again = recorded["metrics"]["run"], recorded["metrics"]["resumed"]
    assert again[2] == run[2]
    a = recorded["trainer"].state
    b = resumed.state
    for m1, m2 in ((a.model, b.model), (a.teacher, b.teacher),
                   (a.projector, b.projector)):
        for (k, p), (_, q) in zip(m1.state_dict().items(),
                                  m2.state_dict().items()):
            assert torch.equal(p, q), k


def _small_state(with_projector=False):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    projector = torch.nn.Linear(2, 2) if with_projector else None
    opt = make_optimizer(model, head_modules=(projector,) if projector
                         else ())
    return TrainState.create(model, opt, projector=projector)


def _step(state):
    state.optimizer.zero_grad()
    params = list(state.model.parameters()) + (
        list(state.projector.parameters()) if state.projector else [])
    sum((p ** 2).sum() for p in params).backward()
    state.optimizer.step(state.step)
    state.step += 1


def test_checkpoint_keep_n_resave_and_fallback(tmp_path):
    state = _small_state()
    mgr = ckpt.CheckpointManager(str(tmp_path / "ckpt"), interval=1,
                                 max_keep=2)
    assert not mgr.maybe_save(state)                  # step 0: never
    for _ in range(4):
        _step(state)
        assert mgr.maybe_save(state)
    assert mgr.all_steps() == [3, 4]                  # the oldest deleted
    assert not mgr.maybe_save(state, force=True)      # step 4 is on disk
    assert sorted(os.listdir(mgr.directory)) == ["step_3.pt", "step_4.pt"]

    fresh = _small_state()
    mgr.restore(fresh)
    assert fresh.step == 4
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(p, q)
    saved = state.optimizer.adamw.state_dict()["state"]
    got = fresh.optimizer.adamw.state_dict()["state"]
    assert all(torch.equal(saved[i]["exp_avg"], got[i]["exp_avg"])
               for i in saved)

    # an optimizer with another parameter set starts fresh
    other = _small_state(with_projector=True)
    mgr.restore(other)
    assert other.step == 4 and not other.optimizer.adamw.state
    for p, q in zip(state.model.parameters(), other.model.parameters()):
        assert torch.equal(p, q)

    # the warm-start rule: the teacher becomes a copy of the student
    other.teacher = torch.nn.Sequential(torch.nn.Linear(3, 4),
                                        torch.nn.Linear(4, 2))
    ckpt.duplicate_into_teacher(other)
    for p, q in zip(other.model.parameters(), other.teacher.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("layout", ["detector", "ssod_wrapper"])
def test_load_from_reference_pth(tmp_path, coco, layout):
    """A reference `.pth` exported by the JAX package: a plain detector is
    duplicated into the teacher; an SSOD wrapper's teacher and student
    load apart."""
    cfg_kw = {k: v for k, v in MODEL.items()
              if k not in ("dn_single_pad", "dn_groups", "max_gt")}
    _, jvars, port = build_pair(seed=4, cfg_kw=cfg_kw)
    sd = {k: torch.from_numpy(np.asarray(v))
          for k, v in export_dino_detector(jvars, 2).items()}
    want = state_dict_from_jax(jvars, 2)
    want_teacher = want
    if layout == "ssod_wrapper":
        teacher = {k: v + 1.0 if v.is_floating_point() else v
                   for k, v in sd.items()}
        want_teacher = {k: v + 1.0 if v.is_floating_point() else v
                        for k, v in want.items()}
        sd = {"state_dict": {**{f"teacher.{k}": v
                                for k, v in teacher.items()},
                             **{f"student.{k}": v for k, v in sd.items()}}}
    path = str(tmp_path / "ref.pth")
    torch.save(sd, path)
    t = _ssod(tmp_path / "work", coco, 1, f"load_from={path}")
    # the loaded weights are the ones step 0 started from: check the state
    # before training by building the trainer the same way
    t = loop.SsodTrainer(t.cfg, t.sup_dataset, t.unsup_dataset,
                         work_dir=str(tmp_path / "fresh"), load_from=path,
                         device="cpu")
    for module, ref in ((t.state.model, want), (t.state.teacher,
                                                want_teacher)):
        got = module.state_dict()
        for k, v in ref.items():
            assert torch.equal(got[k], v.to(got[k].dtype)), k


def _torchvision_resnet50(path, seed=0):
    """A torchvision-layout ResNet-50 state dict with random values."""
    rs = np.random.RandomState(seed)
    sd = {}
    for k, v in ResNet(50).state_dict().items():
        a = rs.uniform(0.5, 1.5, v.shape) if k.endswith("running_var") \
            else 0.05 * rs.randn(*v.shape)
        sd[k] = torch.from_numpy(a.astype(np.float32))
        if k.endswith("running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(7)
    sd["fc.weight"] = torch.zeros(10, 2048)
    sd["fc.bias"] = torch.zeros(10)
    torch.save(sd, path)


def test_backbone_init_matches_jax(tmp_path, coco):
    path = str(tmp_path / "resnet50.pth")
    _torchvision_resnet50(path)
    cfg_kw = {k: v for k, v in MODEL.items()
              if k not in ("dn_single_pad", "dn_groups", "max_gt")}
    _, jvars, _ = build_pair(seed=5, cfg_kw=cfg_kw)
    params, stats = load_backbone_from_pth(path)
    installed = install_backbone(jvars, params, stats)
    want = {k: v for k, v in state_dict_from_jax(installed, 2).items()
            if k.startswith("backbone.")}
    first = _ssod(tmp_path / "w0", coco, 1)
    t = loop.SsodTrainer(first.cfg, first.sup_dataset, first.unsup_dataset,
                         work_dir=str(tmp_path / "w1"), backbone_init=path,
                         device="cpu")
    for module in (t.state.model, t.state.teacher):
        got = module.state_dict()
        for k, v in want.items():
            assert torch.equal(got[k], v), k


def test_supervised_cli_two_steps(tmp_path, coco):
    t = train_detr_od.main(
        [OD_CONFIG, "--work-dir", str(tmp_path), "--max-steps", "2",
         "--device", "cpu", "--cfg-options", *TINY, *coco[2],
         "schedule.batch_size=2", "data.val_ann="])
    assert [r["step"] for r in t.timings] == [0, 1]
    assert t.state.step == 2 and t.ckpt.all_steps() == [2]
    assert t.state.teacher is None


def test_eval_cli_prints_aps(recorded, coco, capsys, tmp_path):
    out = str(tmp_path / "res.json")
    res = test_cli.main([SSOD_CONFIG, "--work-dir", recorded["work"],
                         "--device", "cpu", "--out", out, "--cfg-options",
                         *SSOD_TINY, *coco[2]])
    printed = capsys.readouterr().out
    assert '"mAP"' in printed and "classwise AP" in printed
    assert 0.0 <= res["mAP"] <= 1.0
    with open(out) as f:
        assert json.load(f)["AP_per_class"]["person"] == res[
            "AP_per_class"]["person"]


def test_trainer_refuses_multi_gpu_arguments_and_warns(recorded, caplog,
                                                      tmp_path):
    """The JAX trainers' refusal in one process (tp > 1 needs a group);
    fsdp and donate are accepted: no mesh in one process, so FSDP shards
    nothing (every step updates in place: `donate` changes nothing)."""
    with pytest.raises(ValueError, match="more than one process"):
        loop.SsodTrainer(None, None, None, tp=2)
    with pytest.raises(ValueError, match="more than one process"):
        loop.SupervisedTrainer(None, None, fsdp=True, tp=2)
    t = recorded["trainer"]
    accepted = loop.SsodTrainer(t.cfg, t.sup_dataset, t.unsup_dataset,
                                fsdp=True, donate=True,
                                work_dir=str(tmp_path / "fsdp"),
                                device="cpu")
    assert accepted.mesh is None and accepted.fsdp and accepted.donate
    accepted._shard()
    # the layout's state bytes: a gradient per trainable parameter whether
    # made or not, and no moments before the first update
    st = accepted.state
    whole = sum(p.numel() for m in (st.model, st.teacher, st.projector)
                for p in m.parameters())
    trainable = sum(p.numel() for _, p, _ in st.optimizer.params)
    assert sharding.local_state_bytes(st) == 4 * (whole + trainable)
    assert not accepted.state.optimizer.sharded
    loop.SsodTrainer(dataclasses.replace(t.cfg, cls_avg_groups=(1, 2)),
                     t.sup_dataset, t.unsup_dataset, by_prob=True,
                     work_dir=str(tmp_path), device="cpu")
    assert "cls_avg_groups with by_prob=True" in caplog.text


def test_prefetch_close_waits_for_its_worker():
    """Closing the prefetch generator ends its worker before returning: a
    worker left inside a torch call when the interpreter exits aborts the
    process. The worker here is mid-transform when the consumer closes."""
    import threading
    import time

    workers = []

    def slow(item):
        workers.append(threading.current_thread())
        time.sleep(0.2)
        return item

    gen = loop.prefetch(iter(range(100)), depth=1, transform=slow)
    assert next(gen) == 0
    gen.close()
    assert workers and not workers[-1].is_alive()


def test_prefetch_reraises_a_worker_error_and_ends_the_worker():
    def broken():
        yield 1
        raise OSError("unreadable image")

    gen = loop.prefetch(broken())
    assert next(gen) == 1
    with pytest.raises(OSError, match="unreadable image"):
        next(gen)
    gen.close()
