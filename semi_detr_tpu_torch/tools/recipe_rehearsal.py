"""Recipe rehearsal: the 120k SSOD recipe through the CLI, killed and resumed.

Counterpart of `tools/recipe_rehearsal.py`. It drives the real
`configs/detr_ssod/semi_detr_r50_coco_120k.py` (DINO-R50, 900 queries,
1 labelled + 4 unlabelled images per step, the 800x1344 bucket, bfloat16,
remat) end to end on a synthetic COCO-shaped JPEG set written by the
port's `write_synthetic_coco` (the JAX tool's arguments: 480x640, 5
classes, up to 6 boxes, 8 distractors), through the user surface, two
runs of `python -m semi_detr_tpu_torch.tools.train_detr_ssod`:

* leg 1 starts fresh and stops at steps/2 + steps/8 (the warm-up
  boundary, ssod.warm_up_step, at steps/2), saving its last step;
* leg 2 resumes from the work dir's checkpoint and runs to `steps`;
* teacher and student are evaluated every `--eval-interval` steps
  (default max(steps/3, 50), as the JAX tool).

`analyze` reads the run's `metrics.jsonl` and `train.log`: the median
logged step time, images/s (5 per step), the peak device memory (the
trainer's last "device memory" line, written at the end of each leg), the
Eval[teacher] / Eval[student] lines, the resume points and each leg's
MSDA kernel launches. The report goes
to `--out` (default `<workdir>/REHEARSAL.md`).

`--tiny` runs instead the JAX package's tiny behavioural soak
(`.claude/skills/verify/SKILL.md`, "Longer behavioral soak"): its tiny
model options, a 220-image set of the writer's defaults (100 labelled,
100 unlabelled, 20 val), ssod.warm_up_step at steps/2, one leg, then
`tools.test` on the val split for the teacher and the student.

Usage:
  python -m semi_detr_tpu_torch.tools.recipe_rehearsal [--steps 600] \\
      [--imgs 200] [--workdir DIR] [--out FILE] [--device cuda]
  python -m semi_detr_tpu_torch.tools.recipe_rehearsal --tiny \\
      --steps 2000 [--workdir DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs", "detr_ssod",
                      "semi_detr_r50_coco_120k.py")
IMAGES_PER_STEP = 5
CLASSES = ("person", "class1", "class2", "class3", "class4")
# the JAX package's tiny CLI recipe (.claude/skills/verify/SKILL.md)
TINY_OPTIONS = (
    "model.d_model=64", "model.n_heads=2", "model.num_encoder_layers=1",
    "model.num_decoder_layers=2", "model.d_ffn=64", "model.num_queries=24",
    "model.dn_single_pad=4", "model.dn_groups=2", "model.max_gt=8",
    "model.num_classes=1", "ssod.max_pseudo=4", "ssod.cons_groups=2",
    "bucket=(128,160)", "scales=[[112,144]]",
    "schedule.samples_per_batch=3", "schedule.sample_ratio=[1,2]")
TINY_SPLITS = {"sup": range(0, 100), "unsup": range(100, 200),
               "val": range(200, 220)}


def rehearsal_splits(n_imgs: int):
    """The JAX tool's split of n images: a fifth labelled (at least 8), a
    tenth val (at least 8), the rest unlabelled."""
    n_sup = max(n_imgs // 5, 8)
    n_val = max(n_imgs // 10, 8)
    n_unsup = n_imgs - n_sup - n_val
    return {"sup": range(0, n_sup),
            "unsup": range(n_sup, n_sup + n_unsup),
            "val": range(n_sup + n_unsup, n_imgs)}


def build_dataset(root: str, n_imgs: int, tiny: bool = False):
    """Write the synthetic set; returns (annotation paths, image dir)."""
    from ..data.synthetic import write_synthetic_coco
    if tiny:
        return write_synthetic_coco(root, n=220, splits=TINY_SPLITS)
    return write_synthetic_coco(
        root, n=n_imgs, hw=(480, 640), seed=0,
        splits=rehearsal_splits(n_imgs), n_classes=len(CLASSES),
        max_boxes=6, distractors=8)


def data_options(paths, img_dir):
    return (f"data.train_sup_ann={paths['sup']}",
            f"data.train_unsup_ann={paths['unsup']}",
            f"data.val_ann={paths['val']}",
            f"data.train_prefix={img_dir}", f"data.val_prefix={img_dir}")


def run_module(module: str, args, log_path: str) -> float:
    """`python -m semi_detr_tpu_torch.tools.<module> args` from the repo
    root, its output appended to log_path; returns its wall seconds and
    raises if it fails."""
    cmd = [sys.executable, "-m", f"semi_detr_tpu_torch.tools.{module}",
           *args]
    t0 = time.perf_counter()
    with open(log_path, "a") as log:
        log.write("$ " + " ".join(cmd) + "\n")
        log.flush()
        r = subprocess.run(cmd, cwd=REPO, stdout=log,
                           stderr=subprocess.STDOUT)
    if r.returncode != 0:
        raise RuntimeError(f"{module} exited {r.returncode}; see {log_path}")
    return time.perf_counter() - t0


def run_cli(work_dir, max_steps, options, device, log_path) -> float:
    return run_module("train_detr_ssod", [
        CONFIG, "--work-dir", work_dir, "--max-steps", str(max_steps),
        "--device", device, "--cfg-options", *options], log_path)


def analyze(work_dir: str) -> dict:
    """The run's numbers from `metrics.jsonl` and `train.log`."""
    rows = []
    with open(os.path.join(work_dir, "metrics.jsonl")) as f:
        for line in f:
            rows.append(json.loads(line))
    times = [r["time"] for r in rows if r.get("step", 0) > 0]
    med = statistics.median(times) if times else float("nan")
    with open(os.path.join(work_dir, "train.log")) as f:
        log = f.read()
    mem = re.findall(r"device memory: (\{.*\})", log)
    evals = re.findall(r"Eval\[(teacher|student)\] iter (\d+): (.*)", log)
    resumed = re.findall(r"resumed from step (\d+)", log)
    launches = [json.loads(m) for m in re.findall(r"msda launches: (\{.*\})",
                                                   log)]
    eval_maps = {}
    for tag, step, rest in evals:
        vals = dict(kv.split("=") for kv in rest.split())
        eval_maps.setdefault(int(step), {})[tag] = {
            k: float(v) for k, v in vals.items()}
    return {
        "median_step_s": med,
        "images_per_s": IMAGES_PER_STEP / med if times else None,
        "steps_logged": [r["step"] for r in rows],
        "losses_logged": [r.get("total_loss") for r in rows],
        "peak_memory": (json.loads(mem[-1].replace("'", '"'))
                        if mem else None),
        "evals": eval_maps,
        "resumed_from": [int(s) for s in resumed],
        # MSDA kernel launches of each CLI run (leg), forward and backward
        "msda_launches": launches,
    }


def checkpoint_steps(work_dir: str):
    ckpt = os.path.join(work_dir, "ckpt")
    return sorted(int(m.group(1)) for m in (
        re.fullmatch(r"step_(\d+)\.pt", n) for n in os.listdir(ckpt)) if m)


def write_report(path: str, title: str, settings: dict, result: dict):
    lines = [f"# {title}", "", "Settings:", "", "```json",
             json.dumps(settings, indent=2, default=str), "```", "",
             "Result:", "", "```json",
             json.dumps(result, indent=2, default=str), "```", ""]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))


def rehearse(steps: int, n_imgs: int, workdir: str, device: str,
             eval_interval=None, options=()):
    """The two legs of the full-width rehearsal; returns the report's
    settings and result."""
    paths, img_dir = build_dataset(os.path.join(workdir, "data"), n_imgs)
    work_dir = os.path.join(workdir, "run")
    boundary = steps // 2
    eval_iv = eval_interval or max(steps // 3, 50)
    kill_at = steps // 2 + steps // 8
    opts = data_options(paths, img_dir) + (
        f"data.classes={list(CLASSES)}", f"model.num_classes={len(CLASSES)}",
        f"ssod.warm_up_step={boundary}", f"eval_interval={eval_iv}",
        f"ckpt_interval={max(steps // 4, 50)}", "image_log_interval=0",
        f"schedule.epoch_length={max(steps, 100)}", *options)
    log_path = os.path.join(workdir, "cli.log")
    t1 = run_cli(work_dir, kill_at, opts, device, log_path)
    leg1_ckpt = checkpoint_steps(work_dir)[-1]
    t2 = run_cli(work_dir, steps, opts, device, log_path)
    result = analyze(work_dir)
    result.update(wall_leg1_s=t1, wall_leg2_s=t2,
                  leg1_last_checkpoint=leg1_ckpt,
                  checkpoints=checkpoint_steps(work_dir))
    settings = dict(config=CONFIG, steps=steps, images=n_imgs,
                    warm_up_boundary=boundary, eval_interval=eval_iv,
                    kill_at=kill_at, device=device, options=list(opts))
    return settings, result


def tiny_soak(steps: int, workdir: str, device: str, eval_interval=None,
              options=()):
    """The JAX package's tiny soak: one leg, then tools.test on val for
    the teacher and the student."""
    paths, img_dir = build_dataset(os.path.join(workdir, "data"), 220,
                                   tiny=True)
    work_dir = os.path.join(workdir, "run")
    opts = TINY_OPTIONS + data_options(paths, img_dir) + (
        f"ssod.warm_up_step={steps // 2}",
        f"eval_interval={eval_interval or max(steps // 4, 50)}",
        f"ckpt_interval={steps}", "image_log_interval=0", *options)
    log_path = os.path.join(workdir, "cli.log")
    wall = run_cli(work_dir, steps, opts, device, log_path)
    result = analyze(work_dir)
    result["wall_s"] = wall
    for model in ("teacher", "student"):
        out = os.path.join(workdir, f"test_{model}.json")
        run_module("test", [CONFIG, "--work-dir", work_dir, "--device",
                            device, "--inference-on", model, "--out", out,
                            "--cfg-options", *opts], log_path)
        with open(out) as f:
            res = json.load(f)
        result[f"test_{model}"] = {k: v for k, v in res.items()
                                   if k != "AP_per_class"}
    settings = dict(config=CONFIG, steps=steps, images=220,
                    splits={k: [v.start, v.stop] for k, v in
                            TINY_SPLITS.items()},
                    device=device, options=list(opts))
    return settings, result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--imgs", type=int, default=200)
    ap.add_argument("--workdir", default=None,
                    help="default: a new temporary directory")
    ap.add_argument("--out", default=None,
                    help="report path (default <workdir>/REHEARSAL.md)")
    ap.add_argument("--eval-interval", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny-width soak instead of the rehearsal")
    ap.add_argument("--cfg-options", nargs="+", default=[],
                    help="further overrides for both legs (key=value)")
    args = ap.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="rehearsal_")
    os.makedirs(workdir, exist_ok=True)
    out = args.out or os.path.join(workdir, "REHEARSAL.md")
    if os.path.abspath(out) == os.path.join(REPO, "RECIPE_REHEARSAL.md"):
        raise ValueError("RECIPE_REHEARSAL.md is the JAX rehearsal's "
                         "record; write the report elsewhere")
    kw = dict(eval_interval=args.eval_interval, options=args.cfg_options)
    if args.tiny:
        settings, result = tiny_soak(args.steps, workdir, args.device, **kw)
        title = "Tiny SSOD soak (PyTorch port)"
    else:
        settings, result = rehearse(args.steps, args.imgs, workdir,
                                    args.device, **kw)
        title = "Recipe rehearsal (PyTorch port), 120k config, synthetic data"
    write_report(out, title, settings, result)
    print(json.dumps(result, indent=2, default=str))
    print(f"wrote {out}")
    return result


if __name__ == "__main__":
    main()
