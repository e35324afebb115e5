"""Where a training step's time goes, on the card: the supervised step, or
with --ssod the Semi-DETR SSOD step.

    python -m semi_detr_tpu_torch.tools.profile_train [--ssod] [--out DIR]

Builds the full-width training setup of `chip_smoke.py` phase 5 with the
same helpers (`train.state.init_train_state` of
configs/dino_detr/dino_detr_r50_coco.py: DINO-R50, bfloat16 compute,
float32 parameters, seeded weights, the config's optimizer, EMA teacher;
`data.pipeline.synthetic_batch`: batch 2 of uint8 images with seeded GT in
the 800x1344 bucket), warms both branches, then for each branch (warm-up:
O2M + task-aligned focal loss; Hungarian):

* times 4 warm steps with the host clock around synchronised work;
* traces 4 more with torch.profiler and reports the host time of the
  step's spans (train.ema, train.forward_loss, train.backward,
  train.optimizer, hungarian.solve_batch), the device busy time per step
  (the union of kernel intervals) over the untraced step time (the busy
  share), the MSDA forward and backward kernels' shares of device time,
  and the top kernels.

--ssod: the setup of `chip_smoke.py` phase 6 instead (`init_ssod_state` of
configs/detr_ssod/semi_detr_r50_coco_120k.py with the box MLPs' last layers
filled by `refine_boxes`; 1 supervised + 4 unlabeled 800x1344 images of
`data.pipeline.synthetic_ssod_batch`, the student view flipped), both
stages (warm-up with the consistency block; Hungarian), with the SSOD
spans too: ssod.teacher, ssod.pseudo_labels, ssod.gmm, ssod.student and
ssod.consistency. Spans nest (hungarian.solve_batch runs inside
ssod.student and train.forward_loss; ssod.consistency in part inside
ssod.student's decode): each span's host time is its own total.

Prints a JSON summary as its last line and, with --out, writes it with the
top-kernel tables to DIR/profile_train.json (profile_train_ssod.json with
--ssod). Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..data.pipeline import synthetic_batch, synthetic_ssod_batch, to_device
from ..train.ssod import make_ssod_train_step
from ..train.state import init_ssod_state, init_train_state, refine_boxes
from ..train.supervised import make_supervised_train_step

CONFIG = "configs/dino_detr/dino_detr_r50_coco.py"
SSOD_CONFIG = "configs/detr_ssod/semi_detr_r50_coco_120k.py"
BUCKET = (800, 1344)
GT_COUNTS = ((7, 20), (3, 12), (30, 5), (15, 9))
STEPS = 4                 # timed, then traced, warm steps per branch
SPANS = ("train.ema", "train.forward_loss", "train.backward",
         "train.optimizer", "hungarian.solve_batch", "ssod.teacher",
         "ssod.pseudo_labels", "ssod.gmm", "ssod.student",
         "ssod.consistency")


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _device_summary(prof, n_steps):
    from torch.autograd import DeviceType
    spans, kernels = [], {}
    for e in prof.events():
        # record_function spans (ours, and the optimizer's "Optimizer.step#")
        # are mirrored on the device timeline: they are not kernels
        if (e.device_type == DeviceType.CUDA and e.name not in SPANS
                and not getattr(e, "is_user_annotation", False)
                and "#" not in e.name):
            t0, t1 = e.time_range.start, e.time_range.end
            spans.append((t0, t1))
            kernels[e.name] = kernels.get(e.name, 0.0) + (t1 - t0) / 1e3
    busy_ms, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):              # union of device intervals
        if t1 > end:
            busy_ms += (t1 - max(t0, end)) / 1e3
            end = t1
    host = {s: 0.0 for s in SPANS}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in host:
            host[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:20]
    return {
        "host_span_ms_per_step": {k: v / n_steps for k, v in host.items()},
        "device_kernel_ms_per_step": device_ms / n_steps,
        "device_busy_ms_per_step": busy_ms / n_steps,
        "msda_fwd_ms_per_step": sum(v for k, v in kernels.items()
                                    if "msda_fwd" in k) / n_steps,
        "msda_bwd_ms_per_step": sum(v for k, v in kernels.items()
                                    if "msda_bwd" in k
                                    or "cast_to_bf16" in k) / n_steps,
        "top_kernels_ms_per_step": [[k[:120], v / n_steps] for k, v in top],
    }


def _supervised():
    """(state, batches, step maker, images per step) of the supervised
    setup."""
    state = init_train_state(CONFIG, device="cuda", seed=0)
    rng = np.random.RandomState(0)
    batches = [to_device(synthetic_batch(rng, BUCKET, c,
                                         state.model.cfg.max_gt), "cuda")
               for c in GT_COUNTS]
    return state, batches, lambda wu: make_supervised_train_step(
        warm_up=wu), 2


def _ssod():
    """The same for the SSOD setup of chip_smoke.py phase 6."""
    state, cfg = init_ssod_state(SSOD_CONFIG, device="cuda", seed=0)
    refine_boxes(state.model, seed=3)
    batches = [to_device(synthetic_ssod_batch(
        1, 4, *BUCKET, state.model.cfg.max_gt, gt_per_image=12, seed=s,
        student_flip=True), "cuda") for s in range(2)]
    return state, batches, lambda wu: make_ssod_train_step(cfg, wu), 5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ssod", action="store_true",
                    help="profile the SSOD step instead")
    ap.add_argument("--out", default=None,
                    help="directory for profile_train[_ssod].json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    state, batches, make_step, n_img = (_ssod if args.ssod
                                        else _supervised)()
    summary = {"card": _card(), "images_per_step": n_img,
               "bucket": list(BUCKET), "ssod": args.ssod}
    for warm_up in (True, False):
        step = make_step(warm_up)
        for b in batches:                     # warm this branch
            step(state, b)
        times = []
        for i in range(STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batches[i % len(batches)])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(STEPS):
                step(state, batches[i % len(batches)])
            torch.cuda.synchronize()
        d = _device_summary(prof, STEPS)
        step_ms = float(np.median(times))
        d.update(step_ms=times, median_step_ms=step_ms,
                 images_per_s=n_img / step_ms * 1e3,
                 device_busy_share=d["device_busy_ms_per_step"] / step_ms)
        if d["device_kernel_ms_per_step"] == 0:
            raise SystemExit("the profiler recorded no device time")
        summary["warm_up" if warm_up else "hungarian"] = d
    summary["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        name = "profile_train_ssod.json" if args.ssod else "profile_train.json"
        with open(os.path.join(args.out, name), "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps({k: ({kk: vv for kk, vv in v.items()
                           if kk != "top_kernels_ms_per_step"}
                          if isinstance(v, dict) else v)
                      for k, v in summary.items()}))


if __name__ == "__main__":
    main()
