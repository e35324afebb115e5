"""Where a served request's time goes, on the card.

    python -m semi_detr_tpu_torch.tools.profile_predict [--out DIR]

Builds the full-width predictor (configs/dino_detr/dino_detr_r50_coco.py,
bfloat16, seeded weights), warms it on synthetic uint8 requests, then:

* times the stages of a request through the `Predictor`'s own methods,
  with the host clock around synchronised work: preprocess (test resize
  and pack on the host, copy to the card), predict (forward and top-k
  decode on the card) and postprocess (copy back);
* traces one warm request of each size with torch.profiler and sums the
  device-side events by kernel: device busy time per request (the union
  of kernel intervals) over the untraced request time is the busy share;
  also the MSDA kernel's share of device time, and the top kernels.

Prints a JSON summary as its last line and, with --out, writes it with the
top-kernel table to DIR/profile_predict.json. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..api import init_detector

CONFIG = "configs/dino_detr/dino_detr_r50_coco.py"
REQUESTS = ((480, 640), (640, 427), (427, 641), (599, 401))


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _stages(pred, images, reps=3):
    """Median host-clock ms of each stage of `Predictor.__call__`, over
    the images: preprocess (resize and pack on the host, copy to the
    card), predict (forward and decode on the card) and postprocess (copy
    back, threshold, rescale)."""
    out = {"preprocess": [], "predict": [], "postprocess": []}
    for img in [im for im in images for _ in range(reps)]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images_d, hw, scale_factor = pred.preprocess(img)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dets = pred.predict(images_d, hw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pred.postprocess(dets, scale_factor, score_thr=-1.0)
        t3 = time.perf_counter()
        out["preprocess"].append(t1 - t0)
        out["predict"].append(t2 - t1)
        out["postprocess"].append(t3 - t2)
    return {k: float(np.median(v) * 1e3) for k, v in out.items()}


def device_trace(run):
    """The device side of a torch.profiler trace of run() (after one
    trace that pays the tracer's setup): (busy ms, the union of the
    device events' intervals; {event name: device ms}). Only device-side
    events (kernels, copies, sets) count: the host-side op events of the
    same trace carry the same device time again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def traced():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        return prof

    traced()
    spans, kernels = [], {}
    for e in traced().events():
        if e.device_type == DeviceType.CUDA:
            t0, t1 = e.time_range.start, e.time_range.end
            spans.append((t0, t1))
            kernels[e.name] = kernels.get(e.name, 0.0) + (t1 - t0) / 1e3
    busy_ms, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy_ms += (t1 - max(t0, end)) / 1e3
            end = t1
    return busy_ms, kernels


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for profile_predict.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_predict needs a CUDA card")

    pred = init_detector(CONFIG, None, device="cuda", use_nms=False, seed=0)
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 256, hw + (3,)).astype(np.uint8)
              for hw in REQUESTS]
    for img in images:
        pred(img, score_thr=-1.0)
    stages = _stages(pred, images)
    busy_ms, kernels = device_trace(
        lambda: [pred(img, score_thr=-1.0) for img in images])
    n = len(images)
    device_ms = sum(kernels.values())
    msda_ms = sum(v for k, v in kernels.items() if "msda_fwd" in k)
    request_ms = sum(stages.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:25]
    summary = {
        "card": _card(),
        "requests": n,
        "stage_ms_per_request": stages,
        "device_kernel_ms_per_request": device_ms / n,
        "device_busy_ms_per_request": busy_ms / n,
        # busy time from the trace over the untraced request time
        "device_busy_share": busy_ms / n / request_ms,
        "msda_ms_per_request": msda_ms / n,
        "msda_share_of_device": msda_ms / device_ms if device_ms else None,
        "top_kernels_ms_per_request": [[k[:120], v / n] for k, v in top],
    }
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "profile_predict.json"), "w") as f:
            json.dump(summary, f, indent=1)
    if device_ms == 0:
        raise SystemExit("the profiler recorded no device time")
    print(json.dumps({k: v for k, v in summary.items()
                      if k != "top_kernels_ms_per_request"}))


if __name__ == "__main__":
    main()
