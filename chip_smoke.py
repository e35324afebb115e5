"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Device: the card's name and power limit from nvidia-smi.
2. Build: nvcc compiles the MSDA forward and backward kernels from
   semi_detr_tpu_torch/csrc, one nvcc per source started together (timed;
   ptxas register report printed).
3. Kernel against its plain version, at the main path's shapes (encoder
   Lq = S = 22,323 and decoder Lq = 900, N=1, M=8, D=32, L=4, P=4) and on
   an out-of-bounds case, each in float32 (TF32 off) and bfloat16: max abs
   error against the stated tolerance, the kernel instance taken (channels
   per lane: 16 bytes of the dtype, or 1), kernel ms, plain ms, the bound
   (the least time the card could take for the same work) and the rate of
   gathered value rows. The float32 encoder and decoder outputs must equal
   the plain version's to the bit: the float32 forward sums in the order
   of torch's reduction, and phase 5b's decoder limit holds only that
   order, so a torch that reduces otherwise fails here, at the cause.
4. Main path: `init_detector` at full width (DINO-R50, the
   configs/dino_detr/dino_detr_r50_coco.py model, bfloat16, seeded
   weights) on the card serves synthetic uint8 requests of odd landscape
   and portrait sizes through `Predictor.__call__`, with the top-k and the
   NMS decode. The last layers of the box MLPs (zero in the seeded init)
   are filled from a seed, so the boxes go through the decoder's
   refinement. Each answer has 300 detections of finite score with boxes
   inside the image, and the MSDA kernel launches exactly 12 times per
   forward, every time through its vector instance. Warm per-request
   latency and images/s are printed. Then one request runs in float32
   (TF32 off) through the kernel and through the plain version, and the
   two are compared within tolerance (the float32 kernel sums in the plain
   version's order, so they may agree to the bit); the coordinates must
   move when the decoder's MSDA output moves.
3b. Backward kernel against its plain version (autograd through the plain
   forward), at the training step's shapes (batch 2: encoder Lq = S =
   22,323, decoder Lq = 900 + 200 CDN slots = 1,100) and on an
   out-of-bounds/NaN/lower-edge case, each in float32 (TF32 off) and
   bfloat16: the max abs error of d_value, d_loc and d_attn against
   tolerances scaled to each output's magnitude, the instance taken,
   kernel ms, plain ms, the bound, the rate of gathered value rows, and the
   backward of the grid_sample composite as a yardstick.
5. Training path: the supervised step at full width (`init_train_state`
   of the config above: bfloat16 compute, float32 parameters, seeded
   weights, the config's optimizer, EMA teacher), batch 2 per step,
   `synthetic_batch`'s seeded uint8 images through `pack` and `stack` in
   both bucket orientations, seeded GT counts including an
   image with 0 GT (fake CDN) and one with 100: 2 warm-up steps (O2M +
   task-aligned focal loss), then 3 Hungarian steps. Every loss and the
   grad norm finite, every trainable parameter moved, the frozen stem and
   layer1 unchanged bit for bit, and exactly 12 MSDA forward and 12
   backward launches per step, every one through the vector instances.
   Step times, images/s and the peak device memory are printed.
5b. Both kernels inside the model, float32 (TF32 off), one 599x401 image:
   the parameter gradients of a seeded projection of the encoder memory
   through the kernels and through the plain versions; then each kernel
   alone (forward kernel with the plain backward, and the backward kernel
   under either forward), the kernels twice (the noise floor of the
   atomic scatter) and the plain version with its output moved by one
   float32 rounding (how far the model carries a rounding of the forward);
   then the decoder's hs, both runs decoding one shared encoder output,
   with the same witnesses. Each leaf within a relative L2 tolerance.

6. SSOD path: the Semi-DETR teacher-student step at full width
   (`init_ssod_state` of configs/detr_ssod/semi_detr_r50_coco_120k.py:
   DINO-R50, 900 queries, CDN budget 200, max_pseudo 32, 5 consistency
   groups, bfloat16 compute, float32 parameters, seeded weights with the
   box MLPs' last layers filled), 1 supervised + 4 unlabeled 800x1344
   images from `synthetic_ssod_batch`, the student view the teacher view
   flipped: 2 warm-up steps (the second at score_thr 0, so the supervision
   set is not empty), then 2 Hungarian steps. Each step: every loss finite;
   48 (warm-up) or 42 forward and 24 backward MSDA launches, all through the
   vector instances; the projector moved (after the warm-up on a zero
   gradient); the frozen stem and layer1 unchanged bit for bit; the teacher
   moved by the EMA. Step ms, images/s, peak memory, the pseudo-label,
   supervision-set and consistency-set sizes and gmm_thr are printed.
   Phases 3 and 3b also hold both kernels at this path's new shapes (N=4
   encoder; decoder Lq 1,260 = 160 consistency + 200 CDN + 900, N=4), in
   bfloat16.
7. Trainer path, in a temporary directory removed at the end: the port's
   `write_synthetic_coco` writes 8 labelled, 16 unlabelled and 8 val PNG
   images of 480x640 (up to 3 boxes and 2 distractors each, class
   "person"); the SSOD CLI (`tools.train_detr_ssod.main`, in-process) runs
   configs/detr_ssod/semi_detr_r50_coco_120k.py at full width (80 classes,
   1 + 4 images at 800x1344, the 11 COCO scales, bfloat16) from those files
   for 4 steps, with warm_up_step, eval, checkpoint and render intervals
   of 2. Asserted: steps 0-3 ran (2 in the warm-up); 48 / 42 forward and
   24 backward MSDA launches per step and 12 forward per eval batch
   (teacher and student), all through the vector instances; checkpoints
   2 and 4 on disk; Eval[teacher] and Eval[student] lines with every AP in
   [0, 1] (NaN only for the small and medium ranges, which hold no GT);
   a finite total_loss at step 0 in metrics.jsonl; the pseudo renders.
   Then the CLI runs again to step 5: "resumed from step 4", one step. The
   eval CLI (`tools.test.main`) scores the last checkpoint's teacher; the
   supervised CLI (`tools.train_detr_od.main`) takes 2 steps of batch 2
   (the config says 16) with 12 + 12 launches each. Printed: warm step ms
   and train.data_wait ms per step, augmentation ms per weak and strong
   view, eval ms per image, checkpoint save s and bytes, peak memory. Phase
   3 also holds the forward kernel at the eval batch's decoder shape (N=4,
   Lq 900, bfloat16).

The line before the last is a JSON object with the kernels' numbers and the
training records; the last line is {"ok": true, "device": {...}}.
"""
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; this script runs only on the card",
          file=sys.stderr)
    sys.exit(1)

from semi_detr_tpu_torch.api import Predictor, init_detector  # noqa: E402
from semi_detr_tpu_torch.data import augment  # noqa: E402
from semi_detr_tpu_torch.data.pipeline import (  # noqa: E402
    synthetic_batch, synthetic_ssod_batch, to_device)
from semi_detr_tpu_torch.models import transformer as tr  # noqa: E402
from semi_detr_tpu_torch.ops import ms_deform_attn_cuda as msda  # noqa: E402
from semi_detr_tpu_torch.ops.ms_deform_attn import (  # noqa: E402
    ms_deform_attn, ms_deform_attn_backward)
from semi_detr_tpu_torch.data.synthetic import (  # noqa: E402
    write_synthetic_coco)
from semi_detr_tpu_torch.tools import test as test_cli  # noqa: E402
from semi_detr_tpu_torch.tools import train_detr_od  # noqa: E402
from semi_detr_tpu_torch.tools import train_detr_ssod  # noqa: E402
from semi_detr_tpu_torch.train import checkpoint as ckpt_mod  # noqa: E402
from semi_detr_tpu_torch.train.loop import SsodTrainer  # noqa: E402
from semi_detr_tpu_torch.train.ssod import make_ssod_train_step  # noqa: E402
from semi_detr_tpu_torch.train.state import (  # noqa: E402
    init_ssod_state, init_train_state, refine_boxes)
from semi_detr_tpu_torch.train.supervised import (  # noqa: E402
    make_supervised_train_step)
# the yardstick: the main-path levels of the 800x1344 bucket, M = 8,
# D = 32, P = 4, the seeded inputs, the bounds and the timer
from semi_detr_tpu_torch.tools.msda_bench import (  # noqa: E402
    D, M, P, S, SHAPES, bound, bound_bwd, cuda_ms, gathered_bytes,
    msda_inputs, ptxas_summary)

CONFIG = "configs/dino_detr/dino_detr_r50_coco.py"
SSOD_CONFIG = "configs/detr_ssod/semi_detr_r50_coco_120k.py"
# the SSOD recipe's batch: 1 supervised + 4 unlabeled images per card
SSOD_SUP, SSOD_UNSUP, SSOD_BUCKET = 1, 4, (800, 1344)
# the SSOD steps: (warm_up, score_thr override or None for the recipe's)
SSOD_STEPS = ((True, None), (True, 0.0), (False, None), (False, None))
# MSDA launches per SSOD step (forward, backward): sup encoder + decoder,
# teacher encoder + matching decode, student encoder + matching decode +
# training decode, and in warm-up the teacher's consistency decode; 6 each
SSOD_LAUNCHES = {True: (48, 24), False: (42, 24)}
# the SSOD path's shapes that no earlier row covers: (case, N, Lq)
SSOD_FWD_CASES = (("encoder_n4", 4, S), ("decoder_ssod", 4, 160 + 200 + 900))
# the eval batch's decoder (4 images, 900 queries), forward only
EVAL_FWD_CASES = (("decoder_eval", 4, 900),)
# the main path runs bfloat16: 16-byte chunks of 8 channels per lane
MAIN_WIDTH = 8
# kernel vs plain: float32 sums in another order (1e-5); bfloat16 output
# is one rounding of that sum, and the two may round a value that sits on a
# tie apart: one bf16 ulp at |out| < 4 is 2**-6
TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}
# the float32 request, kernel against plain version through 6 encoder and
# 6 decoder layers (TF32 off)
TOL_MEMORY, TOL_LOGITS, TOL_COORDS = 1e-3, 1e-3, 1e-4
REQUESTS = ((480, 640), (640, 427), (427, 641), (599, 401))
# backward, kernel vs plain: each output's max abs error within GRAD_RTOL
# times its largest magnitude (float32 sums in another order; d_value's
# scatter in atomic order, which is not fixed); a bfloat16 d_value adds
# one bf16 rounding (2**-8 relative). The bfloat16 kernel is held against
# the plain backward of value.float() and grad.float(): it reads the same
# bf16 numbers and sums in float32.
GRAD_RTOL, BF16_ROUNDING = 1e-5, 2 ** -8
TRAIN_BATCH, TRAIN_LQ = 2, 900 + 200
# the training steps: (warm_up, bucket, GT counts of the two images)
TRAIN_STEPS = ((True, (800, 1344), (0, 7)), (True, (1344, 800), (100, 3)),
               (False, (800, 1344), (12, 0)), (False, (1344, 800), (100, 0)),
               (False, (800, 1344), (25, 60)))
# 5b, float32 gradients through kernels vs plain versions: relative L2 per
# leaf (float32 sums in other orders through 6 layers and the backbone);
# leaves whose gradient is below 1e-5 of the global norm on both sides are
# a true zero (a conv bias before GroupNorm, the key bias) and skipped.
# Where the two forwards differ, the model carries their rounding far: one
# float32 rounding of the plain MSDA output moves the encoder's leaves by
# up to ~1e-3 (phase 5b's witness), so TOL_GRAD_LEAF holds those
# comparisons. With one forward shared, only the backward kernel's sum
# order differs: TOL_BWD_ONLY is 5x the kernel-vs-kernel floor (~2e-6).
# The decoder, on one shared encoder output, reads ~2e-5.
TOL_GRAD_LEAF, TOL_BWD_ONLY, TOL_DECODER_LEAF = 1e-3, 1e-5, 1e-4
NEGLIGIBLE = 1e-5
# phase 7: the synthetic COCO set (labelled, unlabelled, val images of
# 480x640, up to 3 boxes and 2 distractors each, class "person") and the
# SSOD CLI's overrides of the recipe; everything else is the recipe's
TRAINER_SET = dict(hw=(480, 640), max_boxes=3, distractors=2,
                   class_name="person")
TRAINER_SPLITS = {"sup": range(0, 8), "unsup": range(8, 24),
                  "val": range(24, 32)}
TRAINER_STEPS, TRAINER_WARM_UP = 4, 2
EVAL_BATCH = 4
OD_STEPS, OD_BATCH = 2, 2


def log(msg):
    print(msg, flush=True)


def json_safe(x):
    """NaN (an AP over an area range without GT) as null: the record line
    stays strict JSON."""
    if isinstance(x, dict):
        return {k: json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [json_safe(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def widths_of(wrapper, fn):
    """fn()'s result and the kernel instances (widths) its launches took."""
    before = dict(wrapper.launches_by_width)
    out = fn()
    after = dict(wrapper.launches_by_width)
    return out, {w: c - before.get(w, 0) for w, c in after.items()
                 if c != before.get(w, 0)}


def reset_counts():
    for wrapper in (msda.ms_deform_attn_cuda, msda.ms_deform_attn_bwd_cuda):
        wrapper.launches = 0
        wrapper.launches_by_width.clear()


def assert_vector(wrapper, what):
    """Every launch counted since the last reset took the vector instance
    of the main path's dtype."""
    by_width = dict(wrapper.launches_by_width)
    if by_width != {MAIN_WIDTH: wrapper.launches}:
        raise AssertionError(f"{what}: {wrapper.launches} launches by width "
                             f"{by_width}, not all {MAIN_WIDTH}")


def grid_sample_msda(value, loc, attn):
    """The grid_sample composite of the reference's
    ms_deform_attn_core_pytorch, timed only as a yardstick."""
    F = torch.nn.functional
    n, _, m, d = value.shape
    lq = loc.shape[1]
    vals = value.split([h * w for h, w in SHAPES], 1)
    outs = []
    for lid, (h, w) in enumerate(SHAPES):
        v = vals[lid].permute(0, 2, 3, 1).reshape(n * m, d, h, w)
        gr = (2 * loc[:, :, :, lid] - 1).permute(0, 2, 1, 3, 4).reshape(
            n * m, lq, P, 2).to(v.dtype)
        outs.append(F.grid_sample(v, gr, mode="bilinear",
                                  padding_mode="zeros", align_corners=False))
    a = attn.permute(0, 2, 1, 3, 4).reshape(n * m, 1, lq, -1).to(value.dtype)
    out = (torch.stack(outs, -2).flatten(-2) * a).sum(-1)
    return out.reshape(n, m * d, lq).transpose(1, 2)


def kernel_phase():
    log("== phase 3: MSDA kernel against its plain version")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    cases = [(name, 1, lq, oob, dtypes) for name, lq, oob in (
        ("encoder", S, False), ("decoder", 900, False),
        ("out_of_bounds", 900, True))
        for dtypes in [(torch.float32, torch.bfloat16)]]
    cases += [(name, n, lq, False, (torch.bfloat16,))
              for name, n, lq in SSOD_FWD_CASES + EVAL_FWD_CASES]
    for name, n, lq, oob, dtypes in cases:
        for dtype in dtypes:
            value, loc, attn = msda_inputs(lq, dtype, seed=len(rows),
                                           oob=oob, n=n)
            got, widths = widths_of(msda.ms_deform_attn_cuda,
                                    lambda: msda.ms_deform_attn_cuda(
                                        value, SHAPES, loc, attn))
            ref = ms_deform_attn(value, SHAPES, loc, attn)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            # the share of outputs equal to the plain version's to the bit
            # (the kernel sums in the order of torch's reduction there)
            same = (got == ref).float().mean().item()
            if not (err <= TOL[dtype]) or not torch.isfinite(got).all():
                raise AssertionError(f"{name} {dtype}: max abs err {err} > "
                                     f"{TOL[dtype]}")
            if dtype == torch.float32 and not oob and same != 1.0:
                raise AssertionError(
                    f"{name} float32: {same:.6f} of the outputs equal the "
                    "plain version's to the bit, not all: torch's reduction "
                    "order is not the forward kernel's")
            k_ms = cuda_ms(lambda: msda.ms_deform_attn_cuda(
                value, SHAPES, loc, attn), 50)
            p_ms = cuda_ms(lambda: ms_deform_attn(value, SHAPES, loc, attn), 5)
            y_ms = (cuda_ms(lambda: grid_sample_msda(value, loc, attn), 5)
                    if dtype == torch.float32 else None)
            b_ms, b_by = bound(lq, dtype, n)
            rate = gathered_bytes(n, lq, dtype) / (k_ms * 1e-3)
            rows.append(dict(case=name, dtype=str(dtype).split(".")[-1],
                             n=n, lq=lq, width=widths, max_abs_err=err,
                             bit_equal_share=same,
                             tol=TOL[dtype], ms=k_ms, plain_ms=p_ms,
                             bound_ms=b_ms, bound_by=b_by,
                             gathered_bytes_per_s=rate, grid_sample_ms=y_ms))
            log(f"  {name:13s} {rows[-1]['dtype']:8s} N={n} Lq={lq:6d} "
                f"err={err:.3e} (tol {TOL[dtype]:.1e}, bit-equal share "
                f"{same:.4f})  width {widths}  "
                f"kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  bound "
                f"{b_ms:.4f} ms ({b_by})  gathered rows {rate / 1e12:.3f} "
                f"TB/s  grid_sample yardstick {y_ms} ms")
            del value, loc, attn, got, ref
            torch.cuda.empty_cache()
    return rows


def check_answer(img, answer):
    boxes, scores, labels = answer
    h, w = img.shape[:2]
    if len(scores) != 300 or not np.isfinite(scores).all():
        raise AssertionError(f"{len(scores)} detections, finite "
                             f"{np.isfinite(scores).all()}")
    eps = 1e-2
    inside = ((boxes[:, 0] >= -eps) & (boxes[:, 1] >= -eps)
              & (boxes[:, 2] <= w + eps) & (boxes[:, 3] <= h + eps)
              & (boxes[:, 2] >= boxes[:, 0]) & (boxes[:, 3] >= boxes[:, 1]))
    if not inside.all() or boxes.shape != (300, 4) or labels.shape != (300,):
        raise AssertionError(f"boxes outside image {(h, w)}")


def main_path_phase():
    log("== phase 4: main path (full width, bfloat16, seeded weights)")
    t0 = time.perf_counter()
    topk = init_detector(CONFIG, None, device="cuda", use_nms=False, seed=0)
    refine_boxes(topk.detector, seed=0)
    nms = Predictor(topk.detector, topk.class_names, use_nms=True)
    log(f"  init_detector: {time.perf_counter() - t0:.1f} s, compute dtype "
        f"{topk.detector.compute_dtype}")
    rng = np.random.RandomState(0)
    images = [rng.randint(0, 256, hw + (3,)).astype(np.uint8)
              for hw in REQUESTS]

    reset_counts()
    forwards = 0
    for pred in (topk, nms):                  # warm-up, checked too
        for img in images:
            check_answer(img, pred(img, score_thr=-1.0))
            forwards += 1
    timed = {}
    for label, pred in (("topk", topk), ("nms", nms)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            for img in images:
                check_answer(img, pred(img, score_thr=-1.0))
                forwards += 1
        dt = (time.perf_counter() - t0) / (3 * len(images))
        timed[label] = dt
        log(f"  {label}: warm latency {dt * 1e3:.2f} ms/request, "
            f"{1.0 / dt:.3f} images/s over {3 * len(images)} requests")
    launches = msda.ms_deform_attn_cuda.launches
    log(f"  MSDA kernel launches: {launches} over {forwards} forwards")
    if launches == 0 or launches != 12 * forwards:
        raise AssertionError(f"expected {12 * forwards} launches, got "
                             f"{launches}")
    assert_vector(msda.ms_deform_attn_cuda, "serving path")
    del topk, nms
    torch.cuda.empty_cache()
    return launches, timed


def float32_phase():
    log("== phase 4b: one float32 request, kernel against plain version")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pred = init_detector(CONFIG, None, device="cuda", use_nms=False, seed=0,
                         cfg_options={"model.dtype": "float32"})
    det = refine_boxes(pred.detector, seed=1)
    img = np.random.RandomState(1).randint(0, 256, (599, 401, 3)).astype(
        np.uint8)
    images, hw, _ = pred.preprocess(img)

    kernel_dispatch = tr.ms_deform_attn_auto
    with torch.inference_mode():
        enc_k = det.encode_images(images, hw)
        out_k = det.decode_queries(enc_k)
        tr.ms_deform_attn_auto = ms_deform_attn       # the plain version
        try:
            enc_p = det.encode_images(images, hw)
            out_p = det.decode_queries(enc_k)         # same selection
            # the plain version with its output scaled by 1 + 2**-10
            tr.ms_deform_attn_auto = lambda *a: ms_deform_attn(*a) * (
                1 + 2 ** -10)
            out_moved = det.decode_queries(enc_k)
        finally:
            tr.ms_deform_attn_auto = kernel_dispatch
    errs = {
        "memory": (enc_k["memory"] - enc_p["memory"]).abs().max().item(),
        "logits": (out_k["cls"] - out_p["cls"]).abs().max().item(),
        "coords": (out_k["coord"] - out_p["coord"]).abs().max().item(),
    }
    same_topk = bool(torch.equal(enc_k["refpoint_unsig"],
                                 enc_p["refpoint_unsig"]))
    log(f"  max abs err: encoder memory {errs['memory']:.3e} (tol "
        f"{TOL_MEMORY}), decoder logits {errs['logits']:.3e} (tol "
        f"{TOL_LOGITS}), coords {errs['coords']:.3e} (tol {TOL_COORDS}); "
        f"two-stage selection identical: {same_topk}")
    for key, tol in (("memory", TOL_MEMORY), ("logits", TOL_LOGITS),
                     ("coords", TOL_COORDS)):
        if not errs[key] <= tol:
            raise AssertionError(f"float32 {key}: {errs[key]} > {tol}")
    # with the box layers filled, the coordinates depend on what the
    # decoder's MSDA returns: moving its output must move them (the kernel
    # itself may agree with the plain version to the bit)
    if torch.equal(out_moved["coord"], out_p["coord"]):
        raise AssertionError("float32 coords do not depend on the MSDA")
    for t in (out_k["cls"], out_k["coord"]):
        if not torch.isfinite(t).all():
            raise AssertionError("non-finite float32 output")
    return errs


def grid_sample_bwd_ms(value, loc, attn, g, reps):
    """Device ms of the backward of the grid_sample composite (value, loc
    and attn), timed alone: a yardstick, not an MSDA of the library."""
    ins = [t.detach().requires_grad_(True) for t in (value, loc, attn)]
    out = grid_sample_msda(*ins)
    return cuda_ms(lambda: torch.autograd.grad(
        out, ins, g.to(out.dtype), retain_graph=True), reps)


def grad_errors(got, ref, dtype):
    """[(max abs err, tol)] of d_value, d_loc, d_attn where the plain result
    is finite; the kernel must give exactly 0 where it is not."""
    rows = []
    for i, (a, b) in enumerate(zip(got, ref)):
        fin = torch.isfinite(b)
        if not torch.equal(a.float()[~fin], torch.zeros_like(a.float()[~fin])):
            raise AssertionError("kernel gradient not 0 at a NaN location")
        scale = max(1.0, b[fin].abs().max().item())
        tol = GRAD_RTOL * scale + (BF16_ROUNDING * scale
                                   if i == 0 and dtype == torch.bfloat16
                                   else 0.0)
        err = (a.float() - b.float())[fin].abs().max().item()
        if not torch.isfinite(a).all():
            raise AssertionError("non-finite kernel gradient")
        rows.append((err, tol))
    return rows


def backward_kernel_phase():
    log("== phase 3b: MSDA backward kernel against its plain version")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    both = (torch.float32, torch.bfloat16)
    cases = [(name, TRAIN_BATCH, lq, oob, both) for name, lq, oob in (
        ("encoder", S, False), ("decoder", TRAIN_LQ, False),
        ("out_of_bounds", TRAIN_LQ, True))]
    cases += [(name, n, lq, False, (torch.bfloat16,))
              for name, n, lq in SSOD_FWD_CASES]
    for name, n, lq, oob, dtypes in cases:
        for dtype in dtypes:
            seed = 100 + len(rows)
            value, loc, attn = msda_inputs(lq, dtype, seed, oob=oob, n=n)
            g = torch.randn(n, lq, M * D, device="cuda",
                            generator=torch.Generator("cuda").manual_seed(
                                seed)).to(dtype)
            got, widths = widths_of(msda.ms_deform_attn_bwd_cuda,
                                    lambda: msda.ms_deform_attn_bwd_cuda(
                                        value, SHAPES, loc, attn, g))
            ref = ms_deform_attn_backward(value.float(), SHAPES, loc, attn,
                                          g.float())
            torch.cuda.synchronize()
            errs = grad_errors(got, ref, dtype)
            del got, ref
            for (err, tol), out in zip(errs, ("d_value", "d_loc", "d_attn")):
                if not err <= tol:
                    raise AssertionError(f"{name} {dtype} {out}: max abs err "
                                         f"{err} > {tol}")
            k_ms = cuda_ms(lambda: msda.ms_deform_attn_bwd_cuda(
                value, SHAPES, loc, attn, g), 20)
            p_ms = cuda_ms(lambda: ms_deform_attn_backward(
                value, SHAPES, loc, attn, g), 3)
            y_ms = (grid_sample_bwd_ms(value, loc, attn, g, 3)
                    if dtype == torch.float32 and not oob else None)
            b_ms, b_by = bound_bwd(n, lq, dtype)
            rate = gathered_bytes(n, lq, dtype) / (k_ms * 1e-3)
            rows.append(dict(case=name, dtype=str(dtype).split(".")[-1],
                             n=n, lq=lq, width=widths,
                             max_abs_err={o: e for o, (e, _) in zip(
                                 ("d_value", "d_loc", "d_attn"), errs)},
                             tol={o: t for o, (_, t) in zip(
                                 ("d_value", "d_loc", "d_attn"), errs)},
                             ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                             bound_by=b_by, gathered_bytes_per_s=rate,
                             grid_sample_bwd_ms=y_ms))
            log(f"  {name:13s} {rows[-1]['dtype']:8s} N={n} Lq={lq:6d} err "
                + " ".join(f"{o}={e:.3e}(tol {t:.1e})" for o, (e, t) in zip(
                    ("d_value", "d_loc", "d_attn"), errs))
                + f"  width {widths}  kernel {k_ms:.4f} ms  plain "
                f"{p_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  gathered rows "
                f"{rate / 1e12:.3f} TB/s  grid_sample bwd yardstick {y_ms} ms")
            del value, loc, attn, g
            torch.cuda.empty_cache()
    return rows


def train_phase(card):
    log("== phase 5: training path (full width, bfloat16 compute, float32 "
        "parameters, seeded weights, batch 2)")
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(CONFIG, device="cuda", seed=0)
    model = state.model
    log(f"  compute dtype {model.compute_dtype}, parameter dtypes "
        f"{sorted({str(p.dtype) for p in model.parameters()})}")
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    steps = {wu: make_supervised_train_step(warm_up=wu, seed=0)
             for wu in (True, False)}
    rng = np.random.RandomState(5)
    batches = [to_device(synthetic_batch(rng, bucket, counts,
                                         model.cfg.max_gt), "cuda")
               for _, bucket, counts in TRAIN_STEPS]
    records = []
    fwd_total = bwd_total = 0
    for (warm_up, bucket, counts), batch in zip(TRAIN_STEPS, batches):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = steps[warm_up](state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        fwd = msda.ms_deform_attn_cuda.launches
        bwd = msda.ms_deform_attn_bwd_cuda.launches
        fwd_total += fwd
        bwd_total += bwd
        vals = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in vals.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"step {state.step}: non-finite {bad}")
        if (fwd, bwd) != (12, 12):
            raise AssertionError(f"step {state.step}: {fwd} forward and "
                                 f"{bwd} backward MSDA launches, not 12 + 12")
        assert_vector(msda.ms_deform_attn_cuda, f"step {state.step} forward")
        assert_vector(msda.ms_deform_attn_bwd_cuda,
                      f"step {state.step} backward")
        records.append(dict(step=state.step - 1, warm_up=warm_up,
                            bucket=list(bucket), gt_counts=list(counts),
                            ms=dt * 1e3, total_loss=vals["total_loss"],
                            grad_norm=vals["grad_norm"],
                            launches_fwd=fwd, launches_bwd=bwd))
        log(f"  step {state.step - 1} {'O2M+TAL' if warm_up else 'Hungarian'}"
            f" bucket {bucket} GT {counts}: {dt * 1e3:.1f} ms, total_loss "
            f"{vals['total_loss']:.4f}, grad_norm {vals['grad_norm']:.4f}, "
            f"MSDA launches {fwd} fwd + {bwd} bwd")
    peak = torch.cuda.max_memory_allocated()
    frozen_moved = [k for k, p in model.named_parameters()
                    if not p.requires_grad and not torch.equal(p, before[k])]
    still = [k for k, p in model.named_parameters()
             if p.requires_grad and torch.equal(p, before[k])]
    n_frozen = sum(not p.requires_grad for p in model.parameters())
    if frozen_moved or still or n_frozen == 0:
        raise AssertionError(f"frozen moved: {frozen_moved[:5]}; trainable "
                             f"unmoved: {still[:5]}; frozen {n_frozen}")
    warm = [r["ms"] for r in records[1:]]
    warm_ms = float(np.median(warm))
    log(f"  {len(records)} steps; every trainable parameter moved, the "
        f"{n_frozen} frozen stem/layer1 tensors did not; warm step (median "
        f"of steps 1-4) {warm_ms:.1f} ms, "
        f"{TRAIN_BATCH / warm_ms * 1e3:.3f} images/s; peak device memory "
        f"{peak / 2 ** 30:.2f} GiB")
    log("  " + card)
    del state, model, batches
    torch.cuda.empty_cache()
    return dict(steps=records, warm_step_ms=warm_ms,
                images_per_s=TRAIN_BATCH / warm_ms * 1e3,
                peak_memory_bytes=peak, launches_fwd=fwd_total,
                launches_bwd=bwd_total, card=card)


def ssod_phase(card):
    log("== phase 6: SSOD path (full width, 1 + 4 images at 800x1344, "
        "bfloat16 compute, float32 parameters, seeded weights)")
    torch.cuda.reset_peak_memory_stats()
    state, cfg = init_ssod_state(SSOD_CONFIG, device="cuda", seed=0)
    model, projector, teacher = state.model, state.projector, state.teacher
    refine_boxes(model, seed=3)
    log(f"  compute dtype {model.compute_dtype}; max_pseudo {cfg.max_pseudo},"
        f" cons_groups {cfg.cons_groups}, score_thr {cfg.score_thr}")
    batch = to_device(synthetic_ssod_batch(
        SSOD_SUP, SSOD_UNSUP, *SSOD_BUCKET, model.cfg.max_gt,
        gt_per_image=12, seed=0, student_flip=True), "cuda")
    frozen = {k: p.detach().clone() for k, p in model.named_parameters()
              if not p.requires_grad}
    if not frozen:
        raise AssertionError("no frozen parameters")
    records = []
    fwd_total = bwd_total = 0
    for i, (warm_up, thr) in enumerate(SSOD_STEPS):
        step_cfg = cfg if thr is None else dataclasses.replace(
            cfg, score_thr=thr)
        step = make_ssod_train_step(step_cfg, warm_up)
        proj_before = [p.detach().clone() for p in projector.parameters()]
        teacher_before = [p.detach().clone() for p in teacher.parameters()]
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        fwd = msda.ms_deform_attn_cuda.launches
        bwd = msda.ms_deform_attn_bwd_cuda.launches
        fwd_total += fwd
        bwd_total += bwd
        vals = {k: float(v) for k, v in metrics.items()
                if k not in ("pseudo_vis", "pseudo_sets")}
        bad = [k for k, v in vals.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"SSOD step {i}: non-finite {bad}")
        if (fwd, bwd) != SSOD_LAUNCHES[warm_up]:
            raise AssertionError(f"SSOD step {i}: {fwd} forward and {bwd} "
                                 f"backward MSDA launches, not "
                                 f"{SSOD_LAUNCHES[warm_up]}")
        assert_vector(msda.ms_deform_attn_cuda, f"SSOD step {i} forward")
        assert_vector(msda.ms_deform_attn_bwd_cuda, f"SSOD step {i} backward")
        # the projector moves every step: after the warm-up on a zero
        # gradient, by Adam's momentum and the weight decay
        if any(torch.equal(p, q) for p, q in zip(projector.parameters(),
                                                 proj_before)):
            raise AssertionError(f"SSOD step {i}: a projector tensor did not "
                                 "move")
        moved = [k for k, p in model.named_parameters()
                 if k in frozen and not torch.equal(p, frozen[k])]
        if moved:
            raise AssertionError(f"SSOD step {i}: frozen moved: {moved[:5]}")
        # step 0's momentum is 0: the teacher becomes the student it was
        # copied from; from step 1 the EMA moves it
        t_moved = sum(not torch.equal(p, q) for p, q in
                      zip(teacher.parameters(), teacher_before))
        if i and t_moved == 0:
            raise AssertionError(f"SSOD step {i}: the teacher did not move")
        if thr is not None and not vals["sup_set_per_img"] > 0:
            raise AssertionError(f"SSOD step {i}: empty supervision set at "
                                 f"score_thr {thr}")
        rec = dict(step=i, warm_up=warm_up, score_thr=step_cfg.score_thr,
                   ms=dt * 1e3, launches_fwd=fwd, launches_bwd=bwd,
                   teacher_tensors_moved=t_moved,
                   **{k: vals[k] for k in (
                       "total_loss", "grad_norm", "ema_momentum",
                       "pseudo_per_img", "sup_set_per_img",
                       "cons_set_per_img", "gmm_thr")})
        records.append(rec)
        log(f"  step {i} {'warm-up' if warm_up else 'Hungarian'} score_thr "
            f"{step_cfg.score_thr}: {dt * 1e3:.1f} ms, total_loss "
            f"{rec['total_loss']:.4f}, grad_norm {rec['grad_norm']:.4f}, "
            f"pseudo/img {rec['pseudo_per_img']:.2f}, sup set/img "
            f"{rec['sup_set_per_img']:.2f}, cons set/img "
            f"{rec['cons_set_per_img']:.2f}, gmm_thr {rec['gmm_thr']:.4f}, "
            f"MSDA launches {fwd} fwd + {bwd} bwd")
    peak = torch.cuda.max_memory_allocated()
    n_img = SSOD_SUP + SSOD_UNSUP
    # step 0 of each stage carries its first-call costs; the second is warm
    warm = {stage: records[k]["ms"] for stage, k in (("warm_up", 1),
                                                     ("hungarian", 3))}
    log(f"  warm step ms: warm-up {warm['warm_up']:.1f}, Hungarian "
        f"{warm['hungarian']:.1f}; images/s: warm-up "
        f"{n_img / warm['warm_up'] * 1e3:.3f}, Hungarian "
        f"{n_img / warm['hungarian'] * 1e3:.3f}; peak device memory "
        f"{peak / 2 ** 30:.2f} GiB")
    log("  " + card)
    del state, model, projector, teacher, batch
    torch.cuda.empty_cache()
    return dict(steps=records, warm_step_ms=warm,
                images_per_s={k: n_img / v * 1e3 for k, v in warm.items()},
                peak_memory_bytes=peak, launches_fwd=fwd_total,
                launches_bwd=bwd_total, card=card)


def read_evals(log_path):
    """{(tag, step): {metric: value}} from the trainer's Eval lines."""
    out = {}
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Eval\[(\w+)\] iter (\d+): (.*)$", line)
            if m:
                out[(m.group(1), int(m.group(2)))] = {
                    k: float(v) for k, v in (kv.split("=") for kv in
                                             m.group(3).split())}
    return out


def check_aps(res, what):
    """Every AP and AR in [0, 1]; NaN only for the small and medium area
    ranges, which hold no GT box of the synthetic set (all boxes are
    larger than 96 x 96 pixels)."""
    for k, v in res.items():
        if not isinstance(v, float):
            continue
        if math.isnan(v) and k in ("mAP_s", "mAP_m", "AR_s", "AR_m"):
            continue
        if not 0.0 <= v <= 1.0:
            raise AssertionError(f"{what}: {k} = {v}")


def augment_ms(dataset, reps=8):
    """Host ms per weak and per strong view of the set's images at the
    recipe's 11 scales (the prefetch worker's work per view)."""
    rng = np.random.default_rng(0)
    imgs = [dataset.load_image(i) for i in range(4)]
    out = {}
    for name, fn in (("weak", augment.weak_augment),
                     ("strong", augment.strong_augment)):
        t0 = time.perf_counter()
        for r in range(reps):
            fn(rng, augment.make_sample(imgs[r % len(imgs)]))
        out[name] = (time.perf_counter() - t0) / reps * 1e3
    return out


def trainer_phase(card):
    log("== phase 7: trainer path (SSOD CLI at full width from COCO files: "
        "4 steps, eval, checkpoints, resume; eval CLI; supervised CLI)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        return run_trainers(card, tmp)
    finally:
        shutil.rmtree(tmp)


def run_trainers(card, tmp):
    n_img = max(max(r) for r in TRAINER_SPLITS.values()) + 1
    t0 = time.perf_counter()
    paths, img_dir = write_synthetic_coco(tmp, n=n_img, seed=0,
                                          splits=TRAINER_SPLITS,
                                          **TRAINER_SET)
    log(f"  wrote {n_img} PNG images and {len(paths)} annotation files in "
        f"{time.perf_counter() - t0:.1f} s")
    data_opts = [f"data.train_sup_ann={paths['sup']}",
                 f"data.train_unsup_ann={paths['unsup']}",
                 f"data.val_ann={paths['val']}",
                 f"data.train_prefix={img_dir}", f"data.val_prefix={img_dir}"]
    work = os.path.join(tmp, "ssod")
    ssod_args = [SSOD_CONFIG, "--work-dir", work, "--cfg-options",
                 *data_opts, f"ssod.warm_up_step={TRAINER_WARM_UP}",
                 "eval_interval=2", "ckpt_interval=2", "image_log_interval=2"]

    # per-step launch counts, eval and checkpoint times: the trainer's own
    # methods, wrapped for the length of this phase
    per_step, evals, saves, step_ms = [], [], [], {}
    run_step, evaluate = SsodTrainer._run_step, SsodTrainer.evaluate
    maybe_save = ckpt_mod.CheckpointManager.maybe_save

    def counted_step(self, step, batch, vis_img):
        # timed as phase 6 times a step: host clock around the step and a
        # synchronise (the trainer itself does not wait for the device)
        f0 = msda.ms_deform_attn_cuda.launches
        b0 = msda.ms_deform_attn_bwd_cuda.launches
        t0 = time.perf_counter()
        out = run_step(self, step, batch, vis_img)
        torch.cuda.synchronize()
        step_ms[step] = (time.perf_counter() - t0) * 1e3
        per_step.append((step, msda.ms_deform_attn_cuda.launches - f0,
                         msda.ms_deform_attn_bwd_cuda.launches - b0))
        return out

    def timed_eval(self, step, warm_up):
        f0 = msda.ms_deform_attn_cuda.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluate(self, step, warm_up)
        evals.append(dict(step=step, s=time.perf_counter() - t0,
                          launches=msda.ms_deform_attn_cuda.launches - f0,
                          images=len(self.val_dataset)))
        return out

    def timed_save(self, state, force=False):
        t0 = time.perf_counter()
        saved = maybe_save(self, state, force)
        if saved:
            saves.append(dict(step=state.step, s=time.perf_counter() - t0,
                              bytes=os.path.getsize(self.path(state.step))))
        return saved

    SsodTrainer._run_step, SsodTrainer.evaluate = counted_step, timed_eval
    ckpt_mod.CheckpointManager.maybe_save = timed_save
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        trainer = train_detr_ssod.main(
            ssod_args + ["--max-steps", str(TRAINER_STEPS)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        fwd = msda.ms_deform_attn_cuda.launches
        bwd = msda.ms_deform_attn_bwd_cuda.launches
        assert_vector(msda.ms_deform_attn_cuda, "trainer forward")
        assert_vector(msda.ms_deform_attn_bwd_cuda, "trainer backward")
        peak = torch.cuda.max_memory_allocated()
        steps_run = [t["step"] for t in trainer.timings]
        if steps_run != list(range(TRAINER_STEPS)):
            raise AssertionError(f"steps run: {steps_run}")
        for step, f, b in per_step:
            want = SSOD_LAUNCHES[step < TRAINER_WARM_UP]
            if (f, b) != want:
                raise AssertionError(f"trainer step {step}: {f} forward and "
                                     f"{b} backward MSDA launches, not {want}")
        n_batches = -(-len(trainer.val_dataset) // EVAL_BATCH)
        for e in evals:
            # teacher and student: 12 forward launches per eval batch
            if e["launches"] != 2 * n_batches * 12:
                raise AssertionError(f"eval at step {e['step']}: "
                                     f"{e['launches']} launches, not "
                                     f"{2 * n_batches * 12}")
        want_fwd = sum(f for _, f, _ in per_step) + sum(
            e["launches"] for e in evals)
        want_bwd = sum(b for _, _, b in per_step)
        if (fwd, bwd) != (want_fwd, want_bwd) or not evals:
            raise AssertionError(f"trainer run: {fwd} forward / {bwd} "
                                 f"backward launches, evals {evals}")
        ckpts = trainer.ckpt.all_steps()
        if ckpts != [2, 4]:
            raise AssertionError(f"checkpoints on disk: {ckpts}")
        evals_logged = read_evals(os.path.join(work, "train.log"))
        for tag in ("teacher", "student"):
            if (tag, 2) not in evals_logged:
                raise AssertionError(f"no Eval[{tag}] line at step 2")
            check_aps(evals_logged[(tag, 2)], f"Eval[{tag}]")
        with open(os.path.join(work, "metrics.jsonl")) as f:
            first = json.loads(f.readline())
        if first["step"] != 0 or not math.isfinite(first["total_loss"]):
            raise AssertionError(f"metrics.jsonl starts with {first}")
        for step in (0, 2):
            if not os.path.isfile(os.path.join(work, "pseudo_vis",
                                               f"step_{step}.png")):
                raise AssertionError(f"no pseudo render at step {step}")
        timings = trainer.timings
        val_dataset, unsup = trainer.val_dataset, trainer.unsup_dataset
        del trainer
        torch.cuda.empty_cache()

        # resume: the run goes on from the last checkpoint for one step
        reset_counts()
        resumed = train_detr_ssod.main(
            ssod_args + ["--max-steps", str(TRAINER_STEPS + 1)])
        with open(os.path.join(work, "train.log")) as f:
            resumed_line = f"resumed from step {TRAINER_STEPS}" in f.read()
        if (not resumed_line or [t["step"] for t in resumed.timings]
                != [TRAINER_STEPS]):
            raise AssertionError(f"resume: log line {resumed_line}, steps "
                                 f"{[t['step'] for t in resumed.timings]}")
        del resumed
        torch.cuda.empty_cache()
    finally:
        SsodTrainer._run_step, SsodTrainer.evaluate = run_step, evaluate
        ckpt_mod.CheckpointManager.maybe_save = maybe_save

    # the eval CLI on the last checkpoint, on the teacher (the default)
    t0 = time.perf_counter()
    res = test_cli.main([SSOD_CONFIG, "--work-dir", work, "--cfg-options",
                         *data_opts])
    test_s = time.perf_counter() - t0
    check_aps(res, "eval CLI")
    if not math.isfinite(res["mAP"]):
        raise AssertionError(f"eval CLI mAP {res['mAP']}")

    # the supervised CLI: 2 steps of batch 2 from the labelled set
    reset_counts()
    od = train_detr_od.main([
        CONFIG, "--work-dir", os.path.join(tmp, "od"), "--max-steps",
        str(OD_STEPS), "--cfg-options", f"data.train_ann={paths['sup']}",
        "data.val_ann=", f"data.train_prefix={img_dir}",
        f"schedule.batch_size={OD_BATCH}"])
    od_launches = (msda.ms_deform_attn_cuda.launches,
                   msda.ms_deform_attn_bwd_cuda.launches)
    if (od_launches != (12 * OD_STEPS, 12 * OD_STEPS)
            or [t["step"] for t in od.timings] != list(range(OD_STEPS))
            or od.ckpt.all_steps() != [OD_STEPS]):
        raise AssertionError(f"supervised CLI: launches {od_launches}, steps "
                             f"{od.timings}, ckpts {od.ckpt.all_steps()}")
    assert_vector(msda.ms_deform_attn_cuda, "supervised CLI forward")
    od_timings = od.timings
    del od
    torch.cuda.empty_cache()

    aug = augment_ms(unsup)
    eval_ms = [e["s"] * 1e3 / (2 * e["images"]) for e in evals]
    wait_ms = [t["data_wait_s"] * 1e3 for t in timings]
    # step 0 of each stage carries its first-call costs; the second is warm
    warm = {"warm_up": step_ms[1], "hungarian": step_ms[3]}
    log(f"  SSOD CLI: {TRAINER_STEPS} steps ({TRAINER_WARM_UP} warm-up) in "
        f"{run_s:.1f} s with eval and checkpoints; MSDA launches per step "
        f"{[(f, b) for _, f, b in per_step]}, per eval {evals[0]['launches']}"
        f" ({len(val_dataset)} images, teacher and student)")
    log(f"  warm step ms (host clock around the step and a synchronise): "
        f"warm-up {warm['warm_up']:.1f}, Hungarian "
        f"{warm['hungarian']:.1f}; train.data_wait ms per step "
        f"{[round(w, 1) for w in wait_ms]}")
    log(f"  augmentation ms per view at the 11 COCO scales: weak "
        f"{aug['weak']:.1f}, strong {aug['strong']:.1f}")
    log(f"  eval ms per image per model {[round(e, 1) for e in eval_ms]}; "
        f"eval CLI {test_s:.1f} s, teacher mAP {res['mAP']:.4f}")
    log("  checkpoint saves (step, s, bytes) "
        f"{[(c['step'], round(c['s'], 2), c['bytes']) for c in saves]}; "
        f"peak device memory {peak / 2 ** 30:.2f} GiB")
    log(f"  supervised CLI: {OD_STEPS} steps of batch {OD_BATCH}, step s "
        f"{[round(t['step_s'], 3) for t in od_timings]}")
    log("  " + card)
    return dict(steps=timings, launches_per_step=per_step, evals=evals,
                step_ms=step_ms, warm_step_ms=warm, data_wait_ms=wait_ms,
                augment_ms=aug,
                eval_ms_per_image=eval_ms, checkpoint_saves=saves,
                peak_memory_bytes=peak, run_s=run_s, eval_cli_s=test_s,
                eval_cli=res, od_steps=od_timings,
                launches_fwd=fwd, launches_bwd=bwd, card=card)


def leaf_errors(grads_k, grads_p):
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                 for g in grads_p.values())))
    errs = {}
    for k, gp in grads_p.items():
        gk = grads_k[k]
        if (gp.norm() < NEGLIGIBLE * gnorm
                and gk.norm() < NEGLIGIBLE * gnorm):
            continue
        errs[k] = float((gk.double() - gp.double()).norm()
                        / gp.double().norm().clamp(min=1e-30))
    return errs


class MixedMSDA(torch.autograd.Function):
    """MSDA whose forward and backward each come from the kernel or from
    the plain version: phase 5b's witnesses that isolate one kernel."""

    @staticmethod
    def forward(ctx, value, shapes, loc, attn, fwd_kernel, bwd_kernel):
        ctx.shapes, ctx.bwd_kernel = tuple(shapes), bwd_kernel
        ctx.save_for_backward(value, loc, attn)
        fwd = msda.ms_deform_attn_cuda if fwd_kernel else ms_deform_attn
        return fwd(value, shapes, loc, attn)

    @staticmethod
    def backward(ctx, g):
        value, loc, attn = ctx.saved_tensors
        bwd = (msda.ms_deform_attn_bwd_cuda if ctx.bwd_kernel
               else ms_deform_attn_backward)
        d_value, d_loc, d_attn = bwd(value, ctx.shapes, loc, attn,
                                     g.contiguous())
        return d_value, None, d_loc, d_attn, None, None


def model_grad_phase():
    log("== phase 5b: both kernels inside the model, float32 gradients")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pred = init_detector(CONFIG, None, device="cuda", use_nms=False, seed=1,
                         cfg_options={"model.dtype": "float32"})
    det = refine_boxes(pred.detector, seed=2)
    img = np.random.RandomState(2).randint(0, 256, (599, 401, 3)).astype(
        np.uint8)
    images, hw, _ = pred.preprocess(img)
    params = {k: p for k, p in det.named_parameters()}
    gen = torch.Generator("cuda").manual_seed(3)
    noise_gen = torch.Generator("cuda").manual_seed(4)
    kernels = tr.ms_deform_attn_auto

    def rounded(value, shapes, loc, attn):
        """The plain version with its output moved by about one float32
        rounding (a relative 2**-24 draw, added in float32)."""
        out = ms_deform_attn(value, shapes, loc, attn)
        r = torch.rand(out.shape, device="cuda", generator=noise_gen)
        return out + out.detach() * ((2 * r - 1) * 2 ** -24)

    dispatch = {
        "kernels": kernels,
        "plain": ms_deform_attn,
        "kernel_fwd_plain_bwd": lambda v, s, lc, a: MixedMSDA.apply(
            v, s, lc, a, True, False),
        "plain_fwd_kernel_bwd": lambda v, s, lc, a: MixedMSDA.apply(
            v, s, lc, a, False, True),
        "plain_rounded": rounded,
    }

    def grads_of(loss_fn, name):
        det.zero_grad(set_to_none=True)
        tr.ms_deform_attn_auto = dispatch[name]
        try:
            loss_fn().backward()
        finally:
            tr.ms_deform_attn_auto = kernels
        return {k: p.grad.detach().clone() for k, p in params.items()
                if p.grad is not None}

    proj_mem = None

    def enc_loss():
        nonlocal proj_mem
        mem = det.encode_images(images, hw)["memory"]
        if proj_mem is None:
            proj_mem = torch.randn(mem.shape, device="cuda", generator=gen)
        return (mem.float() * proj_mem).sum()

    bwd0 = msda.ms_deform_attn_bwd_cuda.launches
    g = {"kernels": grads_of(enc_loss, "kernels")}
    if msda.ms_deform_attn_bwd_cuda.launches - bwd0 != 6:
        raise AssertionError("the encoder backward did not run the kernel")
    for name in dispatch:
        if name != "kernels":
            g[name] = grads_of(enc_loss, name)
    # the kernels against themselves: the d_value scatter's atomic order
    # is not fixed, so this is the noise floor of every comparison
    g["kernels_again"] = grads_of(enc_loss, "kernels")
    # (name, got, reference, limit): the comparison of record (both
    # kernels against both plain versions), then each kernel alone, then
    # the witnesses with no limit of their own
    comparisons = [
        ("encoder", "kernels", "plain", TOL_GRAD_LEAF),
        ("encoder_bwd_kernel_on_kernel_fwd", "kernels",
         "kernel_fwd_plain_bwd", TOL_BWD_ONLY),
        ("encoder_bwd_kernel_on_plain_fwd", "plain_fwd_kernel_bwd", "plain",
         TOL_BWD_ONLY),
        ("encoder_fwd_kernel", "kernel_fwd_plain_bwd", "plain",
         TOL_GRAD_LEAF),
        ("encoder_kernel_vs_kernel", "kernels_again", "kernels", None),
        ("encoder_plain_vs_rounded_plain", "plain_rounded", "plain", None),
    ]
    errs = {part: (leaf_errors(g[a], g[b]), tol)
            for part, a, b, tol in comparisons}
    del g
    torch.cuda.empty_cache()

    with torch.no_grad():
        enc = det.encode_images(images, hw)         # one shared selection
    proj_hs = None

    def dec_loss():
        nonlocal proj_hs
        hs = det.decode_queries(enc)["hs"]
        if proj_hs is None:
            proj_hs = torch.randn(hs.shape, device="cuda", generator=gen)
        return (hs.float() * proj_hs).sum()

    bwd0 = msda.ms_deform_attn_bwd_cuda.launches
    gk = grads_of(dec_loss, "kernels")
    if msda.ms_deform_attn_bwd_cuda.launches - bwd0 != 6:
        raise AssertionError("the decoder backward did not run the kernel")
    gd = {"kernels": gk}
    for name in dispatch:
        if name != "kernels":
            gd[name] = grads_of(dec_loss, name)
    gd["kernels_again"] = grads_of(dec_loss, "kernels")
    # the encoder's comparisons on the decoder, with the decoder's limit
    # where the encoder's is TOL_GRAD_LEAF
    for part, a, b, tol in comparisons:
        errs["decoder" + part[len("encoder"):]] = (
            leaf_errors(gd[a], gd[b]),
            {TOL_GRAD_LEAF: TOL_DECODER_LEAF}.get(tol, tol))
    del gd
    summary, failed = {}, []
    for part, (e, tol) in errs.items():
        worst = max(e, key=e.get)
        summary[part] = dict(leaves=len(e), worst_leaf=worst,
                             worst_rel_l2=e[worst],
                             median_rel_l2=float(np.median(list(
                                 e.values()))), tol=tol)
        log(f"  {part}: {len(e)} leaves, worst relative L2 {e[worst]:.3e} "
            f"({worst}), median {summary[part]['median_rel_l2']:.3e} "
            f"(tol {tol})")
        if len(e) < 20 or (tol is not None and e[worst] > tol):
            failed.append(part)
    if failed:
        raise AssertionError(f"gradients out of tolerance: "
                             f"{[(p, summary[p]) for p in failed]}")
    del det, pred, enc, gk
    torch.cuda.empty_cache()
    return summary


def main():
    log("== phase 1: device")
    card = card_line()
    log(card)
    name = torch.cuda.get_device_name(0)

    log("== phase 2: build")
    t0 = time.perf_counter()
    paths, build_log = msda.build()
    build_s = time.perf_counter() - t0
    log(f"  built {', '.join(paths)} in {build_s:.1f} s")
    for line in ptxas_summary(build_log):
        log("  ptxas: " + line)

    phase_s = {"2": build_s}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[phase] = time.perf_counter() - t0
        log(f"  phase {phase}: {phase_s[phase]:.1f} s")
        return out

    rows = timed("3", kernel_phase)
    bwd_rows = timed("3b", backward_kernel_phase)
    launches, latency = timed("4", main_path_phase)
    if msda.ms_deform_attn_bwd_cuda.launches != 0:
        raise AssertionError("the serving path launched the backward kernel")
    errs = timed("4b", float32_phase)
    train = timed("5", train_phase, card)
    grad_check = timed("5b", model_grad_phase)
    ssod = timed("6", ssod_phase, card)
    trainer = timed("7", trainer_phase, card)

    main_rows = [r for r in rows if r["dtype"] == "bfloat16"
                 and r["case"] in ("encoder", "decoder")]
    bwd_main = [r for r in bwd_rows if r["dtype"] == "bfloat16"
                and r["case"] in ("encoder", "decoder")]

    def per_call_sums(rs):
        """6 encoder + 6 decoder calls."""
        return {k: sum(6 * r[k] for r in rs)
                for k in ("ms", "plain_ms", "bound_ms")}

    per_image, per_step = per_call_sums(main_rows), per_call_sums(bwd_main)
    record = {"kernels": [{
        "name": "ms_deform_attn_fwd",
        "route": "cuda",
        "source": "semi_detr_tpu_torch/csrc/ms_deform_attn_fwd.cu",
        "replaces": "semi_detr_tpu/ops/ms_deform_attn_pallas.py:277",
        # the training path's run (phase 5); the serving path's in
        # launches_by_path
        "launches": train["launches_fwd"],
        "launches_by_path": {"serve": launches,
                             "train": train["launches_fwd"],
                             "ssod": ssod["launches_fwd"],
                             "trainer": trainer["launches_fwd"]},
        "max_abs_err": max(r["max_abs_err"] for r in main_rows),
        # per image on the serving path (bfloat16, N=1): 6 encoder + 6
        # decoder calls
        "ms": per_image["ms"],
        "plain_ms": per_image["plain_ms"],
        "bound_ms": per_image["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                   for r in main_rows) else "operations",
        "library_ms": None,
        "cases": rows,
    }, {
        "name": "ms_deform_attn_bwd",
        "route": "cuda",
        "source": "semi_detr_tpu_torch/csrc/ms_deform_attn_bwd.cu",
        "replaces": "semi_detr_tpu/ops/ms_deform_attn_pallas.py:521",
        "launches": train["launches_bwd"],
        "launches_by_path": {"serve": 0, "train": train["launches_bwd"],
                             "ssod": ssod["launches_bwd"],
                             "trainer": trainer["launches_bwd"]},
        "max_abs_err": max(max(r["max_abs_err"].values()) for r in bwd_main),
        # per training step (batch 2, bfloat16): 6 encoder + 6 decoder calls
        "ms": per_step["ms"],
        "plain_ms": per_step["plain_ms"],
        "bound_ms": per_step["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                   for r in bwd_main) else "operations",
        "library_ms": None,
        "cases": bwd_rows,
    }], "card": card, "build_s": build_s, "phase_s": phase_s,
        "request_ms": {k: v * 1e3 for k, v in latency.items()},
        "float32_request_err": errs, "train": train,
        "float32_grad_check": grad_check, "ssod": ssod, "trainer": trainer}
    print(json.dumps(json_safe(record), allow_nan=False), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
