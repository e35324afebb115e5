"""Export the detector's serving program: `torch.export`, and packaged
by AOTInductor.

Counterpart of `tools/misc/export_model.py` (the JAX package exports the
jitted predict function to StableHLO, which an XLA runtime runs without
Python). Here `models.inference.ServingProgram` (the teacher's forward
and decode, top-k or NMS) is traced by `torch.export.export` at a fixed
batch and bucket, with the weights inside the program. The inputs are
(images (B, H, W, 3) uint8, as `api.Predictor.preprocess` packs them;
img_hw (B, 2) int32), the outputs (boxes, scores, labels). MSDA is in the
program as the operator `semi_detr::ms_deform_attn`, and the NMS fixpoint
as a `while_loop`. One bucket per artifact, as in the JAX CLI: a portrait
request needs its own, `--bucket 1344,800`.

Two artifacts, chosen by `--package`:

* without it, the `ExportedProgram` written by `torch.export.save`
  (`.pt2`): it needs torch and this package's operator registry to run
  (importing `semi_detr_tpu_torch.ops.ms_deform_attn_cuda` registers the
  operators; this tool does), and `torch.export.load` runs it;
* with it, the same `ExportedProgram` compiled by
  `torch._inductor.aoti_compile_and_package` into a package of native
  code for the device it was exported on, weights included
  (`package_program`). It runs without Python: libtorch loads it
  (`AOTIModelPackageLoader`) and calls MSDA by name, which the C++
  operator library `csrc/msda_op.cpp` (`ops/msda_cpp.py`) registers
  around the same forward kernel; `tools/serve_runner.py` builds and runs
  such a process on packed requests. In a Python process
  `torch._inductor.aoti_load_package` loads it, and the Python operator
  serves its MSDA calls (`ms_deform_attn_cuda.launches` counts them).

`--load` takes either kind (`load_program` tells them apart by their
contents) and `--selftest` runs it on zero images; after an export with
`--package` the selftest runs the exported program and the package.

Usage:
  python -m semi_detr_tpu_torch.tools.export_model CONFIG \\
      [--checkpoint CKPT] --out model.pt2 [--batch 1] [--bucket 800,1344] \\
      [--with-nms] [--package] [--device cuda] [--selftest]
  python -m semi_detr_tpu_torch.tools.export_model CONFIG --load model.pt2 \\
      --selftest           # load and run on zero images, print shapes

CKPT is a checkpoint file or directory of this package, or a reference
`.pth`; without one the detector takes the seeded init. The teacher is
exported: serving runs the teacher (reference `tools/test.py:195-200`).
"""
from __future__ import annotations

import functools
import os
import shutil
import subprocess
import tempfile
import time
import zipfile
from typing import Optional

import torch

from ..models.inference import ServingProgram
from ..ops import ms_deform_attn_cuda  # noqa: F401  registers the MSDA ops
from ..utils.config import parse_cfg_options
from .common import base_parser, load_cfg


def example_inputs(batch: int, bucket, device):
    """Zero images (batch, H, W, 3) uint8 and their full extent."""
    h, w = bucket
    return (torch.zeros((batch, h, w, 3), dtype=torch.uint8, device=device),
            torch.tensor([[h, w]] * batch, dtype=torch.int32, device=device))


def build_teacher(args):
    """The detector of the CLI's config with the teacher's weights of
    --checkpoint (or the seeded init), in eval mode on --device."""
    from ..api import init_detector
    cfg = load_cfg(args)
    return init_detector(args.config, args.checkpoint, args.device,
                         seed=cfg.get("seed", 0),
                         cfg_options=parse_cfg_options(
                             args.cfg_options)).detector


def export_program(detector, batch: int, bucket, use_nms: bool = False):
    """`ServingProgram(detector)` traced by `torch.export` at (batch,
    bucket) on the detector's device."""
    device = next(detector.parameters()).device
    with torch.no_grad():
        return torch.export.export(
            ServingProgram(detector, use_nms).eval(),
            example_inputs(batch, bucket, device))


def _compiles_openmp(cxx: str) -> bool:
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "omp.cpp")
        with open(src, "w") as f:
            f.write("#include <omp.h>\nint main() { return "
                    "omp_get_max_threads() > 0 ? 0 : 1; }\n")
        try:
            return subprocess.run(
                [cxx, "-fopenmp", src, "-o", os.path.join(tmp, "a.out")],
                capture_output=True, timeout=120).returncode == 0
        except (OSError, subprocess.TimeoutExpired):
            return False


@functools.lru_cache(maxsize=None)
def package_cxx() -> Optional[str]:
    """The C++ compiler for AOTInductor's build of a package, or None to
    keep Inductor's own ($CXX, else g++). Inductor compiles and links the
    package's C++ with -fopenmp on Linux, and a compiler without OpenMP
    fails there (the card's machine sets $CXX to a g++ whose libgomp spec
    file is missing): the first of $CXX, the g++ on PATH and /usr/bin/g++
    that builds an OpenMP program is taken; none raises."""
    default = os.environ.get("CXX", "g++")
    for cxx in (default, shutil.which("g++"), "/usr/bin/g++"):
        if cxx and _compiles_openmp(cxx):
            return None if cxx == default else cxx
    raise RuntimeError("no C++ compiler here builds OpenMP code ($CXX, g++):"
                       " AOTInductor compiles a package with -fopenmp")


# Inductor's options for a package: the wrapper (host code that launches
# the kernels) compiled at -O0, and one launch configuration per pointwise
# kernel instead of several benchmarked at compile time. On the card the
# full-width top-k program compiled in 135.5 s with them against 191.1 and
# 243.3 s with Inductor's defaults (three calls of chip_smoke.py phase 9b),
# and served a request in 7.56 against 7.53 and 9.04 ms (NVIDIA H100 80GB
# HBM3, 700.00 W).
PACKAGE_CONFIGS = {"aot_inductor.compile_wrapper_opt_level": "O0",
                   "triton.autotune_pointwise": False}


def package_program(exported, path: str) -> str:
    """The `ExportedProgram` compiled by AOTInductor into a package at
    `path` (native code for its device, weights inside; PACKAGE_CONFIGS,
    the C++ built by `package_cxx()`); returns path."""
    cxx = package_cxx()
    configs = dict(PACKAGE_CONFIGS)
    if cxx is not None:
        configs["cpp.cxx"] = (None, cxx)
    return torch._inductor.aoti_compile_and_package(
        exported, package_path=path, inductor_configs=configs)


def is_package(path: str) -> bool:
    """Whether `path` is an AOTInductor package (else a `torch.export`
    artifact): a package holds its compiled model under
    `data/aotinductor/`."""
    with zipfile.ZipFile(path) as z:
        return any("/data/aotinductor/" in n for n in z.namelist())


def load_program(path: str):
    """Either artifact as a callable: (images, img_hw) -> (boxes, scores,
    labels). Call it under `torch.inference_mode()`."""
    if is_package(path):
        return torch._inductor.aoti_load_package(path)
    return torch.export.load(path).module()


def selftest(program, batch: int, bucket, device):
    with torch.inference_mode():
        boxes, scores, labels = program(*example_inputs(batch, bucket,
                                                        device))
    print("selftest ok:", tuple(boxes.shape), tuple(scores.shape),
          tuple(labels.shape), flush=True)
    return boxes, scores, labels


def main(argv=None):
    p = base_parser(__doc__)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file or directory of this package, or "
                        "a reference .pth; omitted = the seeded init")
    p.add_argument("--out", default="model.pt2")
    p.add_argument("--load", default=None,
                   help="load an existing artifact instead of exporting")
    p.add_argument("--selftest", action="store_true",
                   help="run the program on zero images")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--bucket", default="800,1344")
    p.add_argument("--with-nms", action="store_true",
                   help="the NMS decode (warm-up-stage semantics); default "
                        "is the main-stage top-k decode")
    p.add_argument("--package", action="store_true",
                   help="write an AOTInductor package (runs without "
                        "Python) instead of a torch.export program")
    args = p.parse_args(argv)
    bucket = tuple(int(v) for v in args.bucket.split(","))

    if args.load:
        t0 = time.perf_counter()
        program = load_program(args.load)
        print(f"loaded {args.load} "
              f"({'package' if is_package(args.load) else 'torch.export'}) "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        if args.selftest:
            selftest(program, args.batch, bucket, args.device)
        return program

    det = build_teacher(args)
    t0 = time.perf_counter()
    exported = export_program(det, args.batch, bucket, args.with_nms)
    if args.package:
        package_program(exported, args.out)
    else:
        torch.export.save(exported, args.out)
    print(f"wrote {args.out} "
          f"({'package' if args.package else 'torch.export'}): "
          f"{os.path.getsize(args.out) / 1e6:.1f} MB in "
          f"{time.perf_counter() - t0:.1f} s, batch {args.batch}, bucket "
          f"{bucket}, {'NMS' if args.with_nms else 'top-k'} decode, "
          f"device {args.device}", flush=True)
    if args.selftest:
        selftest(exported.module(), args.batch, bucket, args.device)
        if args.package:
            selftest(load_program(args.out), args.batch, bucket,
                     args.device)
    return exported


if __name__ == "__main__":
    main()
