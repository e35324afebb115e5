"""Drive the serving runner: the packaged program run by a process
without Python.

`csrc/serve_main.cpp` is built by g++ against libtorch at first use into
`_build/<hash>/sdt_serve` (`build`). `run` packs requests into the
runner's request file (`pack_requests`: the layout in the source's
header), starts the runner with an emptied environment (only
`LD_LIBRARY_PATH`, `TMPDIR` and the `CUDA_*` variables are passed on),
and reads back its outputs (boxes, scores, labels per request), the MSDA
launches of each request by instance width (the C++ operator library's
counts, `ops/msda_cpp.py`), and its warm ms per request. The runner never
imports this package; `python_free` reads its `ldd` for libpython.

Usage (on the card; the package from `tools.export_model --package`):
  python -m semi_detr_tpu_torch.tools.serve_runner PACKAGE \\
      [--bucket 800,1344] [--requests 2] [--reps 5] [--device cuda]

runs the package on seeded random requests and prints the runner's
report.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..ops import msda_cpp

SOURCE = "serve_main.cpp"
BINARY = "sdt_serve"
REQUEST_MAGIC, OUTPUT_MAGIC = b"SDTREQ1\0", b"SDTOUT1\0"
DTYPES = {0: np.float32, 1: np.int32, 2: np.int64}


def binary_path(cuda: bool) -> str:
    flags = msda_cpp.torch_flags(cuda)
    src = os.path.join(msda_cpp.msda.CSRC, SOURCE)
    return os.path.join(msda_cpp.build_dir([src], flags), BINARY)


def build(cuda: bool = True) -> Tuple[str, str]:
    """The runner binary, built if missing; with `cuda` linked against
    libtorch_cuda. Returns (path, g++'s log; empty when it existed)."""
    out = binary_path(cuda)
    if os.path.exists(out):
        return out, ""
    log = msda_cpp.gxx([os.path.join(msda_cpp.msda.CSRC, SOURCE)], out,
                       msda_cpp.torch_flags(cuda) + ["-ldl"], shared=False)
    return out, log


def python_free(binary: str) -> Tuple[bool, str]:
    """(whether `ldd` lists no libpython, ldd's output)."""
    out = subprocess.run(["ldd", binary], capture_output=True,
                         text=True).stdout
    return "libpython" not in out, out


def pack_requests(path: str, requests: Sequence[Tuple[np.ndarray,
                                                      np.ndarray]]):
    """Write (images (B, H, W, 3) uint8, img_hw (B, 2) int32) pairs, all of
    one shape, in the runner's request layout."""
    b, h, w, _ = requests[0][0].shape
    with open(path, "wb") as f:
        f.write(REQUEST_MAGIC)
        f.write(np.asarray([len(requests), b, h, w], "<i4").tobytes())
        for images, img_hw in requests:
            if images.shape != (b, h, w, 3) or images.dtype != np.uint8:
                raise ValueError(f"images {images.shape} {images.dtype}: "
                                 f"expected ({b}, {h}, {w}, 3) uint8")
            f.write(np.ascontiguousarray(images).tobytes())
            f.write(np.ascontiguousarray(img_hw, "<i4").reshape(
                b, 2).tobytes())


def read_outputs(path: str) -> List[List[np.ndarray]]:
    """The runner's outputs: per request, its K arrays."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != OUTPUT_MAGIC:
        raise ValueError(f"{path}: not a runner output file")
    r, k = np.frombuffer(data, "<i4", 2, 8)
    pos, out = 16, []
    for _ in range(r):
        run = []
        for _ in range(k):
            code, ndim = np.frombuffer(data, "<i4", 2, pos)
            shape = tuple(np.frombuffer(data, "<i8", ndim, pos + 8))
            pos += 8 + 8 * ndim
            dt = np.dtype(DTYPES[int(code)])
            n = int(np.prod(shape))
            run.append(np.frombuffer(data, dt, n, pos).reshape(shape).copy())
            pos += n * dt.itemsize
        out.append(run)
    return out


def runner_env() -> Dict[str, str]:
    """The runner's whole environment: the library path, the temporary
    directory (the package is unpacked there) and the CUDA variables."""
    return {k: v for k, v in os.environ.items()
            if k in ("LD_LIBRARY_PATH", "TMPDIR") or k.startswith("CUDA_")}


def run(package: str, requests, device: str = "cuda", reps: int = 5,
        op_library: str = None, timeout: float = 600) -> Dict:
    """Run `package` in the runner on `requests` ((images, img_hw) numpy
    pairs). On a CUDA device the MSDA operator library is built and loaded
    (`op_library` overrides its path; "-" loads none). Returns the
    runner's report (load_s, runs with launches by width, warm_ms) with
    `outputs` (per request [boxes, scores, labels]) and `wall_s`."""
    cuda = device.startswith("cuda")
    binary = build(cuda)[0]
    if op_library is None:
        op_library = msda_cpp.build()[0] if cuda else "-"
    with tempfile.TemporaryDirectory(prefix="sdt_serve_") as tmp:
        req, out = os.path.join(tmp, "requests.bin"), os.path.join(
            tmp, "outputs.bin")
        pack_requests(req, requests)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [binary, package, op_library, req, out, device, str(reps)],
            capture_output=True, text=True, env=runner_env(),
            timeout=timeout)
        wall_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"the runner exited {proc.returncode}:\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        report["outputs"] = read_outputs(out)
    report["wall_s"] = wall_s
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("package")
    p.add_argument("--bucket", default="800,1344")
    p.add_argument("--requests", type=int, default=2)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the package runs on the card "
                         "(--device cpu for a CPU package)")
    h, w = (int(v) for v in args.bucket.split(","))
    rng = np.random.RandomState(args.seed)
    reqs = [(rng.randint(0, 256, (1, h, w, 3)).astype(np.uint8),
             np.asarray([[h, w]], np.int32)) for _ in range(args.requests)]
    report = run(args.package, reqs, args.device, args.reps)
    print(json.dumps({k: v for k, v in report.items() if k != "outputs"}),
          flush=True)
    for i, outs in enumerate(report["outputs"]):
        print(f"request {i}:", [(a.shape, str(a.dtype)) for a in outs],
              flush=True)
    return report


if __name__ == "__main__":
    main()
