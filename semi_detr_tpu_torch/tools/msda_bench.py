"""Time the MSDA kernels of a source tree at the main path's shapes.

    python3 semi_detr_tpu_torch/tools/msda_bench.py [--tree DIR]

Imports `semi_detr_tpu_torch` from DIR (default: the checkout that holds
this file), builds its kernels with its own `build()`, and times its
wrappers `ms_deform_attn_cuda` and `ms_deform_attn_bwd_cuda` with CUDA
events at the shapes of `chip_smoke.py` phases 3 and 3b: the forward at
N = 1 (encoder Lq = S = 22,323; decoder Lq = 900) and the backward at
N = 2 (encoder; decoder Lq = 1,100), M = 8, D = 32, L = 4, P = 4, in
float32 and bfloat16, from seeded inputs. It checks nothing: the plain
versions hold the kernels in `chip_smoke.py` and the card tests.

Per call it prints the kernel ms, the bound (the least time the card could
take: bytes over the HBM rate or flops over the float32 rate, whichever
is larger), the ratio, the rate of gathered value rows (4 corner rows of
D channels per tap) and, for the backward, the device time by kernel
(torch.profiler: the backward kernel, the bf16 cast, the scratch memset).
Also the ptxas register and spill lines of the build, and the host cost
of the dispatch: microseconds per call of `ms_deform_attn_auto` (the
model's entry: the registered operator `semi_detr::ms_deform_attn`, or in
a tree before it the autograd Function), with and without inputs that
require grad, and of the bare wrapper `ms_deform_attn_cuda`, in bfloat16
at the decoder's shape (the host clock around CALLS calls, synchronised
before and after). The last line is a JSON object of all of it.

Compare two trees on one card in one call by running this for each in
turns (parent, new, new, parent): every run builds its tree's kernels
into that tree's `_build/`.

This module is also the yardstick of `chip_smoke.py` and of the card
tests: they take from here the main path's levels and widths, the seeded
inputs (`msda_inputs`, `edge_coord`), the bounds (`bound`, `bound_bwd`),
the gathered-row bytes and the timer (`cuda_ms`). An edit to any of these
changes what the smoke run checks and reports.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

import numpy as np

SHAPES = ((100, 168), (50, 84), (25, 42), (13, 21))   # 800x1344 bucket
S = sum(h * w for h, w in SHAPES)
M, D, P = 8, 32, 4
L = len(SHAPES)
# H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM3 bytes/s, and float32
# FLOP/s outside the tensor cores (the kernels' arithmetic is CUDA-core
# float32 whatever the storage type)
PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12
FWD_CASES = (("encoder", 1, S), ("decoder", 1, 900))
BWD_CASES = (("encoder", 2, S), ("decoder", 2, 900 + 200))
REPS = 50           # timed runs per forward call; the backward takes half
CALLS = 2000        # calls per dispatch timing


def edge_coord(extent):
    """A float32 location whose pixel coordinate, loc * extent - 0.5 as the
    kernels round it, is exactly -1: the map's lower edge, where a tap adds
    0 to the output but has a one-sided derivative."""
    f32 = np.float32
    x = f32(-0.5 / extent)
    for step in range(64):
        for cand in (x + f32(step) * np.spacing(x), x - f32(step) *
                     np.spacing(x)):
            cand = f32(cand)
            if f32(f32(cand * f32(extent)) - f32(0.5)) == f32(-1):
                return float(cand)
    raise ValueError(f"no float32 edge location for extent {extent}")


def msda_inputs(lq, dtype, seed, oob=False, n=1):
    """Seeded value (n, S, M, D) in dtype, loc and softmaxed attn on the
    card. oob: two thirds of the taps off the maps, plus NaN, +-1e30 and
    taps exactly on pixel coordinate -1."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    value = torch.randn(n, S, M, D, device="cuda", generator=g).to(dtype)
    loc = torch.rand(n, lq, M, L, P, 2, device="cuda", generator=g)
    if oob:
        loc = loc * 3.0 - 1.0                     # two thirds off the maps
        loc[:, ::7, :, :, 0, 0] = float("nan")
        loc[:, 1::7, :, :, 1, 1] = 1e30
        loc[:, 2::7, :, :, 2, 0] = -1e30
        for lvl, (h, w) in enumerate(SHAPES):     # exactly on the lower edge
            loc[:, 3::7, :, lvl, 3, 0] = edge_coord(w)
            loc[:, 4::7, :, lvl, 3, 1] = edge_coord(h)
    attn = torch.randn(n, lq, M, L * P, device="cuda",
                       generator=g).softmax(-1).view(n, lq, M, L, P)
    return value, loc, attn


def _esize(dtype):
    import torch
    return torch.finfo(dtype).bits // 8


def _bounded(nbytes, flops):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bound(lq, dtype, n=1):
    """(ms, 'bytes'|'operations') of the forward: value + loc + attn + out
    each once, and 8 flops per channel per tap (4 corner multiply-adds)."""
    esize = _esize(dtype)
    taps = n * lq * M * L * P
    nbytes = (n * S * M * D * esize + taps * 2 * 4 + taps * 4
              + n * lq * M * D * esize)
    return _bounded(nbytes, taps * D * 8)


def bound_bwd(n, lq, dtype):
    """(ms, 'bytes'|'operations') of the backward: read value, loc, attn
    and g; write d_value (in value's dtype), d_loc and d_attn, each once.
    The kernel's float32 d_value scratch buffer is its own design's cost,
    not the function's, and is not counted. 16 flops per channel per tap
    (4 corners: a dot multiply-add, a scale and an add into d_value)."""
    esize = _esize(dtype)
    taps = n * lq * M * L * P
    v_elems, g_elems = n * S * M * D, n * lq * M * D
    nbytes = (2 * v_elems * esize + g_elems * esize + 2 * (taps * 2 * 4)
              + 2 * (taps * 4))
    return _bounded(nbytes, taps * D * 16)


def gathered_bytes(n, lq, dtype):
    """Bytes of value rows the taps gather: 4 corner rows of D channels."""
    return n * lq * M * L * P * 4 * D * _esize(dtype)


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps warm runs (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms_by_kernel(fn, reps):
    """Device ms per call of fn(), by kernel name (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            # "void (anonymous namespace)::msda_bwd_kernel<...>(...)": the
            # first identifier followed by its template or argument list
            found = re.search(r"(\w+)[<(]", e.name)
            name = found.group(1) if found else e.name
            out[name] = out.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / reps
    return out


def ptxas_summary(log):
    """['kernel<T, VEC, G>: N registers, S/L bytes spilled (stores/loads)']
    from nvcc's -Xptxas -v log, one line per kernel instance."""
    types = {"f": "float", "13__nv_bfloat16": "bf16"}
    out, name, spill = [], None, ""
    for line in log.splitlines():
        props = re.search(r"Function properties for (\S+)", line)
        if props:
            mangled = props.group(1)
            # kernel<T, VEC, G>, kernel<T> or a plain function
            inst = re.search(r"\d+(msda_\w+?_kernel)I(f|13__nv_bfloat16)"
                             r"(?:Li(\d+)ELi(\d+)E)?E", mangled)
            plain = re.search(r"\d+(cast_to_bf16)", mangled)
            name = ("{}<{}>".format(inst.group(1), ", ".join(
                        [types[inst.group(2)]] + [g for g in inst.groups()[2:]
                                                  if g]))
                    if inst else plain.group(1) if plain else mangled)
        stores = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", line)
        if stores:
            spill = f"{stores.group(1)}/{stores.group(2)}"
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            out.append(f"{name}: {regs.group(1)} registers, {spill} bytes "
                       f"spilled (stores/loads)")
            name = None
    return out


def dispatch_us(msda):
    """Host us per call of the model's dispatch (`ms_deform_attn_auto`,
    without and with inputs that require grad) and of the bare wrapper."""
    import torch
    value, loc, attn = msda_inputs(900, torch.bfloat16, seed=0)
    grads = [t.detach().clone().requires_grad_(True)
             for t in (value, loc, attn)]
    out = {}
    for name, fn, args in (("auto", msda.ms_deform_attn_auto,
                            (value, loc, attn)),
                           ("auto_grad", msda.ms_deform_attn_auto, grads),
                           ("wrapper", msda.ms_deform_attn_cuda,
                            (value, loc, attn))):
        v, lo, a = args
        for _ in range(50):
            fn(v, SHAPES, lo, a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn(v, SHAPES, lo, a)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        out[name] = host / CALLS * 1e6
    return out


def run(msda):
    import torch
    rows = []
    for kind, cases in (("fwd", FWD_CASES), ("bwd", BWD_CASES)):
        for case, n, lq in cases:
            for dtype in (torch.float32, torch.bfloat16):
                value, loc, attn = msda_inputs(lq, dtype, seed=len(rows), n=n)
                if kind == "fwd":
                    def fn():
                        msda.ms_deform_attn_cuda(value, SHAPES, loc, attn)
                    b_ms, b_by = bound(lq, dtype, n)
                    split = None
                else:
                    g = torch.randn(n, lq, M * D, device="cuda").to(dtype)

                    def fn():
                        msda.ms_deform_attn_bwd_cuda(value, SHAPES, loc,
                                                     attn, g)
                    b_ms, b_by = bound_bwd(n, lq, dtype)
                    split = device_ms_by_kernel(fn, 5)
                ms = cuda_ms(fn, REPS if kind == "fwd" else REPS // 2)
                rows.append(dict(
                    kernel=kind, case=case, dtype=str(dtype).split(".")[-1],
                    n=n, lq=lq, ms=ms, bound_ms=b_ms, bound_by=b_by,
                    ratio=ms / b_ms,
                    gathered_bytes_per_s=gathered_bytes(n, lq, dtype)
                    / (ms * 1e-3),
                    device_ms_by_kernel=split))
                print(f"  {kind} {case:8s} {rows[-1]['dtype']:8s} N={n} "
                      f"Lq={lq:6d} {ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})"
                      f"  {ms / b_ms:.1f}x  gathered rows "
                      f"{rows[-1]['gathered_bytes_per_s'] / 1e12:.3f} TB/s"
                      + (f"  by kernel {split}" if split else ""),
                      flush=True)
                del value, loc, attn
                torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tree", default=here,
                    help="checkout whose semi_detr_tpu_torch is timed")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        sys.exit("msda_bench: no CUDA device; this tool runs only on the card")
    from semi_detr_tpu_torch.ops import ms_deform_attn_cuda as msda
    if not os.path.abspath(msda.__file__).startswith(tree + os.sep):
        sys.exit(f"msda_bench: imported {msda.__file__}, not from {tree}")
    paths, log = msda.build()
    if not log:                      # built by an earlier run: its log
        with open(os.path.join(os.path.dirname(paths[0]), "build.log")) as f:
            log = f.read()
    ptxas = ptxas_summary(log)
    for ln in ptxas:
        print("  ptxas: " + ln)
    import subprocess
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"== {tree}  ({card})", flush=True)
    rows = run(msda)
    dispatch = dispatch_us(msda)
    print("  dispatch us per call: " + ", ".join(
        f"{k} {v:.1f}" for k, v in dispatch.items()), flush=True)
    print(json.dumps({"tree": tree, "card": card, "libraries": list(paths),
                      "ptxas": ptxas, "rows": rows,
                      "dispatch_us": dispatch}), flush=True)


if __name__ == "__main__":
    main()
