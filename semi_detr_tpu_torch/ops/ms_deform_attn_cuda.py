"""MSDA on the card: build, bind and dispatch, forward and backward.

Counterpart of `semi_detr_tpu/ops/ms_deform_attn_pallas.py`. The kernels
are `csrc/ms_deform_attn_fwd.cu` and `csrc/ms_deform_attn_bwd.cu` (with `csrc/ms_deform_attn_common.cuh`),
compiled at first use by `nvcc` for sm_90a, each into a shared library
with a plain C interface, kept under `_build/<hash of the sources>/`
inside the package, and bound with ctypes.

Each kernel comes in instances by channels per lane (`kernel_width`): the
vector instances move 16 bytes of the value dtype per lane and load (8
bf16 or 4 float32 channels), the element instance one channel, for any D
and any alignment. Each wrapper counts its launches in `.launches` and, by
the width taken, in `.launches_by_width`.

Two registered operators take the place of the JAX `custom_vjp` pair
(`ms_deform_attn_fused` / `ms_deform_attn_fused_tiled`):
`semi_detr::ms_deform_attn` (the forward kernel on the card, the plain
version on the CPU) and `semi_detr::ms_deform_attn_bwd` (the backward
kernel on the card; autograd through the plain forward on the CPU), joined
by the forward's autograd formula, with fake implementations for tracing.
Being operators, they survive `torch.export` (importing this module
registers them, so a saved program needs it imported to load) and are
what the selective activation checkpoint keeps (`models/transformer.py`).
`ms_deform_attn_auto` takes the place of the JAX package's dispatch: CUDA
and CPU tensors go through the op, anything else raises. There is no
fallback: a kernel that does not build or launch raises.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, List, Tuple

import numpy as np
import torch

from .ms_deform_attn import (level_start_index, ms_deform_attn,
                             ms_deform_attn_backward)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("ms_deform_attn_fwd.cu", "ms_deform_attn_bwd.cu")
HEADERS = ("ms_deform_attn_common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the MSDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def library_paths() -> Tuple[str, ...]:
    """Paths of the built libraries, one per source, in a directory keyed
    by a hash of the sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    out_dir = os.path.join(_PKG, "_build", h.hexdigest()[:16])
    return tuple(os.path.join(out_dir, name[:-3] + ".so")
                 for name in SOURCES)


def build() -> Tuple[Tuple[str, ...], str]:
    """Compile each kernel source into its own library if missing, one
    nvcc per source, all started together.

    Returns (library paths, nvcc's log; empty when the libraries existed).
    Each library is written under a temporary name and renamed into place,
    so concurrent builders never load a half-written file."""
    outs = library_paths()
    todo = [(src, out) for src, out in zip(SOURCES, outs)
            if not os.path.exists(out)]
    if not todo:
        return outs, ""
    os.makedirs(os.path.dirname(outs[0]), exist_ok=True)
    nvcc, procs = _nvcc(), []
    for src, out in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
        os.close(fd)
        procs.append((src, out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = "", []
    for src, out, tmp, proc in procs:
        log += f"== {src}\n{proc.communicate()[0]}"
        if proc.returncode != 0:
            failed.append(src)
            os.unlink(tmp)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    with open(os.path.join(os.path.dirname(outs[0]), "build.log"), "w") as f:
        f.write(log)
    return outs, log


@functools.lru_cache(maxsize=None)
def _library() -> dict:
    """The kernels' entry points by name."""
    fwd, bwd = (ctypes.CDLL(path) for path in build()[0])
    fns = {}
    for name in _KERNELS.values():
        fn = fns[name] = getattr(fwd, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for name in _BWD_KERNELS.values():
        fn = fns[name] = getattr(bwd, name)
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


_META_CACHE: Dict[Tuple, torch.Tensor] = {}
_KERNELS = {torch.float32: "msda_fwd_f32", torch.bfloat16: "msda_fwd_bf16"}
_BWD_KERNELS = {torch.float32: "msda_bwd_f32",
                torch.bfloat16: "msda_bwd_bf16"}


def _meta(spatial_shapes, device) -> torch.Tensor:
    """int32 (L, 3) = (H, W, level start) on the device, cached."""
    key = (tuple(spatial_shapes), str(device))
    t = _META_CACHE.get(key)
    if t is None:
        starts = level_start_index(spatial_shapes)
        arr = np.asarray([(h, w, s) for (h, w), s in
                          zip(spatial_shapes, starts)], np.int32)
        t = _META_CACHE[key] = torch.from_numpy(arr).to(device)
    return t


def kernel_width(d: int, dtype: torch.dtype, *data_ptrs: int) -> int:
    """Channels per lane of the kernel instance for head width d.

    A vector instance (16 bytes of dtype per lane: 8 bfloat16 or 4
    float32 channels) needs d to fill whole 16-byte chunks, d / width lanes
    per row to divide the warp's 32, and every pointer 16-byte aligned;
    anything else takes the element instance (1).
    """
    width = 128 // torch.finfo(dtype).bits
    lanes = d // width
    if (d % width == 0 and lanes in (1, 2, 4, 8, 16, 32)
            and all(p % 16 == 0 for p in data_ptrs)):
        return width
    return 1


def _count(wrapper, width: int):
    wrapper.launches += 1
    wrapper.launches_by_width[width] += 1


def _check_inputs(value, spatial_shapes, sampling_locations,
                  attention_weights):
    """Validate what the kernels take; returns (N, S, M, D, Lq, L, P)."""
    if value.dim() != 4 or sampling_locations.dim() != 6 \
            or attention_weights.dim() != 5:
        raise ValueError("expected value (N,S,M,D), loc (N,Lq,M,L,P,2), "
                         "attn (N,Lq,M,L,P)")
    N, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if tuple(sampling_locations.shape) != (N, Lq, M, L, P, 2) \
            or tuple(attention_weights.shape) != (N, Lq, M, L, P):
        raise ValueError(f"shape mismatch: value {tuple(value.shape)}, loc "
                         f"{tuple(sampling_locations.shape)}, attn "
                         f"{tuple(attention_weights.shape)}")
    if L != len(spatial_shapes) or sum(h * w for h, w in spatial_shapes) != S:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not match "
                         f"L={L}, S={S}")
    if value.dtype not in _KERNELS:
        raise TypeError(f"value dtype {value.dtype} not supported")
    if sampling_locations.dtype != torch.float32 \
            or attention_weights.dtype != torch.float32:
        raise TypeError("sampling_locations and attention_weights must be "
                        "float32")
    tensors = (value, sampling_locations, attention_weights)
    if not all(t.is_cuda and t.device == value.device for t in tensors):
        raise ValueError("all inputs must lie on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    return N, S, M, D, Lq, L, P


def ms_deform_attn_cuda(value: torch.Tensor,
                        spatial_shapes: Tuple[Tuple[int, int], ...],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """Launch the hand-written MSDA forward kernel.

    value (N, S, M, D) float32 or bfloat16; sampling_locations
    (N, Lq, M, L, P, 2) float32; attention_weights (N, Lq, M, L, P)
    float32; all contiguous and on one CUDA device. Returns (N, Lq, M*D)
    in value's dtype. Counts each launch in `ms_deform_attn_cuda.launches`
    and, by the instance's width (`kernel_width`), in
    `ms_deform_attn_cuda.launches_by_width`.
    """
    N, S, M, D, Lq, L, P = _check_inputs(value, spatial_shapes,
                                          sampling_locations,
                                          attention_weights)
    out = torch.empty((N, Lq, M * D), dtype=value.dtype, device=value.device)
    width = kernel_width(D, value.dtype, value.data_ptr(), out.data_ptr())
    meta = _meta(spatial_shapes, value.device)
    fn = _library()[_KERNELS[value.dtype]]
    stream = torch.cuda.current_stream(value.device).cuda_stream
    err = fn(value.data_ptr(), meta.data_ptr(),
             sampling_locations.data_ptr(), attention_weights.data_ptr(),
             out.data_ptr(), N, S, M, D, Lq, L, P, width, stream)
    if err != 0:
        raise RuntimeError(f"MSDA forward kernel launch failed: CUDA error "
                           f"{err}")
    _count(ms_deform_attn_cuda, width)
    return out


ms_deform_attn_cuda.launches = 0
ms_deform_attn_cuda.launches_by_width = collections.Counter()


def ms_deform_attn_bwd_cuda(value: torch.Tensor,
                            spatial_shapes: Tuple[Tuple[int, int], ...],
                            sampling_locations: torch.Tensor,
                            attention_weights: torch.Tensor,
                            grad_out: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Launch the hand-written MSDA backward kernel.

    Inputs as for `ms_deform_attn_cuda`, plus grad_out (N, Lq, M*D) in
    value's dtype, contiguous. Returns (d_value in value's dtype, d_loc
    float32, d_attn float32). d_value is summed in float32 (for bfloat16 in
    a float32 scratch buffer, then cast). Counts each launch in
    `ms_deform_attn_bwd_cuda.launches` and, by the instance's width, in
    `ms_deform_attn_bwd_cuda.launches_by_width`.
    """
    N, S, M, D, Lq, L, P = _check_inputs(value, spatial_shapes,
                                          sampling_locations,
                                          attention_weights)
    if tuple(grad_out.shape) != (N, Lq, M * D) \
            or grad_out.dtype != value.dtype:
        raise ValueError(f"grad_out must be {(N, Lq, M * D)} in "
                         f"{value.dtype}, got {tuple(grad_out.shape)} in "
                         f"{grad_out.dtype}")
    if grad_out.device != value.device or not grad_out.is_contiguous():
        raise ValueError("grad_out must be contiguous on value's device")
    dev = value.device
    d_value = torch.empty_like(value)
    dv_acc = (d_value if value.dtype == torch.float32
              else torch.empty(value.shape, dtype=torch.float32, device=dev))
    d_loc = torch.empty_like(sampling_locations)
    d_attn = torch.empty_like(attention_weights)
    width = kernel_width(D, value.dtype, value.data_ptr(),
                         grad_out.data_ptr(), dv_acc.data_ptr())
    meta = _meta(spatial_shapes, dev)
    fn = _library()[_BWD_KERNELS[value.dtype]]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(value.data_ptr(), meta.data_ptr(),
             sampling_locations.data_ptr(), attention_weights.data_ptr(),
             grad_out.data_ptr(), dv_acc.data_ptr(), d_value.data_ptr(),
             d_loc.data_ptr(), d_attn.data_ptr(), N, S, M, D, Lq, L, P,
             width, stream)
    if err != 0:
        raise RuntimeError(f"MSDA backward kernel launch failed: CUDA error "
                           f"{err}")
    _count(ms_deform_attn_bwd_cuda, width)
    return d_value, d_loc, d_attn


ms_deform_attn_bwd_cuda.launches = 0
ms_deform_attn_bwd_cuda.launches_by_width = collections.Counter()


def _pairs(spatial_shapes: List[int]) -> Tuple[Tuple[int, int], ...]:
    """The ops' flat [H0, W0, H1, W1, ...] as ((H0, W0), (H1, W1), ...)."""
    return tuple(zip(spatial_shapes[0::2], spatial_shapes[1::2]))


def flat_shapes(spatial_shapes) -> List[int]:
    """((H0, W0), ...) as the ops' flat [H0, W0, ...]."""
    return [int(v) for hw in spatial_shapes for v in hw]


@torch.library.custom_op("semi_detr::ms_deform_attn", mutates_args=(),
                         device_types="cpu")
def ms_deform_attn_op(value: torch.Tensor, spatial_shapes: List[int],
                      sampling_locations: torch.Tensor,
                      attention_weights: torch.Tensor) -> torch.Tensor:
    """MSDA as a registered operator; spatial_shapes flat (`flat_shapes`).
    On the CPU the plain version, on the card the forward kernel
    (`ms_deform_attn_fwd_cuda_impl`)."""
    return ms_deform_attn(value, _pairs(spatial_shapes), sampling_locations,
                          attention_weights)


def ms_deform_attn_fwd_cuda_impl(value, spatial_shapes, sampling_locations,
                                 attention_weights):
    """`semi_detr::ms_deform_attn` on a CUDA device: the forward kernel."""
    return ms_deform_attn_cuda(value, _pairs(spatial_shapes),
                               sampling_locations, attention_weights)


ms_deform_attn_op.register_kernel("cuda", ms_deform_attn_fwd_cuda_impl)


@ms_deform_attn_op.register_fake
def _(value, spatial_shapes, sampling_locations, attention_weights):
    n, _, m, d = value.shape
    return value.new_empty((n, sampling_locations.shape[1], m * d))


@torch.library.custom_op("semi_detr::ms_deform_attn_bwd", mutates_args=(),
                         device_types="cpu")
def ms_deform_attn_bwd_op(value: torch.Tensor, spatial_shapes: List[int],
                          sampling_locations: torch.Tensor,
                          attention_weights: torch.Tensor,
                          grad_out: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """(d_value, d_loc, d_attn) of `semi_detr::ms_deform_attn` for
    grad_out. On the CPU by autograd through the plain forward, on the
    card the backward kernel (`ms_deform_attn_bwd_cuda_impl`)."""
    return ms_deform_attn_backward(value, _pairs(spatial_shapes),
                                   sampling_locations, attention_weights,
                                   grad_out)


def ms_deform_attn_bwd_cuda_impl(value, spatial_shapes, sampling_locations,
                                 attention_weights, grad_out):
    """`semi_detr::ms_deform_attn_bwd` on a CUDA device: the backward
    kernel."""
    return ms_deform_attn_bwd_cuda(value, _pairs(spatial_shapes),
                                   sampling_locations, attention_weights,
                                   grad_out.contiguous())


ms_deform_attn_bwd_op.register_kernel("cuda", ms_deform_attn_bwd_cuda_impl)


@ms_deform_attn_bwd_op.register_fake
def _(value, spatial_shapes, sampling_locations, attention_weights,
      grad_out):
    return (torch.empty_like(value), torch.empty_like(sampling_locations),
            torch.empty_like(attention_weights))


def _setup_context(ctx, inputs, output):
    value, spatial_shapes, sampling_locations, attention_weights = inputs
    ctx.spatial_shapes = spatial_shapes
    ctx.save_for_backward(value, sampling_locations, attention_weights)


def _backward(ctx, grad_out):
    value, loc, attn = ctx.saved_tensors
    d_value, d_loc, d_attn = ms_deform_attn_bwd_op(
        value, ctx.spatial_shapes, loc, attn, grad_out)
    need = ctx.needs_input_grad
    return (d_value if need[0] else None, None,
            d_loc if need[2] else None, d_attn if need[3] else None)


ms_deform_attn_op.register_autograd(_backward, setup_context=_setup_context)


def ms_deform_attn_auto(value, spatial_shapes, sampling_locations,
                        attention_weights) -> torch.Tensor:
    """Device dispatch through `semi_detr::ms_deform_attn`: CUDA tensors
    launch the kernels, CPU tensors take the plain version (both
    differentiable through the op's backward); any other device raises."""
    if value.is_cuda or value.device.type == "cpu":
        return ms_deform_attn_op(value, flat_shapes(spatial_shapes),
                                 sampling_locations, attention_weights)
    raise RuntimeError(f"MSDA has no implementation for device "
                       f"{value.device}")
