"""The MSDA wrappers' choice of kernel instance, on the CPU.

`kernel_width` picks the channels per lane: 16 bytes of the value dtype
(8 bf16 or 4 float32 channels) where D fills whole 16-byte chunks, D /
width lanes per row divide the warp's 32, and every pointer is 16-byte
aligned; 1 (the element instance) otherwise. The kernels themselves run
only on the card (tests/test_torch_msda_cuda.py); this choice is plain
Python and is held here exactly.
"""
import shutil

import pytest
import torch

from semi_detr_tpu_torch.ops import ms_deform_attn_cuda as cuda_mod
from semi_detr_tpu_torch.ops.ms_deform_attn_cuda import kernel_width
from semi_detr_tpu_torch.tools import msda_bench

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("d,dtype,ptrs,width", [
    (32, BF16, (0, 256), 8),        # the main path: 4 lanes per row
    (32, F32, (0, 256), 4),         # 8 lanes per row
    (8, BF16, (16,), 8),            # 1 lane per row
    (16, BF16, (16,), 8),           # 2 lanes per row
    (8, F32, (16,), 4),             # 2 lanes per row
    (16, F32, (16,), 4),            # 4 lanes per row
    (256, BF16, (0,), 8),           # 32 lanes per row
    (128, F32, (0,), 4),            # 32 lanes per row
    (512, BF16, (0,), 1),           # 64 lanes: wider than a warp
    (40, BF16, (0,), 1),            # 5 lanes do not divide 32
    (40, F32, (0,), 1),             # 10 lanes do not divide 32
    (12, F32, (0,), 1),             # 3 lanes do not divide 32
    (5, F32, (0,), 1),              # no whole 16-byte chunk
    (4, BF16, (0,), 1),             # half a chunk
    (0, F32, (), 1),
    (32, BF16, (0, 2), 1),          # a view one bf16 past a boundary
    (32, F32, (4, 0), 1),           # a view one float past a boundary
    (32, F32, (0, 8), 1),           # 8-byte aligned only
    (32, BF16, (), 8),
], ids=lambda v: str(v).replace("torch.", ""))
def test_kernel_width(d, dtype, ptrs, width):
    assert kernel_width(d, dtype, *ptrs) == width


def test_counters_by_width_start_empty_and_cpu_takes_the_plain_version():
    for wrapper in (cuda_mod.ms_deform_attn_cuda,
                    cuda_mod.ms_deform_attn_bwd_cuda):
        assert isinstance(wrapper.launches_by_width, dict)
    before = (cuda_mod.ms_deform_attn_cuda.launches,
              dict(cuda_mod.ms_deform_attn_cuda.launches_by_width))
    value = torch.randn(1, 5, 2, 8)
    loc = torch.rand(1, 3, 2, 1, 2, 2)
    attn = torch.rand(1, 3, 2, 1, 2)
    out = cuda_mod.ms_deform_attn_auto(value, ((1, 5),), loc, attn)
    assert out.shape == (1, 3, 16)
    assert (cuda_mod.ms_deform_attn_cuda.launches,
            dict(cuda_mod.ms_deform_attn_cuda.launches_by_width)) == before


def test_build_key_covers_the_shared_header(tmp_path, monkeypatch):
    """A change to the header both kernels include gives new libraries."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_mod.CSRC, csrc)
    monkeypatch.setattr(cuda_mod, "CSRC", str(csrc))
    before = cuda_mod.library_paths()
    with open(csrc / cuda_mod.HEADERS[0], "a") as f:
        f.write("\n// changed\n")
    after = cuda_mod.library_paths()
    assert len(before) == len(cuda_mod.SOURCES) == 2
    assert all(a != b for a, b in zip(before, after))


def test_ptxas_summary_names_each_instance():
    log = (
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_115msda_fwd"
        "_kernelI13__nv_bfloat16Li8ELi4EEEvPKT_PKiPKfSA_PS2_liiiiii\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 56 registers, used 0 barriers\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_112cast_to_"
        "bf16EPKfP13__nv_bfloat16l\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 13 registers, used 0 barriers\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_115msda_bwd"
        "_kernelIfEEvPKT_PKiPKfS7_S4_PfS8_S8_liiiiii\n"
        "    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 70 registers, used 0 barriers\n")
    assert msda_bench.ptxas_summary(log) == [
        "msda_fwd_kernel<bf16, 8, 4>: 56 registers, 0/0 bytes spilled "
        "(stores/loads)",
        "cast_to_bf16: 13 registers, 0/0 bytes spilled (stores/loads)",
        "msda_bwd_kernel<float>: 70 registers, 4/8 bytes spilled "
        "(stores/loads)"]
