"""The hand-written MSDA kernels against their plain versions, on the card:
the forward against `ms_deform_attn`, the backward against
`ms_deform_attn_backward_autograd` (autograd through the plain version),
and the gradient through `ms_deform_attn_auto`. Skips without a CUDA device.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_msda_cuda.py -q

Tolerances, forward: float32 1e-5 (the same products summed in another
order); bfloat16 2**-6, one bf16 rounding apart at |out| < 4. Backward:
each gradient within GRAD_RTOL times the largest magnitude of its plain
counterpart (float32 sums in another order, d_value's scatter in atomic
order); bfloat16 d_value adds one bf16 rounding (2**-8 relative) to that.
The bfloat16 backward is held against the plain backward of value.float()
and grad.float(): the kernel reads the same bf16 numbers and sums in
float32, where the plain bf16 autograd would scatter in bf16.
"""
import numpy as np
import pytest
import torch

from semi_detr_tpu_torch.ops import ms_deform_attn_cuda as cuda_mod
from semi_detr_tpu_torch.ops.ms_deform_attn import (
    ms_deform_attn, ms_deform_attn_backward_autograd)
from semi_detr_tpu_torch.tools.msda_bench import edge_coord

SHAPES = ((12, 16), (6, 8), (3, 4))
S = sum(h * w for h, w in SHAPES)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}
GRAD_RTOL = 1e-5
BF16_ROUNDING = 2 ** -8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, seed, lq, m=4, d=32, p=4, lo=0.0, hi=1.0):
    rng = np.random.RandomState(seed)
    value = torch.from_numpy(rng.randn(2, S, m, d).astype(np.float32))
    loc = torch.from_numpy(rng.uniform(
        lo, hi, (2, lq, m, len(SHAPES), p, 2)).astype(np.float32))
    w = torch.from_numpy(rng.rand(2, lq, m, len(SHAPES) * p).astype(
        np.float32)).softmax(-1).view(2, lq, m, len(SHAPES), p)
    return value.to(dev), loc.to(dev), w.to(dev)


# L = 3 levels; "lp9" has L * P = 9 taps, not a multiple of the taps a
# warp has in flight (4 at float32, 8 at bfloat16 for D = 32); D = 8 and 16
# give row groups of 1, 2 and 4 lanes; D = 5 and 40 take the element
# instance
CASES = {"encoder": dict(lq=S), "decoder": dict(lq=37),
         "odd_d": dict(lq=9, d=5), "wide_d": dict(lq=9, d=40),
         "out_of_bounds": dict(lq=21, lo=-1.5, hi=2.5),
         "lp9": dict(lq=21, p=3), "d8": dict(lq=21, d=8),
         "d16": dict(lq=21, d=16)}
VECTOR = {torch.float32: 4, torch.bfloat16: 8}


def _width(case, dtype):
    """The instance a case must take: 16-byte chunks where D fills a row
    group of 1, 2 or 4 lanes (bf16) or 2, 4 or 8 (float32), else 1."""
    return VECTOR[dtype] if CASES[case].get("d", 32) in (8, 16, 32) else 1


def _launched(wrapper, width, run):
    """run(), asserting it launched the wrapper's kernel once, through the
    instance of the given width."""
    before = wrapper.launches, dict(wrapper.launches_by_width)
    out = run()
    assert wrapper.launches == before[0] + 1
    by_width = dict(wrapper.launches_by_width)
    assert by_width.pop(width) == before[1].pop(width, 0) + 1
    assert by_width == {k: v for k, v in before[1].items() if v}
    return out


def _misaligned(t):
    """A contiguous copy of t whose data starts one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def _mixed_taps(dev, seed):
    """Taps of one warp that differ by row group: tap t % 4 == 0 NaN,
    1 far off the map, 2 exactly on pixel coordinate -1 (x on even points,
    y on odd ones), 3 inside; every row group of a warp holds one kind."""
    value, loc, w = _inputs(dev, seed, lq=13)
    lp = loc.shape[3] * loc.shape[4]
    flat = loc.view(2, 13, loc.shape[2], lp, 2)
    flat[:, :, :, 0::4, 0] = float("nan")
    flat[:, :, :, 1::4, 1] = 1e30
    for t in range(2, lp, 4):
        lvl = t // loc.shape[4]
        h, wd = SHAPES[lvl]
        axis = t // 4 % 2                      # 0: x, 1: y
        flat[:, :, :, t, axis] = edge_coord(wd if axis == 0 else h)
    return value, loc, w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(cuda, case, dtype):
    value, loc, w = _inputs(cuda, 0, **CASES[case])
    value = value.to(dtype)
    got = _launched(cuda_mod.ms_deform_attn_cuda, _width(case, dtype),
                    lambda: cuda_mod.ms_deform_attn_auto(value, SHAPES, loc,
                                                         w))
    ref = ms_deform_attn(value, SHAPES, loc, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == ref.shape
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.cuda
def test_kernel_nonfinite_and_far_locations_add_zero(cuda):
    value, loc, w = _inputs(cuda, 1, lq=11)
    loc[..., 0, 0] = float("nan")
    loc[..., 1, 1] = 1e30
    loc[..., 2, 0] = -1e30
    loc[..., 3, :] = float("inf")
    got = cuda_mod.ms_deform_attn_cuda(value, SHAPES, loc, w)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros_like(got))


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_does_not_take(cuda):
    value, loc, w = _inputs(cuda, 2, lq=5)
    with pytest.raises(TypeError):
        cuda_mod.ms_deform_attn_cuda(value.half(), SHAPES, loc, w)
    with pytest.raises(TypeError):
        cuda_mod.ms_deform_attn_cuda(value, SHAPES, loc.double(), w)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_mod.ms_deform_attn_cuda(value.transpose(2, 3).contiguous()
                                     .transpose(2, 3), SHAPES, loc, w)
    with pytest.raises(ValueError, match="spatial_shapes"):
        cuda_mod.ms_deform_attn_cuda(value, SHAPES[:2], loc[:, :, :, :2],
                                     w[:, :, :, :2].contiguous())


def _grads_close(got, ref, dtype):
    """Each of (d_value, d_loc, d_attn) within its scaled tolerance, where
    the plain result is finite, and exactly 0 where it is not."""
    for i, (a, b) in enumerate(zip(got, ref)):
        fin = torch.isfinite(b)
        assert not a.float()[~fin].any()
        scale = max(1.0, b[fin].abs().max().item())
        tol = GRAD_RTOL * scale
        if i == 0 and dtype == torch.bfloat16:
            tol += BF16_ROUNDING * scale
        err = (a.float() - b.float())[fin].abs().max().item()
        assert err <= tol, (("d_value", "d_loc", "d_attn")[i], err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_kernel_matches_plain_version(cuda, case, dtype):
    value, loc, w = _inputs(cuda, 3, **CASES[case])
    value = value.to(dtype)
    g = torch.randn(value.shape[0], loc.shape[1],
                    value.shape[2] * value.shape[3], device=cuda,
                    generator=torch.Generator(cuda).manual_seed(0)).to(dtype)
    got = _launched(cuda_mod.ms_deform_attn_bwd_cuda, _width(case, dtype),
                    lambda: cuda_mod.ms_deform_attn_bwd_cuda(value, SHAPES,
                                                             loc, w, g))
    ref = ms_deform_attn_backward_autograd(value.float(), SHAPES, loc, w,
                                           g.float())
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype \
        == torch.float32
    assert [t.shape for t in got] == [value.shape, loc.shape, w.shape]
    _grads_close(got, ref, dtype)


@pytest.mark.cuda
def test_backward_nonfinite_and_far_locations_get_zero(cuda):
    value, loc, w = _inputs(cuda, 4, lq=11)
    loc[..., 0, 0] = float("nan")
    loc[..., 1, 1] = 1e30
    loc[..., 2, 0] = -1e30
    loc[..., 3, :] = float("inf")
    g = torch.randn(2, 11, value.shape[2] * value.shape[3], device=cuda)
    d_value, d_loc, d_attn = cuda_mod.ms_deform_attn_bwd_cuda(
        value, SHAPES, loc, w, g)
    torch.cuda.synchronize()
    for t in (d_value, d_loc, d_attn):
        assert torch.equal(t, torch.zeros_like(t))
    # the plain version: NaN in d_loc for the NaN and inf taps, 0 elsewhere
    ref = ms_deform_attn_backward_autograd(value, SHAPES, loc, w, g)
    assert not torch.isfinite(ref[1]).all()
    _grads_close((d_value, d_loc, d_attn), ref, torch.float32)


@pytest.mark.cuda
def test_backward_taps_on_pixel_edges(cuda):
    """Taps exactly on pixel centres and edges, -1 included (the output
    gets 0 there, the gradient the one-sided derivative): the kernel
    follows autograd of the plain version."""
    value, loc, w = _inputs(cuda, 7, lq=40)
    rng = np.random.RandomState(7)
    for lvl, (h, wd) in enumerate(SHAPES):
        px = rng.randint(-1, wd, loc.shape[:3] + (loc.shape[4],))
        py = rng.randint(-1, h, loc.shape[:3] + (loc.shape[4],))
        loc[:, :, :, lvl, :, 0] = torch.from_numpy(
            ((px + 0.5) / wd).astype(np.float32))
        loc[:, :, :, lvl, :, 1] = torch.from_numpy(
            ((py + 0.5) / h).astype(np.float32))
    edge = (loc[..., 0, :, 0] * SHAPES[0][1] - 0.5 == -1)
    assert edge.sum() > 10
    g = torch.randn(2, 40, value.shape[2] * value.shape[3], device=cuda)
    got = cuda_mod.ms_deform_attn_bwd_cuda(value, SHAPES, loc, w, g)
    ref = ms_deform_attn_backward_autograd(value, SHAPES, loc, w, g)
    torch.cuda.synchronize()
    assert ref[1][..., 0, :, 0][edge].abs().max() > 1e-3
    _grads_close(got, ref, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gradient_flows_through_auto(cuda, dtype):
    """The dispatch keeps the kernel's output on the graph: every input
    gets its gradient, from the backward kernel."""
    value, loc, w = _inputs(cuda, 5, lq=37)
    value = value.to(dtype).requires_grad_(True)
    loc.requires_grad_(True)
    w.requires_grad_(True)
    proj = torch.randn(2, 37, value.shape[2] * value.shape[3], device=cuda)
    fwd = cuda_mod.ms_deform_attn_cuda.launches
    bwd = cuda_mod.ms_deform_attn_bwd_cuda.launches
    out = cuda_mod.ms_deform_attn_auto(value, SHAPES, loc, w)
    assert out.grad_fn is not None
    (out.float() * proj).sum().backward()
    assert cuda_mod.ms_deform_attn_cuda.launches == fwd + 1
    assert cuda_mod.ms_deform_attn_bwd_cuda.launches == bwd + 1
    got = (value.grad, loc.grad, w.grad)
    assert all(t is not None for t in got)
    ref = ms_deform_attn_backward_autograd(value.detach().float(), SHAPES,
                                           loc.detach(), w.detach(),
                                           proj.to(dtype).float())
    torch.cuda.synchronize()
    _grads_close(got, ref, dtype)


@pytest.mark.cuda
def test_auto_under_no_grad_launches_forward_only(cuda):
    value, loc, w = _inputs(cuda, 6, lq=9)
    bwd = cuda_mod.ms_deform_attn_bwd_cuda.launches
    with torch.no_grad():
        got = cuda_mod.ms_deform_attn_auto(value, SHAPES, loc, w)
    ref = ms_deform_attn(value, SHAPES, loc, w)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= TOL[torch.float32]
    assert cuda_mod.ms_deform_attn_bwd_cuda.launches == bwd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_misaligned_inputs_take_the_element_instance(cuda, dtype):
    """value (and g) starting off a 16-byte boundary: the wrappers take the
    element instance, and both kernels still match their plain versions."""
    value, loc, w = _inputs(cuda, 8, lq=37)
    value = _misaligned(value.to(dtype))
    got = _launched(cuda_mod.ms_deform_attn_cuda, 1,
                    lambda: cuda_mod.ms_deform_attn_cuda(value, SHAPES, loc,
                                                         w))
    ref = ms_deform_attn(value, SHAPES, loc, w)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]
    g = torch.randn(2, 37, value.shape[2] * value.shape[3], device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1)).to(dtype)
    for v_in, g_in in ((value, g),
                       (value.contiguous().clone(), _misaligned(g))):
        got = _launched(cuda_mod.ms_deform_attn_bwd_cuda, 1,
                        lambda: cuda_mod.ms_deform_attn_bwd_cuda(
                            v_in, SHAPES, loc, w, g_in))
        ref = ms_deform_attn_backward_autograd(v_in.float(), SHAPES, loc,
                                               w, g_in.float())
        torch.cuda.synchronize()
        _grads_close(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_taps_that_differ_between_row_groups(cuda, dtype):
    """One warp's row groups hold NaN, far, exactly-on-edge and inside taps
    side by side: each group's result is its own, forward and backward."""
    value, loc, w = _mixed_taps(cuda, 9)
    value = value.to(dtype)
    got = _launched(cuda_mod.ms_deform_attn_cuda, VECTOR[dtype],
                    lambda: cuda_mod.ms_deform_attn_cuda(value, SHAPES, loc,
                                                         w))
    ref = ms_deform_attn(value, SHAPES, loc, w)
    torch.cuda.synchronize()
    assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]
    g = torch.randn(2, 13, value.shape[2] * value.shape[3], device=cuda,
                    generator=torch.Generator(cuda).manual_seed(2)).to(dtype)
    got = _launched(cuda_mod.ms_deform_attn_bwd_cuda, VECTOR[dtype],
                    lambda: cuda_mod.ms_deform_attn_bwd_cuda(value, SHAPES,
                                                             loc, w, g))
    ref = ms_deform_attn_backward_autograd(value.float(), SHAPES, loc, w,
                                           g.float())
    torch.cuda.synchronize()
    # the edge taps have a one-sided derivative, the NaN taps none
    lp = loc.shape[3] * loc.shape[4]
    d_loc = ref[1].view(2, 13, loc.shape[2], lp, 2)
    assert d_loc[:, :, :, 2::4].abs().max() > 1e-3
    assert not torch.isfinite(d_loc[:, :, :, 0::4]).all()
    _grads_close(got, ref, dtype)
