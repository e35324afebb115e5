"""The port's MSDA backward (`ms_deform_attn_backward`, autograd through
the plain version) against the JAX oracle vjp and the interpret-mode
Pallas backward kernel, and the port's differentiable dispatch on the CPU.

Tolerances are the JAX package's own for its backward kernel
(tests/test_ms_deform_attn_pallas.py:47-63): d_value and d_attn rtol 1e-4
atol 1e-5, d_loc rtol 1e-4 atol 1e-4 (float32 sums in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_detr_tpu.ops.ms_deform_attn import ms_deform_attn as jax_msda
from semi_detr_tpu.ops.ms_deform_attn_pallas import ms_deform_attn_bwd_pallas
from semi_detr_tpu_torch.ops import ms_deform_attn_cuda as cuda_mod
from semi_detr_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                    ms_deform_attn_backward)

SHAPES = ((12, 16), (6, 8))        # as tests/test_ms_deform_attn_pallas.py
S = sum(h * w for h, w in SHAPES)
TOL = {"d_value": dict(rtol=1e-4, atol=1e-5),
       "d_loc": dict(rtol=1e-4, atol=1e-4),
       "d_attn": dict(rtol=1e-4, atol=1e-5)}
NAMES = ("d_value", "d_loc", "d_attn")


def _inputs(seed, n=1, m=2, d=8, lq=16, p=3, lo=0.0, hi=1.0):
    rs = np.random.RandomState(seed)
    v = rs.randn(n, S, m, d).astype(np.float32)
    loc = rs.uniform(lo, hi, (n, lq, m, len(SHAPES), p, 2)).astype(
        np.float32)
    aw = rs.randn(n, lq, m, len(SHAPES) * p).astype(np.float32)
    aw = np.exp(aw) / np.exp(aw).sum(-1, keepdims=True)
    g = rs.randn(n, lq, m * d).astype(np.float32)
    return v, loc, aw.reshape(n, lq, m, len(SHAPES), p), g


def _port(v, loc, aw, g):
    return [t.numpy() for t in ms_deform_attn_backward(
        *(torch.from_numpy(a) for a in (v,)), SHAPES,
        torch.from_numpy(loc), torch.from_numpy(aw), torch.from_numpy(g))]


def _oracle(v, loc, aw, g):
    _, vjp = jax.vjp(lambda vv, ll, aa: jax_msda(vv, SHAPES, ll, aa),
                     jnp.asarray(v), jnp.asarray(loc), jnp.asarray(aw))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _assert_close(got, ref):
    for name, a, b in zip(NAMES, got, ref):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL[name])


CASES = {
    "encoder": dict(lq=S),          # one query per token
    "decoder": dict(lq=16),
    "odd_d": dict(lq=9, d=5),
    "out_of_bounds": dict(lq=12, lo=-1.5, hi=2.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_jax_oracle_vjp(case):
    args = _inputs(1, **CASES[case])
    _assert_close(_port(*args), _oracle(*args))


@pytest.mark.parametrize("d", [8, 32])
def test_backward_matches_pallas_interpret(d):
    v, loc, aw, g = _inputs(3, d=d)
    ref = ms_deform_attn_bwd_pallas(jnp.asarray(v), SHAPES,
                                    jnp.asarray(loc), jnp.asarray(aw),
                                    jnp.asarray(g), interpret=True)
    _assert_close(_port(v, loc, aw, g), [np.asarray(t) for t in ref])


def test_zero_attention_tap_gradient():
    """A valid tap with attention exactly 0 still gets its d_attn (as in
    tests/test_ms_deform_attn_pallas.py:127-148)."""
    v, loc, aw, g = _inputs(11)
    loc = loc * 0.2                          # all taps cluster top-left
    loc[0, 3, 1, 1, 2] = [0.95, 0.95]        # one zero-weight tap far away
    aw[0, 3, 1, 1, 2] = 0.0
    got = _port(v, loc, aw, g)
    ref = _oracle(v, loc, aw, g)
    pallas = ms_deform_attn_bwd_pallas(jnp.asarray(v), SHAPES,
                                       jnp.asarray(loc), jnp.asarray(aw),
                                       jnp.asarray(g), interpret=True)
    tap = got[2][0, 3, 1, 1, 2]
    assert abs(tap) > 1e-6, "test setup: the tap's gradient is nonzero"
    np.testing.assert_allclose(tap, ref[2][0, 3, 1, 1, 2], rtol=1e-4)
    np.testing.assert_allclose(tap, np.asarray(pallas[2])[0, 3, 1, 1, 2],
                               rtol=1e-4)
    # its d_loc is 0: the attention weight scales the location gradient
    np.testing.assert_array_equal(got[1][0, 3, 1, 1, 2], 0.0)


def test_out_of_bounds_taps_get_zero():
    """Taps whose four corners all lie off the map add nothing and get
    exactly 0 in d_loc and d_attn; d_value gets nothing from them."""
    v, loc, aw, g = _inputs(5)
    loc[..., 0, 0] = 1.5                     # x past the right edge
    loc[..., 1, 1] = -0.7                    # y above the top edge
    got = _port(v, loc, aw, g)
    for i in (1, 2):
        np.testing.assert_array_equal(got[i][:, :, :, :, :2], 0.0)
    _assert_close(got, _oracle(v, loc, aw, g))
    # only the third point reaches the maps: d_value is its scatter alone
    loc_in = loc[..., 2:, :].copy()
    alone = _port(v, np.ascontiguousarray(loc_in),
                  np.ascontiguousarray(aw[..., 2:]), g)
    np.testing.assert_allclose(got[0], alone[0], rtol=1e-6, atol=1e-7)


def test_taps_exactly_on_the_lower_edge():
    """A tap at pixel coordinate exactly -1 adds 0 to the output but has
    the one-sided derivative toward its in-map corner at 0: the JAX oracle
    and the Pallas kernel give it, and so does the port (the CUDA kernel
    is held to this on the card)."""
    v, loc, aw, g = _inputs(12)
    loc[0, :4, :, 0, 0, 0] = -0.5 / 16       # px = -1 exactly (W = 16)
    loc[0, 4:8, :, 1, 1, 1] = -0.5 / 6       # py = -1 exactly (H = 6)
    assert (loc[0, :4, :, 0, 0, 0] * 16 - 0.5 == -1).all()
    assert (loc[0, 4:8, :, 1, 1, 1] * np.float32(6) - np.float32(0.5)
            == -1).all()
    got = _port(v, loc, aw, g)
    assert np.abs(got[1][0, :4, :, 0, 0, 0]).min() > 1e-3
    assert np.abs(got[1][0, 4:8, :, 1, 1, 1]).min() > 1e-3
    _assert_close(got, _oracle(v, loc, aw, g))
    pallas = ms_deform_attn_bwd_pallas(jnp.asarray(v), SHAPES,
                                       jnp.asarray(loc), jnp.asarray(aw),
                                       jnp.asarray(g), interpret=True)
    _assert_close(got, [np.asarray(t) for t in pallas])


def test_finite_differences():
    """Central differences of sum(out * g) at a few coordinates of value,
    attention weights and locations (away from pixel edges, where the
    bilinear sample is smooth)."""
    v, loc, aw, g = _inputs(2, lq=8)
    d_value, d_loc, d_attn = _port(v, loc, aw, g)

    def f(vv, ll, aa):
        out = ms_deform_attn(torch.from_numpy(vv), SHAPES,
                             torch.from_numpy(ll), torch.from_numpy(aa))
        return float((out.double() * torch.from_numpy(g).double()).sum())

    rs = np.random.RandomState(7)
    eps = 1e-3
    checked = 0
    for which, arr, grad in (("value", v, d_value), ("attn", aw, d_attn),
                             ("loc", loc, d_loc)):
        for _ in range(40):
            i = tuple(rs.randint(s) for s in arr.shape)
            if which == "loc":
                lvl = i[3]
                extent = SHAPES[lvl][1 - i[5]]    # W for x, H for y
                px = arr[i] * extent - 0.5
                if abs(px - np.round(px)) < 0.1:  # near a pixel edge
                    continue
            plus, minus = arr.copy(), arr.copy()
            plus[i] += eps
            minus[i] -= eps
            args_p = {"value": (plus, loc, aw), "attn": (v, loc, plus),
                      "loc": (v, plus, aw)}[which]
            args_m = {"value": (minus, loc, aw), "attn": (v, loc, minus),
                      "loc": (v, minus, aw)}[which]
            fd = (f(*args_p) - f(*args_m)) / (2 * eps)
            np.testing.assert_allclose(grad[i], fd, rtol=2e-2, atol=2e-2,
                                       err_msg=f"{which}{i}")
            checked += 1
            if checked % 3 == 0:
                break
    assert checked == 9


def test_cpu_dispatch_is_differentiable():
    """On the CPU, `ms_deform_attn_auto` runs the plain version, and its
    output carries the graph to all three inputs."""
    v, loc, aw, g = (torch.from_numpy(a) for a in _inputs(4))
    ins = [t.clone().requires_grad_(True) for t in (v, loc, aw)]
    fwd = cuda_mod.ms_deform_attn_cuda.launches
    bwd = cuda_mod.ms_deform_attn_bwd_cuda.launches
    out = cuda_mod.ms_deform_attn_auto(ins[0], SHAPES, ins[1], ins[2])
    (out * g).sum().backward()
    ref = ms_deform_attn_backward(v, SHAPES, loc, aw, g)
    for t, r in zip(ins, ref):
        assert t.grad is not None
        torch.testing.assert_close(t.grad, r, rtol=0, atol=0)
    assert (cuda_mod.ms_deform_attn_cuda.launches,
            cuda_mod.ms_deform_attn_bwd_cuda.launches) == (fwd, bwd)


def test_kernel_paths_reject_cpu_tensors():
    v, loc, aw, g = (torch.from_numpy(a) for a in _inputs(6))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_mod.MSDeformAttnFunction.apply(v, SHAPES, loc, aw)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_mod.ms_deform_attn_bwd_cuda(v, SHAPES, loc, aw, g)
