"""MSDA as registered operators: `semi_detr::ms_deform_attn` and
`semi_detr::ms_deform_attn_bwd`, on the CPU.

`torch.library.opcheck` runs the operator checks (schema, autograd
registration, fake implementation against the real one, the AOT-dispatch
trace) on both ops. The op's forward and its gradient are held to the JAX
oracle (`semi_detr_tpu/ops/ms_deform_attn.py` and its vjp) at the
tolerances of tests/test_torch_msda.py and tests/test_torch_msda_grad.py
(float32 sums in other orders), and to the plain version to the bit (the
CPU implementation is the plain version). Inputs come from numpy seeds.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_detr_tpu.ops.ms_deform_attn import ms_deform_attn as jax_msda
from semi_detr_tpu_torch.ops import ms_deform_attn_cuda as cuda_mod
from semi_detr_tpu_torch.ops.ms_deform_attn import (
    ms_deform_attn, ms_deform_attn_backward, ms_deform_attn_backward_autograd)

SHAPES = ((6, 4), (3, 2))
S = sum(h * w for h, w in SHAPES)
FLAT = cuda_mod.flat_shapes(SHAPES)
FWD_ATOL = 1e-5
GRAD_TOL = {"d_value": dict(rtol=1e-4, atol=1e-5),
            "d_loc": dict(rtol=1e-4, atol=1e-4),
            "d_attn": dict(rtol=1e-4, atol=1e-5)}


def _inputs(seed, n=2, lq=5, m=2, d=8, p=3, lo=-0.2, hi=1.2):
    rng = np.random.RandomState(seed)
    value = rng.randn(n, S, m, d).astype(np.float32)
    loc = rng.uniform(lo, hi, (n, lq, m, len(SHAPES), p, 2)).astype(
        np.float32)
    w = rng.uniform(0, 1, (n, lq, m, len(SHAPES) * p)).astype(np.float32)
    w = (w / w.sum(-1, keepdims=True)).reshape(n, lq, m, len(SHAPES), p)
    g = rng.randn(n, lq, m * d).astype(np.float32)
    return value, loc, w, g


CASES = {"encoder": dict(lq=S), "decoder": dict(lq=5),
         "out_of_bounds": dict(lq=7, lo=-1.5, hi=2.5),
         "odd_d": dict(lq=6, d=5)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_opcheck_forward(case):
    v, loc, w, _ = (torch.from_numpy(a) for a in _inputs(0, **CASES[case]))
    torch.library.opcheck(torch.ops.semi_detr.ms_deform_attn.default,
                          (v.requires_grad_(True), FLAT, loc, w))


@pytest.mark.parametrize("case", sorted(CASES))
def test_opcheck_backward(case):
    v, loc, w, g = (torch.from_numpy(a) for a in _inputs(1, **CASES[case]))
    torch.library.opcheck(torch.ops.semi_detr.ms_deform_attn_bwd.default,
                          (v, FLAT, loc, w, g))


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_plain_version_and_jax_oracle(case):
    value, loc, w, _ = _inputs(2, **CASES[case])
    got = cuda_mod.ms_deform_attn_op(torch.from_numpy(value), FLAT,
                                     torch.from_numpy(loc),
                                     torch.from_numpy(w)).numpy()
    plain = ms_deform_attn(torch.from_numpy(value), SHAPES,
                           torch.from_numpy(loc), torch.from_numpy(w))
    np.testing.assert_array_equal(got, plain.numpy())
    ref = np.asarray(jax_msda(jnp.asarray(value), SHAPES, jnp.asarray(loc),
                              jnp.asarray(w)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=FWD_ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_gradient_matches_jax_oracle_vjp(case):
    value, loc, w, g = _inputs(3, **CASES[case])
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (value, loc, w)]
    out = cuda_mod.ms_deform_attn_auto(ins[0], SHAPES, ins[1], ins[2])
    assert out.grad_fn is not None
    (out * torch.from_numpy(g)).sum().backward()
    _, vjp = jax.vjp(lambda vv, ll, aa: jax_msda(vv, SHAPES, ll, aa),
                     jnp.asarray(value), jnp.asarray(loc), jnp.asarray(w))
    ref = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    plain = ms_deform_attn_backward(*(torch.from_numpy(a) for a in (value,)),
                                    SHAPES, torch.from_numpy(loc),
                                    torch.from_numpy(w), torch.from_numpy(g))
    for name, t, r, p in zip(GRAD_TOL, ins, ref, plain):
        np.testing.assert_array_equal(t.grad.numpy(), p.numpy(),
                                      err_msg=name)
        np.testing.assert_allclose(t.grad.numpy(), r, err_msg=name,
                                   **GRAD_TOL[name])


def test_backward_op_skips_unneeded_gradients():
    """Only the inputs that require grad get one; the op still runs
    once."""
    value, loc, w, g = (torch.from_numpy(a) for a in _inputs(4))
    v = value.clone().requires_grad_(True)
    out = cuda_mod.ms_deform_attn_auto(v, SHAPES, loc, w)
    (out * g).sum().backward()
    assert v.grad is not None and loc.grad is None and w.grad is None
    ref = ms_deform_attn_backward(value, SHAPES, loc, w, g)[0]
    np.testing.assert_array_equal(v.grad.numpy(), ref.numpy())


def test_fake_implementations_give_the_shapes():
    value, loc, w, g = (torch.from_numpy(a) for a in _inputs(5, lq=7, d=5))
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fv, fl, fw, fg = (mode.from_tensor(t) for t in (value, loc, w, g))
        out = torch.ops.semi_detr.ms_deform_attn(fv, FLAT, fl, fw)
        dv, dl, dw = torch.ops.semi_detr.ms_deform_attn_bwd(fv, FLAT, fl,
                                                            fw, fg)
    assert tuple(out.shape) == (2, 7, 10) and out.dtype == torch.float32
    assert [tuple(t.shape) for t in (dv, dl, dw)] == [
        tuple(value.shape), tuple(loc.shape), tuple(w.shape)]


def test_flat_shapes_round_trip():
    assert FLAT == [6, 4, 3, 2]
    assert cuda_mod._pairs(FLAT) == SHAPES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_autograd_through_the_forward(case, dtype):
    """The written-out backward (the op's CPU implementation) against
    autograd through the plain forward: float32 sums in another order
    (1e-6 relative); a bfloat16 d_value scatters in bfloat16 on both
    sides (one bf16 rounding of the value, 2**-7 relative)."""
    value, loc, w, g = (torch.from_numpy(a) for a in _inputs(6,
                                                              **CASES[case]))
    value = value.to(dtype)
    got = ms_deform_attn_backward(value, SHAPES, loc, w, g)
    ref = ms_deform_attn_backward_autograd(value, SHAPES, loc, w, g)
    for name, a, b in zip(GRAD_TOL, got, ref):
        assert a.dtype == b.dtype, name
        rtol = 2 ** -7 if dtype == torch.bfloat16 and name == "d_value" \
            else 1e-6
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                   atol=rtol * float(b.float().abs().max()),
                                   msg=name)
