"""The port's GroupNorm against flax's, and the detector at batch 1 where a
GroupNorm group holds one value.

At d_model 32 (GroupNorm(32) over 32 channels) on an image whose stride-64
level is 1x1, batch 1 leaves one value per group. torch's group_norm
refuses that input; the JAX GroupNorm computes it (x - mean is exactly 0,
so the output is the bias, and the gradient into x and the scale is
exactly 0). Tolerances: the output and every gradient 1e-5 absolute
(float32, the same formula on both sides); at one value per group the
gradients into x and the scale must be exactly 0, as JAX gives them; the
detector 5e-4 (test_torch_detector's bound: float32 op order through a
ResNet-50 and the transformer).
"""
import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from semi_detr_tpu_torch.models.layers import GroupNorm

from test_torch_detector import ATOL, TINY, build_pair

TOL = 1e-5


def _jax_group_norm(x_nchw, scale, bias, groups, proj):
    """flax GroupNorm on NHWC: (output NCHW, d_x NCHW, d_scale, d_bias) of
    sum(output * proj)."""
    mod = fnn.GroupNorm(num_groups=groups, epsilon=1e-5)
    x = jnp.asarray(x_nchw.transpose(0, 2, 3, 1))
    p = jnp.asarray(proj.transpose(0, 2, 3, 1))

    def loss(x, scale, bias):
        y = mod.apply({"params": {"scale": scale, "bias": bias}}, x)
        return (y * p).sum(), y

    (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(
        x, jnp.asarray(scale), jnp.asarray(bias))
    to_nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    return (to_nchw(y), to_nchw(grads[0]), np.asarray(grads[1]),
            np.asarray(grads[2]))


@pytest.mark.parametrize("shape,seed,spread", [
    ((1, 32, 1, 1), 0, 1.0), ((1, 32, 1, 1), 1, 100.0),
    ((2, 64, 3, 5), 2, 1.0)], ids=["one_value", "one_value_large",
                                   "batch2_map"])
def test_group_norm_matches_flax(shape, seed, spread):
    rng = np.random.RandomState(seed)
    x = (spread * rng.randn(*shape)).astype(np.float32)
    proj = rng.randn(*shape).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(shape[1])).astype(np.float32)
    bias = (0.1 * rng.randn(shape[1])).astype(np.float32)
    ref = _jax_group_norm(x, scale, bias, 32, proj)

    gn = GroupNorm(32, shape[1])
    gn.train()
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = gn(xt)
    (y * torch.from_numpy(proj)).sum().backward()
    got = (y.detach().numpy(), xt.grad.numpy(), gn.weight.grad.numpy(),
           gn.bias.grad.numpy())
    for name, a, b in zip(("out", "d_x", "d_scale", "d_bias"), got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=name)
    if shape[1] * shape[2] * shape[3] == 32:        # one value per group
        assert not ref[1].any() and not ref[2].any()
        assert not got[1].any() and not got[2].any()
        np.testing.assert_array_equal(got[0], np.broadcast_to(
            bias[None, :, None, None], shape))


def test_detector_batch_one_with_one_value_per_group_matches_jax():
    """Batch 1, d_model 32, a 64x64 canvas: the stride-64 level is 1x1, so
    the GroupNorm of its input projection sees one value per group."""
    jdet, jvars, port = build_pair(seed=0)
    assert TINY["d_model"] == 32
    rng = np.random.RandomState(3)
    images = rng.randint(0, 256, (1, 64, 64, 3)).astype(np.uint8)
    hw = np.asarray([[64, 56]], np.int32)
    ref = jax.jit(jdet.apply)(jvars, jnp.asarray(images), jnp.asarray(hw))
    for training in (False, True):
        port.train(training)
        with torch.no_grad():
            got = port(torch.from_numpy(images), torch.from_numpy(hw))
        for key in ("cls", "coord", "enc_cls", "enc_coord"):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(ref[key]), rtol=0,
                                       atol=ATOL, err_msg=(key, training))
    port.eval()
