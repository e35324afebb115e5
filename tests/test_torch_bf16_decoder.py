"""The port in bfloat16 against the JAX package in bfloat16.

TINY width (test_torch_detector), random weights carried into both, bf16
compute with float32 parameters on both sides, on one shared bf16
backbone output (the JAX model's srcs fed to both encoders):

1. the encoder's per-token outputs (memory);
2. both decoders on one shared two-stage selection: the JAX bf16 encode
   (tgt, reference points, memory) fed to the JAX decoder and, as torch
   tensors, to the port's, with and without a masked front block.

The tolerance comes from a control: the JAX package's own float32 model
against its bf16 model on the same inputs (relative L2 of the memory and
of the decoder's hs; max abs of the logits and coordinates). The port's
gap to the JAX bf16 model reads about 1.5x the control on every output
(encoder 7.3e-3 against 4.7e-3; decoder hs 8.0e-3 against 5.2e-3, logits
2.5e-2 against 1.7e-2, coordinates 3.2e-3 against 2.2e-3). Taking the
decoder's self-attention softmax in bf16, as flax does, does not close it
(hs 8.2e-3, logits 3.0e-2, coordinates 3.8e-3), so the port keeps its
float32 softmax; the rest of the gap lies elsewhere in the bf16 layers
(ROADMAP Queue 3). The bound below, twice the control, holds the gap
where it is measured: bf16 rounding differences, not a fault that grows.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_detr_tpu.models.dino_head import DinoConfig as JaxConfig
from semi_detr_tpu.models.dino_head import DINODetector as JaxDetector
from semi_detr_tpu.models.dino_head import prepare_images

from test_torch_detector import TINY, build_pair

LIMIT = 2.0


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _torch(x):
    """A JAX array as a torch tensor (bf16 stays bf16)."""
    x = jnp.asarray(x)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _as(tree, dtype):
    """Every bf16 / float32 leaf of a JAX tree in `dtype`."""
    return {k: v.astype(dtype) if hasattr(v, "dtype") and v.dtype in (
        jnp.float32, jnp.bfloat16) else v for k, v in tree.items()}


@pytest.fixture(scope="module")
def models():
    """Weights, the port in bf16, the JAX models in float32 and bf16, one
    bf16 backbone output (srcs) of two images, and each JAX model's encode
    of those srcs."""
    _, jvars, port = build_pair(seed=4)
    port.set_compute_dtype(torch.bfloat16)
    j32 = JaxDetector(JaxConfig(**TINY))
    j16 = JaxDetector(JaxConfig(**TINY, dtype=jnp.bfloat16))
    rs = np.random.RandomState(3)
    images = prepare_images(
        jnp.asarray(rs.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)),
        jnp.asarray([[64, 64], [56, 48]], jnp.int32))
    hw = jnp.asarray([[64, 64], [56, 48]], jnp.int32)
    srcs = jax.jit(lambda v, x: j16.apply(
        v, x, method=JaxDetector.forward_features_only)[0])(jvars, images)
    shapes = tuple((int(x.shape[1]), int(x.shape[2])) for x in srcs)
    enc = {}
    for name, m, dt in (("f32", j32, jnp.float32), ("bf16", j16,
                                                    jnp.bfloat16)):
        enc[name] = jax.jit(lambda v, x, h, f, m=m: {
            k: val for k, val in m.apply(
                v, x, h, (f, shapes),
                method=JaxDetector.encode_images).items()
            if k != "spatial_shapes"})(
                jvars, images, hw, [x.astype(dt) for x in srcs])
    return dict(jvars=jvars, port=port, j32=j32, j16=j16, images=images,
                hw=hw, srcs=srcs, shapes=shapes, enc=enc)


def test_encoder_tokens_bf16_within_control(models):
    m = models
    feats = [_torch(x).permute(0, 3, 1, 2) for x in m["srcs"]]
    with torch.no_grad():
        got = m["port"].encode_images(_torch(m["images"]), _torch(m["hw"]),
                                      features=(feats, m["shapes"]))
    mem = got["memory"]
    assert mem.dtype == torch.bfloat16
    ref = _f32(m["enc"]["bf16"]["memory"])
    ctl = _f32(m["enc"]["f32"]["memory"])
    gap, control = _rel_l2(mem.float().numpy(), ref), _rel_l2(ctl, ref)
    assert 0 < gap <= LIMIT * control, (gap, control)


def _front(n_front, nq, c, seed):
    """A masked front block of two groups (as the CDN / consistency
    blocks): content, unsigmoided boxes and the (T, T) mask."""
    rs = np.random.RandomState(seed)
    content = rs.randn(2, n_front, c).astype(np.float32)
    bbox = (0.5 * rs.randn(2, n_front, 4)).astype(np.float32)
    mask = np.zeros((n_front + nq, n_front + nq), bool)
    mask[n_front:, :n_front] = True
    half = n_front // 2
    mask[:half, half:n_front] = mask[half:n_front, :half] = True
    return content, bbox, mask


@pytest.mark.parametrize("front", [False, True], ids=["matching", "masked"])
def test_decoder_bf16_within_control(models, front):
    m = models
    shared = m["enc"]["bf16"]        # one two-stage selection for all three
    args = ()
    if front:
        args = tuple(jnp.asarray(a) for a in
                     _front(6, TINY["num_queries"], TINY["d_model"], 5))

    def jax_decode(model, e):
        return jax.jit(lambda v, e, *a: model.apply(
            v, dict(e, spatial_shapes=m["shapes"]), *a,
            method=JaxDetector.decode_queries))(m["jvars"], e, *args)

    ref = jax_decode(m["j16"], shared)
    ctl = jax_decode(m["j32"], _as(shared, jnp.float32))
    penc = {k: _torch(shared[k]) for k in (
        "memory", "pad_mask", "valid_ratios", "tgt", "refpoint_unsig",
        "enc_out_class", "enc_out_coord")}
    penc["spatial_shapes"] = m["shapes"]
    with torch.no_grad():
        got = m["port"].decode_queries(penc, *[_torch(a) for a in args])
    assert got["hs"].dtype == torch.bfloat16
    rows = {}
    for key, metric in (("hs", _rel_l2), ("cls", _max_abs),
                        ("coord", _max_abs)):
        r = _f32(ref[key])
        rows[key] = (metric(got[key].float().numpy(), r),
                     metric(_f32(ctl[key]), r))
    for key, (gap, control) in rows.items():
        assert gap <= LIMIT * control, (key, rows)
