"""The port's CDN queries (`models/dn.py`) against the JAX package's.

The port draws its noise from a `torch.Generator`, the JAX package from a
key, so the two never share numbers. `jax_noise` makes the JAX draws of
`build_cdn_queries` (semi_detr_tpu/models/dn.py:152-191, same keys, same
calls) and hands them to the port as a `CdnNoise`: the two CdnBatches must
then agree slot for slot, noise included. The port's own draws are held
to the noise's properties instead.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_detr_tpu.models import dn as jdn
from semi_detr_tpu_torch.models import dn

K = 5                      # classes
SINGLE_PAD, GROUPS = 4, 2  # capacity 16
CAP = 2 * SINGLE_PAD * GROUPS
G = 8                      # max_gt
C = 6                      # content width
NQ = 20


def jax_noise(key, batch, capacity=CAP, num_classes=K) -> dn.CdnNoise:
    """The random numbers of the JAX `build_cdn_queries(key, ...)`."""
    k_fake, k_label, k_newl, k_sign, k_part = jax.random.split(key, 5)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return dn.CdnNoise(
        fake_label=t(jax.random.randint(k_fake, (batch,), 0, num_classes)),
        relabel_u=t(jax.random.uniform(k_label, (batch, capacity))),
        new_label=t(jax.random.randint(k_newl, (batch, capacity), 0,
                                       num_classes)),
        sign=t(jax.random.randint(k_sign, (batch, capacity, 4), 0, 2)
               .astype(jnp.float32) * 2.0 - 1.0),
        part=t(jax.random.uniform(k_part, (batch, capacity, 4))))


def make_gt(counts, seed=0, g=G):
    """Prefix-packed GT of the given per-image counts (numpy)."""
    rs = np.random.RandomState(seed)
    b = len(counts)
    ctr = rs.uniform(0.25, 0.75, (b, g, 2))
    wh = rs.uniform(0.1, 0.4, (b, g, 2))
    boxes = np.concatenate([ctr, wh], -1).astype(np.float32)
    labels = rs.randint(0, K, (b, g)).astype(np.int32)
    valid = np.arange(g)[None] < np.asarray(counts)[:, None]
    boxes[~valid] = 0.0
    labels[~valid] = 0
    return boxes, labels, valid


COUNTS = [(3, 2), (0, 5), (8, 1), (0, 0)]


@pytest.mark.parametrize("counts", COUNTS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_cdn_batch_matches_jax(counts):
    boxes, labels, valid = make_gt(counts)
    label_enc = np.random.RandomState(1).randn(K + 2, C).astype(np.float32)
    key = jax.random.PRNGKey(sum(counts))
    ref = jdn.build_cdn_queries(key, jnp.asarray(boxes), jnp.asarray(labels),
                                jnp.asarray(valid), jnp.asarray(label_enc),
                                K, SINGLE_PAD, GROUPS)
    got = dn.build_cdn_queries(jax_noise(key, len(counts)),
                               torch.from_numpy(boxes),
                               torch.from_numpy(labels),
                               torch.from_numpy(valid),
                               torch.from_numpy(label_enc), K, SINGLE_PAD,
                               GROUPS)
    for f in ("gt_idx", "is_positive", "slot_valid", "slot_active",
              "pad_mask", "single_pad", "groups"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(got.query_label.numpy(),
                                  np.asarray(ref.query_label))
    np.testing.assert_allclose(got.query_bbox.numpy(),
                               np.asarray(ref.query_bbox), rtol=0,
                               atol=1e-5)

    # the masks of this layout
    sp, grp = int(ref.single_pad), int(ref.groups)
    np.testing.assert_array_equal(
        dn.dn_slot_groups(got.single_pad, got.groups, CAP).numpy(),
        np.asarray(jdn.dn_slot_groups(sp, grp, CAP)))
    np.testing.assert_array_equal(
        dn.cdn_attn_mask(got.single_pad, got.groups, NQ, CAP).numpy(),
        np.asarray(jdn.cdn_attn_mask(sp, grp, NQ, CAP)))
    groups = jdn.dn_slot_groups(sp, grp, CAP)
    np.testing.assert_array_equal(
        dn.front_attn_mask(torch.from_numpy(np.array(groups)), NQ).numpy(),
        np.asarray(jdn.front_attn_mask(groups, NQ)))


def test_static_layout_masks_match_jax():
    """Python-int arguments, capacity from single_pad * groups."""
    for sp, grp in ((3, 2), (1, 1), (4, 5)):
        np.testing.assert_array_equal(
            dn.cdn_attn_mask(sp, grp, NQ).numpy(),
            np.asarray(jdn.cdn_attn_mask(sp, grp, NQ)))


@pytest.mark.parametrize("counts", COUNTS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_compact_gt_matches_jax(counts):
    """A scattered validity mask is prefix-packed the same way."""
    boxes, labels, _ = make_gt((G,) * len(counts), seed=2)
    rs = np.random.RandomState(sum(counts))
    valid = np.zeros((len(counts), G), bool)
    for i, n in enumerate(counts):
        valid[i, rs.choice(G, n, replace=False)] = True
    ref = jdn.compact_gt(jnp.asarray(boxes), jnp.asarray(labels),
                         jnp.asarray(valid))
    got = dn.compact_gt(torch.from_numpy(boxes), torch.from_numpy(labels),
                        torch.from_numpy(valid))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        dn.pack_order(torch.from_numpy(valid)).numpy(),
        np.asarray(jdn.pack_order(jnp.asarray(valid))))


def test_port_noise_has_the_cdn_properties():
    """With the port's own generator: positives move each corner by less
    than box_noise_scale * half-extent, negatives by [1, 2) times that
    (where no clamp applied), and labels are redrawn at rate
    label_noise_ratio / 2, so one changes at about 0.25 * (1 - 1/K)."""
    b, scale = 64, 0.4
    boxes, labels, valid = make_gt((G,) * b, seed=3)
    onehot = torch.eye(K + 2)                    # content row = its label
    g = torch.Generator().manual_seed(0)
    noise = dn.draw_cdn_noise(g, b, CAP, K, "cpu")
    cdn = dn.build_cdn_queries(noise, torch.from_numpy(boxes),
                               torch.from_numpy(labels),
                               torch.from_numpy(valid), onehot, K,
                               SINGLE_PAD, GROUPS, 0.5, scale)
    idx = cdn.gt_idx.numpy()
    sv = cdn.slot_valid.numpy()
    assert sv.all()                              # 4 GT per chunk, 4 slots

    src = torch.from_numpy(boxes[:, idx]).double()
    corners = torch.cat([src[..., :2] - src[..., 2:] / 2,
                         src[..., :2] + src[..., 2:] / 2], -1)
    half = torch.cat([src[..., 2:] / 2] * 2, -1)
    q = cdn.query_bbox.double().sigmoid()
    noised = torch.cat([q[..., :2] - q[..., 2:] / 2,
                        q[..., :2] + q[..., 2:] / 2], -1)
    ratio = ((noised - corners).abs() / (half * scale)).numpy()
    free = ((noised > 1e-4) & (noised < 1 - 1e-4)).numpy()
    pos = cdn.is_positive.numpy()[None, :, None] & free
    neg = ~cdn.is_positive.numpy()[None, :, None] & free
    assert pos.sum() > 1000 and neg.sum() > 1000
    assert ratio[pos].max() < 1.0 + 1e-3
    assert ratio[neg].min() > 1.0 - 1e-3 and ratio[neg].max() < 2.0 + 1e-3

    new = cdn.query_label.argmax(-1).numpy()
    old = labels[:, idx]
    redrawn = (noise.relabel_u < 0.25).numpy()
    assert abs(redrawn.mean() - 0.25) < 0.02
    assert abs((new != old).mean() - 0.25 * (1 - 1 / K)) < 0.02
    assert (new[~redrawn] == old[~redrawn]).all()


def test_fake_gt_for_images_without_gt():
    """An image with no GT gets the fake box (0.5, 0.5, 0.5, 0.5) in slot 0
    of every chunk, and pad_mask marks it."""
    boxes, labels, valid = make_gt((0, 3))
    noise = dn.draw_cdn_noise(torch.Generator().manual_seed(1), 2, CAP, K,
                              "cpu")
    cdn = dn.build_cdn_queries(noise._replace(
        part=torch.zeros_like(noise.part)), torch.from_numpy(boxes),
        torch.from_numpy(labels), torch.from_numpy(valid),
        torch.eye(K + 2), K, SINGLE_PAD, GROUPS)
    assert cdn.pad_mask.tolist() == [True, False]
    first = (cdn.gt_idx == 0) & cdn.is_positive
    torch.testing.assert_close(cdn.query_bbox[0, first].sigmoid(),
                               torch.full((int(first.sum()), 4), 0.5))
    assert cdn.slot_valid[0].sum() == 2 * int(cdn.groups)
