"""The port's `detection_loss` against the JAX package's, on one shared
outputs dict and one CDN layout.

Random per-layer outputs (2 decoder layers, 20 matching queries, 16 CDN
slots, 5 classes, batch 4) go into both criteria, with the CdnBatch built
by each side from the same noise (`test_torch_dn.jax_noise`). The key set
must be equal and every value within 1e-5 relative (float32, the same
formulas; the Hungarian costs are tie-free).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_detr_tpu.models import dn as jdn
from semi_detr_tpu.models.criterion import detection_loss as jax_loss
from semi_detr_tpu_torch.models import dn
from semi_detr_tpu_torch.models.criterion import detection_loss

from test_torch_dn import CAP, GROUPS, K, SINGLE_PAD, jax_noise, make_gt

N_DEC, NQ, C = 2, 20, 6
RTOL = 1e-5


def _case(counts, seed=0):
    rs = np.random.RandomState(seed)
    b = len(counts)
    boxes, labels, valid = make_gt(counts, seed=seed)
    label_enc = rs.randn(K + 2, C).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    jcdn = jdn.build_cdn_queries(key, jnp.asarray(boxes), jnp.asarray(labels),
                                 jnp.asarray(valid), jnp.asarray(label_enc),
                                 K, SINGLE_PAD, GROUPS)
    tcdn = dn.build_cdn_queries(jax_noise(key, b), torch.from_numpy(boxes),
                                torch.from_numpy(labels),
                                torch.from_numpy(valid),
                                torch.from_numpy(label_enc), K, SINGLE_PAD,
                                GROUPS)

    def sig(*shape):
        return (1 / (1 + np.exp(-rs.randn(*shape)))).astype(np.float32)

    outs = {
        "cls": (2 * rs.randn(N_DEC, b, NQ, K)).astype(np.float32),
        "coord": sig(N_DEC, b, NQ, 4),
        "enc_cls": (2 * rs.randn(b, NQ, K)).astype(np.float32),
        "enc_coord": sig(b, NQ, 4),
        "front_cls": (2 * rs.randn(N_DEC, b, CAP, K)).astype(np.float32),
        "front_coord": sig(N_DEC, b, CAP, 4),
    }
    gt = {"boxes": boxes, "labels": labels, "valid": valid}
    j_out = dict({k: jnp.asarray(v) for k, v in outs.items()}, cdn=jcdn)
    t_out = dict({k: torch.from_numpy(v) for k, v in outs.items()},
                 cdn=tcdn)
    j_gt = {k: jnp.asarray(v) for k, v in gt.items()}
    t_gt = {k: torch.from_numpy(v) for k, v in gt.items()}
    return j_out, j_gt, t_out, t_gt


@pytest.mark.parametrize("warm_up,pseudo,cls_group", [
    (False, False, None), (True, False, None),   # Hungarian / O2M
    (True, True, None),                          # pseudo labels: dn zeroed
    (False, False, 2), (True, False, 2),         # per-GPU cls avg factor
], ids=["hungarian", "o2m", "o2m_pseudo", "hungarian_group2",
        "o2m_group2"])
def test_detection_loss_matches_jax(warm_up, pseudo, cls_group):
    j_out, j_gt, t_out, t_gt = _case((3, 0, 8, 5))
    ref = jax_loss(j_out, j_gt, K, warm_up, is_pseudo_label=pseudo,
                   cls_group=cls_group)
    got = detection_loss(t_out, t_gt, K, warm_up, is_pseudo_label=pseudo,
                         cls_group=cls_group)
    assert list(got) == list(ref)                # same keys, same order
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=RTOL,
                                   atol=1e-7, err_msg=k)
    if pseudo:
        assert float(got["dn_loss_cls"]) == 0.0
    assert float(got["total"]) > 0


def test_detection_loss_without_any_gt():
    """A batch with no GT at all: fake dn, no positives, finite losses."""
    j_out, j_gt, t_out, t_gt = _case((0, 0, 0, 0), seed=1)
    for warm_up in (False, True):
        ref = jax_loss(j_out, j_gt, K, warm_up)
        got = detection_loss(t_out, t_gt, K, warm_up)
        for k in ref:
            assert np.isfinite(float(got[k])), k
            np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                       rtol=RTOL, atol=1e-7, err_msg=k)


def test_loss_gradients_reach_the_outputs():
    """The losses are differentiable in the outputs; the targets are not."""
    _, _, t_out, t_gt = _case((2, 4, 1, 3), seed=2)
    for k in ("cls", "coord", "enc_cls", "enc_coord", "front_cls",
              "front_coord"):
        t_out[k].requires_grad_(True)
    detection_loss(t_out, t_gt, K, warm_up=False)["total"].backward()
    for k in ("cls", "coord", "enc_cls", "enc_coord", "front_cls",
              "front_coord"):
        g = t_out[k].grad
        assert g is not None and torch.isfinite(g).all() and g.abs().sum() > 0
