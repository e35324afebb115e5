"""The port's losses, matching costs, assigners and Hungarian solve against
the JAX package's.

Losses and costs: 1e-5 relative (float32, the same formulas). Targets of
the assigners: labels exact, boxes and weights 1e-6. The port solves the
assignment with scipy on the host, the JAX package with its own in-graph
solver: on tie-free costs both give the same assignment; where GT rows
repeat, the assignments may differ, but the total cost and the targets
(the repeated rows carry the same box and label) may not.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_detr_tpu.core import boxes as jboxes
from semi_detr_tpu.models import assign as jassign
from semi_detr_tpu.models import losses as jlosses
from semi_detr_tpu.ops import hungarian as jhungarian
from semi_detr_tpu_torch.models import assign, losses
from semi_detr_tpu_torch.ops import hungarian

K = 5
RTOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach().numpy()
                                          if isinstance(got, torch.Tensor)
                                          else got),
                               np.asarray(ref), rtol=rtol, atol=atol)


def _boxes(rs, shape):
    ctr = rs.uniform(0.2, 0.8, shape + (2,))
    wh = rs.uniform(0.05, 0.5, shape + (2,))
    return np.concatenate([ctr, wh], -1).astype(np.float32)


@pytest.fixture
def rs():
    return np.random.RandomState(0)


def test_focal_losses_match_jax(rs):
    logits = (3 * rs.randn(4, 30, K)).astype(np.float32)
    logits[0, 0] = 40.0                      # saturated: BCE via softplus
    labels = rs.randint(0, K + 1, (4, 30)).astype(np.int32)
    weight = rs.uniform(0, 1, (4, 30)).astype(np.float32)
    metrics = rs.uniform(0, 1, (4, 30)).astype(np.float32)
    _close(losses.sigmoid_focal_loss(t(logits), t(labels), t(weight), 7.0,
                                     K),
           jlosses.sigmoid_focal_loss(logits, labels, weight, 7.0, K))
    _close(losses.task_aligned_focal_loss(t(logits), t(labels), t(metrics),
                                          t(weight), 3.5, K),
           jlosses.task_aligned_focal_loss(logits, labels, metrics, weight,
                                           3.5, K))
    # avg_factor below 1 is raised to 1, as tensor or number
    _close(losses.sigmoid_focal_loss(t(logits), t(labels), t(weight),
                                     torch.tensor(0.25), K),
           jlosses.sigmoid_focal_loss(logits, labels, weight, 0.25, K))


def test_box_losses_match_jax(rs):
    pred, tgt = _boxes(rs, (3, 20)), _boxes(rs, (3, 20))
    w4 = rs.uniform(0, 1, (3, 20, 4)).astype(np.float32)
    pxy, txy = (np.asarray(jboxes.cxcywh_to_xyxy(jnp.asarray(b)))
                for b in (pred, tgt))
    _close(losses.l1_loss(t(pred), t(tgt), t(w4), 9.0),
           jlosses.l1_loss(pred, tgt, w4, 9.0))
    _close(losses.giou_loss(t(pxy), t(txy), t(w4[..., 0]), 4.0),
           jlosses.giou_loss(pxy, txy, w4[..., 0], 4.0))
    for a, b in zip(losses.l1_terms(t(pred), t(tgt), t(w4), 2.0),
                    jlosses.l1_terms(pred, tgt, w4, 2.0)):
        _close(a, b)


def test_matching_costs_match_jax(rs):
    logits = (2 * rs.randn(3, 30, K)).astype(np.float32)
    pred, gt = _boxes(rs, (3, 30)), _boxes(rs, (3, 6))
    labels = rs.randint(0, K, (3, 6)).astype(np.int32)
    ref = jax.vmap(jlosses.focal_cost)(logits, labels)
    _close(losses.focal_cost(t(logits), t(labels)), ref, atol=1e-6)
    _close(losses.pair_l1_cost(t(pred), t(gt)),
           jax.vmap(jlosses.pair_l1_cost)(pred, gt))
    pxy, gxy = (np.asarray(jboxes.cxcywh_to_xyxy(jnp.asarray(b)))
                for b in (pred, gt))
    _close(losses.giou_cost(t(pxy), t(gxy)),
           jax.vmap(jlosses.giou_cost)(pxy, gxy), atol=1e-6)


def _gt(rs, counts, g=8):
    boxes = _boxes(rs, (len(counts), g))
    labels = rs.randint(0, K, (len(counts), g)).astype(np.int32)
    valid = np.arange(g)[None] < np.asarray(counts)[:, None]
    return boxes, labels, valid


def _preds(rs, b, nq=30):
    return (2 * rs.randn(b, nq, K)).astype(np.float32), _boxes(rs, (b, nq))


def _targets_equal(got, ref):
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(ref.labels))
    for f in ("label_weights", "bbox_targets", "bbox_weights",
              "norm_metrics", "num_pos"):
        _close(getattr(got, f), getattr(ref, f), rtol=1e-6, atol=1e-6)


def test_one_to_one_targets_match_jax(rs):
    """Invalid rows and an image with no GT."""
    boxes, labels, valid = _gt(rs, (3, 0, 8, 5))
    logits, pred = _preds(rs, 4)
    ref = jax.vmap(lambda c, b, gb, gl, gv: jassign.one_to_one_targets(
        c, b, gb, gl, gv, K))(logits, pred, boxes, labels, valid)
    got = assign.one_to_one_targets(t(logits), t(pred), t(boxes), t(labels),
                                    t(valid), K)
    _targets_equal(got, ref)
    assert got.num_pos.tolist() == [3, 0, 8, 5]


def test_o2m_targets_match_jax(rs):
    """Invalid rows, an image with no GT, and zero-alignment ties: most
    queries miss the GT boxes (IoU 0, alignment 0), so top-13 picks among
    tied zeros, which the alignment > 0 mask drops whatever their order."""
    boxes, labels, valid = _gt(rs, (4, 0, 8))
    logits, pred = _preds(rs, 3, nq=40)
    pred[:, :30, :2] = 0.02                  # 30 queries in a far corner
    pred[:, :30, 2:] = 0.01
    ref = jax.vmap(lambda c, b, gb, gl, gv: jassign.o2m_targets(
        c, b, gb, gl, gv, K))(logits, pred, boxes, labels, valid)
    got = assign.o2m_targets(t(logits), t(pred), t(boxes), t(labels),
                             t(valid), K)
    _targets_equal(got, ref)
    assert got.num_pos[1] == 0
    assert (got.labels[:, :30] == K).all()   # the tied zeros stay background
    assert got.num_pos[0] > 0 and got.num_pos[2] > 0


def test_hungarian_matches_jax_on_tie_free_costs(rs):
    for g, nq in ((1, 5), (6, 30), (20, 20)):
        cost = rs.randn(g, nq).astype(np.float32)
        valid = rs.rand(g) > 0.3
        valid[0] = True
        got = hungarian.solve(cost, valid)
        ref = np.asarray(jhungarian.solve(jnp.asarray(cost),
                                          jnp.asarray(valid)))
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got[~valid], -1)


def test_hungarian_on_duplicated_gt_rows(rs):
    """Two identical GT rows: the solvers may swap their columns, but the
    total cost is the same, and so are the Hungarian targets."""
    boxes, labels, valid = _gt(rs, (6, 6))
    boxes[:, 3], labels[:, 3] = boxes[:, 1], labels[:, 1]
    logits, pred = _preds(rs, 2)
    cost = assign.matching_cost(t(logits), t(pred), t(boxes), t(labels),
                                t(valid)).numpy()
    for c, v in zip(cost, valid):
        got = hungarian.solve(c, v)
        ref = np.asarray(jhungarian.solve(jnp.asarray(c), jnp.asarray(v)))
        rows = np.flatnonzero(v)
        np.testing.assert_allclose(c[rows, got[rows]].sum(),
                                   c[rows, ref[rows]].sum(), rtol=1e-6)
    ref = jax.vmap(lambda c, b, gb, gl, gv: jassign.one_to_one_targets(
        c, b, gb, gl, gv, K))(logits, pred, boxes, labels, valid)
    got = assign.one_to_one_targets(t(logits), t(pred), t(boxes), t(labels),
                                    t(valid), K)
    _targets_equal(got, ref)


def test_hungarian_nonfinite_costs_and_batches(rs):
    cost = rs.randn(4, 9).astype(np.float32)
    cost[1, 2] = np.nan
    cost[2, :4] = np.inf
    got = hungarian.solve(cost, np.ones(4, bool))
    ref = np.asarray(jhungarian.solve(jnp.asarray(cost),
                                      jnp.ones(4, bool)))
    np.testing.assert_array_equal(got, ref)
    # solve_batch: the same answers as one solve per problem
    costs = rs.randn(3, 2, 5, 12).astype(np.float32)
    valid = rs.rand(3, 2, 5) > 0.4
    out = hungarian.solve_batch(t(costs), t(valid))
    assert out.shape == (3, 2, 5) and out.dtype == torch.int64
    for i in range(3):
        for j in range(2):
            np.testing.assert_array_equal(
                out[i, j].numpy(), hungarian.solve(costs[i, j], valid[i, j]))
