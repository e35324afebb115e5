"""`tools.hungarian_hold.hold_solve`, the hold of chip_smoke.py phases 8a
and 8c on one Hungarian solve, on hand-made cost matrices with a near tie:
a solve the witnesses flip passes by its matching cost; columns that
differ where no witness flips, or that cost more than the witnesses
allow, fail."""
import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

from semi_detr_tpu_torch.tools import hungarian_hold
from semi_detr_tpu_torch.tools.hungarian_hold import hold_solve

FACTOR = 4.0
TIE = 1e-6


def problem():
    """(costs (2, 1, 2, 3), valid (2, 1, 2), one process's optimal columns):
    two heads of one image, two valid rows over three queries; in each,
    swapping the first two queries costs TIE more."""
    c = np.asarray([[1.0, 1.0 + TIE, 5.0], [1.0 + TIE, 1.0, 5.0]],
                   np.float32)
    costs = np.stack([c, c + 0.5])[:, None]
    valid = np.ones((2, 1, 2), bool)
    cols = np.stack([linear_sum_assignment(x[0])[1] for x in costs])[:, None]
    return costs, valid, cols


def test_the_optimum_is_the_diagonal():
    costs, valid, cols = problem()
    assert cols.tolist() == [[[0, 1]], [[0, 1]]]
    swapped = cols.copy()
    swapped[0, 0] = [1, 0]
    ex = hungarian_hold.assignment_cost(costs, valid, swapped) - \
        hungarian_hold.assignment_cost(costs, valid, cols)
    assert ex == pytest.approx(2 * TIE, rel=0.1)


def test_equal_columns_are_equal():
    costs, valid, cols = problem()
    h = hold_solve(cols, costs, valid, cols, costs, valid, cols,
                   [cols, cols], FACTOR)
    assert h["verdict"] == "equal"


def test_a_near_tie_the_witnesses_flip_passes():
    costs, valid, cols = problem()
    ranks = cols.copy()
    ranks[0, 0] = [1, 0]                  # the other assignment of a tie
    witness = ranks.copy()                # one witness flips it too
    h = hold_solve(ranks, costs, valid, cols, costs, valid, cols,
                   [witness, cols], FACTOR)
    assert h["verdict"] == "near tie", h
    assert h["witnesses_flipped"] == 1
    assert h["excess"] == pytest.approx(h["witness_excess"])
    assert h["excess"] > 0


def test_columns_no_witness_flips_fail():
    costs, valid, cols = problem()
    ranks = cols.copy()
    ranks[0, 0] = [1, 0]
    h = hold_solve(ranks, costs, valid, cols, costs, valid, cols,
                   [cols, cols], FACTOR)
    assert h["verdict"] == "failed" and "no witness" in h["why"]


def test_an_assignment_far_above_the_witnesses_fails():
    costs, valid, cols = problem()
    ranks = cols.copy()
    ranks[0, 0] = [2, 1]                  # 4 more: no tie
    witness = cols.copy()
    witness[1, 0] = [1, 0]                # a witness flips a tie elsewhere
    h = hold_solve(ranks, costs, valid, cols, costs, valid, cols,
                   [witness], FACTOR)
    assert h["verdict"] == "failed" and "more than" in h["why"]
    assert h["excess"] == pytest.approx(4.0, rel=1e-6)


def test_an_unmatched_valid_row_fails():
    costs, valid, cols = problem()
    ranks = cols.copy()
    ranks[0, 0] = [-1, 1]
    h = hold_solve(ranks, costs, valid, cols, costs, valid, cols,
                   [ranks], FACTOR)
    assert h["verdict"] == "failed" and "unmatched" in h["why"]


def test_another_starts_witnesses_set_the_limit():
    """Phase 8c: the witnesses of another start (their own matrix and
    optimum) give the limit for one process from the leg's state."""
    costs, valid, cols = problem()
    w_costs = costs.copy()
    w_costs[..., 0, 1] += 4 * TIE         # that start's tie is wider
    w_cols = cols
    witness = cols.copy()
    witness[0, 0] = [1, 0]
    ranks = witness.copy()
    h = hold_solve(ranks, costs, valid, cols, w_costs, valid, w_cols,
                   [witness], FACTOR)
    assert h["verdict"] == "near tie"
    assert h["witness_excess"] > h["excess"]


def test_the_floor_is_float32_of_the_optimum():
    costs, valid, cols = problem()
    ranks = np.asarray([[[1, 0]], [[0, 1]]])
    h = hold_solve(ranks, costs, valid, cols, costs, valid, cols, [ranks],
                   FACTOR)
    # |cost| over the optimum's entries: 1 + 1 in head 0, 1.5 + 1.5 in 1
    assert h["floor"] == pytest.approx(
        hungarian_hold.FLOAT32_FLOOR * 5.0, rel=1e-6)
    assert h["verdict"] == "near tie"
