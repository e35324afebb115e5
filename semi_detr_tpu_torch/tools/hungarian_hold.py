"""The hold of `chip_smoke.py` phases 8a and 8c on one Hungarian solve:
the ranks' columns against one process's on the global batch.

A solve's columns are a discrete choice. Where two assignments cost
almost the same, one float32 rounding of the input (a witness: one process
with every image value moved by one rounding) flips the choice, so the
ranks, whose costs round otherwise, can pick the other assignment too (a
smoke run on the card once failed so: the ranks and both witnesses changed
the same solve). Equality is the hold where it can be had; elsewhere the
choice is held by what it costs:

* equal: the ranks' columns equal one process's;
* near tie: they differ, and (a) at least one witness also changed this
  solve's columns, and (b) the ranks' assignment, scored on one process's
  cost matrix, exceeds one process's optimum by at most `factor` times the
  largest excess of a witness's assignment on its own reference's matrix,
  plus FLOAT32_FLOOR of the optimum's magnitude (the sum of |cost| over
  the optimum's entries);
* failed: anything else, columns that differ where no witness flips among
  them.

Costs are (..., G, Nq) float32 and valid (..., G) bool, as
`ops.hungarian.solve_batch` receives them; columns are (..., G), -1 on an
invalid row. An assignment is scored in float64 over one process's valid
rows; one that leaves such a row unmatched, or matches an invalid one,
cannot be scored and does not hold.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# 8 float32 roundings (2^-23 each) of the optimum's magnitude: the ranks'
# cost entries may each differ from one process's by about a rounding, so
# their optimum may sit that far from one process's on its matrix
FLOAT32_FLOOR = 8 * 2.0 ** -23


def assignment_cost(costs, valid, cols) -> Optional[float]:
    """The cost of `cols` on `costs` over the rows `valid` marks (float64),
    or None where `cols` leaves a valid row unmatched or matches an
    invalid one."""
    costs = np.asarray(costs, np.float64)
    valid = np.asarray(valid, bool)
    cols = np.asarray(cols)
    if cols.shape != valid.shape or np.any((cols >= 0) != valid) or \
            np.any(cols >= costs.shape[-1]):
        return None
    picked = np.take_along_axis(costs, np.where(valid, cols, 0)[..., None],
                                -1)[..., 0]
    return float(np.where(valid, picked, 0.0).sum())


def magnitude(costs, valid, cols) -> float:
    """Sum of |cost| over the entries `cols` picks on the valid rows."""
    costs = np.abs(np.asarray(costs, np.float64))
    valid = np.asarray(valid, bool)
    picked = np.take_along_axis(
        costs, np.where(valid, np.asarray(cols), 0)[..., None], -1)[..., 0]
    return float(np.where(valid, picked, 0.0).sum())


def hold_solve(got_cols, costs, valid, cols, wit_costs, wit_valid, wit_cols,
               witness_cols: Sequence, factor: float) -> dict:
    """One solve's verdict: the ranks' columns `got_cols` against one
    process's (`costs`, `valid`, `cols`), with the witnesses'
    `witness_cols` beside their reference's (`wit_costs`, `wit_valid`,
    `wit_cols`: one process itself in phase 8a; in 8c another start's).
    Returns {"verdict": "equal" | "near tie" | "failed", "excess",
    "witness_excess", "floor", "witnesses_flipped", "why"}."""
    got_cols, cols = np.asarray(got_cols), np.asarray(cols)
    out = dict(verdict="equal", excess=0.0, witness_excess=None, floor=None,
               witnesses_flipped=None, why="")
    if got_cols.shape == cols.shape and np.array_equal(got_cols, cols):
        return out
    ref_cols = np.asarray(wit_cols)
    flipped = [not (np.shape(w) == ref_cols.shape
                    and np.array_equal(np.asarray(w), ref_cols))
               for w in witness_cols]
    out["witnesses_flipped"] = sum(flipped)
    best = assignment_cost(costs, valid, cols)
    got = assignment_cost(costs, valid, got_cols)
    wit_best = assignment_cost(wit_costs, wit_valid, ref_cols)
    wit_ex = [assignment_cost(wit_costs, wit_valid, w) for w in witness_cols]
    wit_ex = [e - wit_best for e in wit_ex
              if e is not None and wit_best is not None]
    out["floor"] = FLOAT32_FLOOR * magnitude(costs, valid, cols)
    if not any(flipped):
        out.update(verdict="failed",
                   why="columns differ and no witness changes this solve")
        return out
    if got is None or best is None:
        out.update(verdict="failed", why="the ranks' columns leave a valid "
                   "row unmatched or match an invalid one")
        return out
    out["excess"] = got - best
    if not wit_ex:
        out.update(verdict="failed", why="no witness's assignment can be "
                   "scored on its reference's matrix")
        return out
    out["witness_excess"] = max(wit_ex)
    if out["excess"] > factor * out["witness_excess"] + out["floor"]:
        out.update(verdict="failed", why=(
            f"the ranks' assignment costs {out['excess']!r} more than one "
            f"process's optimum, above {factor} x the witnesses' "
            f"{out['witness_excess']!r} + {out['floor']!r}"))
        return out
    out["verdict"] = "near tie"
    return out
