"""Hungarian matching (rectangular linear sum assignment) on the host.

Counterpart of `semi_detr_tpu/ops/hungarian.py:solve`. The JAX package
solves inside the compiled step only because the TPU step is one XLA
program; on the card the solve runs on the host, as in the reference
(mmdet's `HungarianAssigner` calls scipy). The tensors stay on the card:
only the cost matrices travel, all of a step's in one copy
(`solve_batch`), and the assignments come back in one copy.

scipy's `linear_sum_assignment` and the JAX solver find the same optimal
total cost; on ties they may pick different assignments.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment
from torch.profiler import record_function

# a non-finite cost (scipy raises on NaN or an infeasible inf) becomes this
# large finite value: the solve ends, and the NaN still surfaces in the loss
NONFINITE_COST = 1e9


def solve(cost: np.ndarray, row_valid=None) -> np.ndarray:
    """Minimize sum(cost[i, col4row[i]]); NR <= NC.

    cost: (NR, NC) host array; row_valid: optional (NR,) bool, invalid rows
    are left out of the problem. Returns col4row (NR,) int64, -1 for
    invalid rows (not a usable column: mask before indexing)."""
    cost = np.asarray(cost, np.float32)
    nr, nc = cost.shape
    if nr > nc:
        raise ValueError("pad GTs along rows; queries along columns")
    cost = np.where(np.isfinite(cost), cost, np.float32(NONFINITE_COST))
    rows = (np.arange(nr) if row_valid is None
            else np.flatnonzero(np.asarray(row_valid)))
    col4row = np.full((nr,), -1, np.int64)
    if rows.size:
        r, c = linear_sum_assignment(cost[rows])
        col4row[rows[r]] = c
    return col4row


def solve_batch(costs: torch.Tensor, row_valid: torch.Tensor
                ) -> torch.Tensor:
    """`solve` over the leading axes of costs (..., G, Nq) with row_valid
    (..., G): one copy to the host for all problems, one back. Returns
    (..., G) int64 on costs' device, -1 for invalid rows."""
    lead = costs.shape[:-2]
    with record_function("hungarian.solve_batch"):
        # the validity rides along as a last column: one copy carries both
        both = torch.cat([costs.detach().float(),
                          row_valid[..., None].float()], -1)
        both = both.reshape(-1, *both.shape[-2:]).cpu().numpy()
        cols = np.stack([solve(b[:, :-1], b[:, -1] > 0) for b in both])
        return torch.from_numpy(cols).reshape(*lead, -1).to(costs.device)
