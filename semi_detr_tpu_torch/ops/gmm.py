"""Two-component 1-D GMM (EM) for the pseudo-label cost threshold.

Counterpart of `semi_detr_tpu/ops/gmm.py`, after the reference's sklearn
GaussianMixture fit (`detr_ssod/models/dino_detr_ssod.py:832-890`): two
components, means initialized at [min, max], weights [.5, .5], variances 1,
reg_covar 1e-5; EM stops when the mean per-sample log-likelihood (the lower
bound) changes by less than tol=1e-3, after at most 100 iterations, each
iteration an e-step under the current parameters followed by the m-step.

The loop is data-dependent, so it runs on the host, as the reference runs
sklearn there: the padded pool and its validity travel to the CPU in one
copy, and every iteration is float32 arithmetic on those few hundred
values, with no device sync inside the loop.

Threshold rule (reference `:869-890`): among the points assigned to the
low-mean component 0, the one with the highest GMM log-likelihood gives the
threshold (its own cost value); if component 0 is empty, component 1 does.
An empty pool gives 0.0, a pool of one point that point.
"""
from __future__ import annotations

import torch

_LOG2PI = 1.8378770664093453
N_ITER, REG_COVAR, TOL = 100, 1e-5, 1e-3      # sklearn's, as the reference


def _log_prob(costs, means, variances, weights):
    """(K, 2) component log-densities plus log-weights."""
    d2 = (costs[:, None] - means[None, :]) ** 2
    lp = -0.5 * (_LOG2PI + variances.log()[None, :] + d2 / variances[None, :])
    return lp + weights.log()[None, :]


def fit_gmm_threshold(costs: torch.Tensor, valid: torch.Tensor) -> float:
    """Fit the GMM on `costs[valid]` and return the cost threshold.

    costs: (K,) padded cost pool, any device; valid: (K,) bool, which
    entries are data points. Returns the threshold as a Python float (a
    float32 value of the pool)."""
    both = torch.stack([costs.detach().float(), valid.float()]).cpu()
    costs, valid = both[0], both[1] > 0
    n_valid = int(valid.sum())
    if n_valid == 0:
        return 0.0
    big = torch.tensor(3.4e38, dtype=torch.float32)
    cmin = torch.where(valid, costs, big).min()
    if n_valid == 1:
        return float(cmin)
    cmax = torch.where(valid, costs, -big).max()
    n = torch.tensor(float(n_valid), dtype=torch.float32)

    means = torch.stack([cmin, cmax])
    variances = torch.ones(2, dtype=torch.float32)
    weights = torch.full((2,), 0.5, dtype=torch.float32)
    vmask = valid.float()
    prev_lb = torch.tensor(float("-inf"))
    for _ in range(N_ITER):
        wlp = _log_prob(costs, means, variances, weights)
        lb = (torch.logsumexp(wlp, -1) * vmask).sum() / n
        resp = wlp.softmax(-1) * vmask[:, None]
        nk = resp.sum(0) + 1e-10
        means = (resp * costs[:, None]).sum(0) / nk
        variances = ((resp * (costs[:, None] - means[None, :]) ** 2).sum(0)
                     / nk + REG_COVAR)
        weights = nk / n
        if bool((lb - prev_lb).abs() < TOL):
            break
        prev_lb = lb

    wlp = _log_prob(costs, means, variances, weights)
    assign0 = wlp[:, 0] >= wlp[:, 1]
    score = torch.logsumexp(wlp, -1)
    mask = assign0 & valid
    if not bool(mask.any()):
        mask = ~assign0 & valid
    return float(costs[torch.argmax(torch.where(mask, score, -big))])
