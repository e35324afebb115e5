"""The hold of `chip_smoke.py` phase 10: remat against no remat from one
state, on runs of the same step taken in turns (no remat, remat, no remat,
remat, ...).

A run is a dict: `remat` (bool), `losses` ({name: float}), `grad` and
`update` ({leaf: tensor}), `launches`, `ms` and `peak`. Per leaf, the
floor is the largest relative L2 error between consecutive runs of one
mode (no remat twice, remat twice: d_value's atomic order, and for the
updates the clip and Adam after it) and the error the largest between
neighbouring runs of the two modes.

* The loss terms are bit-equal in every run.
* Gradients, and the updates of the leaves whose floor is at most
  NOISE_LEAF: each leaf within REMAT_FACTOR times its own floor plus
  BF16_ROUNDING (remat changes the order in which autograd adds the
  contributions of a tensor several checkpointed regions read, and a
  bfloat16 sum of them may round once more: encoder layer 3's
  linear2.bias read 7.4e-4 against a floor of 1.3e-5 in the SSOD warm-up
  step; NVIDIA H100 80GB HBM3, 700.00 W), the median within REMAT_FACTOR
  times the floor's median plus REMAT_FLOOR.
* The noise leaves: the updates whose floor exceeds NOISE_LEAF (Adam's
  first steps turn a gradient element's rounding around zero into a full
  step of the other sign; one such element of a 256x256 weight reads
  8e-3), about 190 of them at full width. Their statistic is the ratio of
  each leaf's error to its floor. Its largest value over the leaves is
  the tail of ~190 draws: one leaf read 7.16x its floor while the median
  sat at the floor, in one call of four (PERF.md, PR 11), so a maximum
  held to a fixed factor refuses sound runs by chance. The hold is on its
  NOISE_QUANTILE quantile instead, within NOISE_WITNESS_FACTOR times the
  same quantile of the same statistic between runs of one mode (each
  one-mode error over the other mode's, both ways: how far apart two
  measurements of the floor fall in this call), and never below
  REMAT_FACTOR; and its median within REMAT_FACTOR. The maximum and the
  witness's are reported beside them.
"""
from __future__ import annotations

import numpy as np

REMAT_FACTOR, REMAT_FLOOR, NOISE_LEAF = 4.0, 1e-4, 1e-3
BF16_ROUNDING = 2 ** -8
NOISE_QUANTILE, NOISE_WITNESS_FACTOR = 0.9, 2.0


def rel_errors(pairs, key):
    """Per leaf, the largest relative L2 of y[key] against x[key] over the
    pairs of runs (x, y); leaves where x's tensor is all zero are left
    out."""
    out = {}
    for x, y in pairs:
        for k, a in x[key].items():
            if not a.any():
                continue
            e = float((y[key][k].double() - a.double()).norm()
                      / a.double().norm())
            out[k] = max(out.get(k, 0.0), e)
    return out


def noise_hold(err, floor, off_pair, on_pair, noise):
    """The noise leaves' ratios of error to floor against their witness:
    (record, whether it holds)."""
    ratio = np.array([err[k] / floor[k] for k in noise])
    a = np.array([off_pair.get(k, 0.0) for k in noise])
    b = np.array([on_pair.get(k, 0.0) for k in noise])
    tiny = np.finfo(np.float64).tiny
    witness = np.concatenate([a / np.maximum(b, tiny),
                              b / np.maximum(a, tiny)])
    q = float(np.quantile(ratio, NOISE_QUANTILE))
    q_witness = float(np.quantile(witness, NOISE_QUANTILE))
    limit = max(REMAT_FACTOR, NOISE_WITNESS_FACTOR * q_witness)
    median = float(np.median(ratio))
    worst = noise[int(np.argmax(ratio))]
    rec = dict(quantile=NOISE_QUANTILE, ratio_quantile=q,
               witness_quantile=q_witness, limit=limit,
               ratio_median=median, ratio_max=float(ratio.max()),
               worst_leaf=worst, witness_max=float(witness.max()))
    return rec, q <= limit and median <= REMAT_FACTOR


def check_remat(runs, what):
    """The hold of the module docstring on `runs` (in turns, the first
    without remat); returns its record, or raises AssertionError naming
    `what` and every leaf out of bounds."""
    a = runs[0]
    for other in runs[1:]:
        if other["losses"] != a["losses"]:
            diff = {k: (a["losses"][k], other["losses"][k])
                    for k in a["losses"]
                    if other["losses"].get(k) != a["losses"][k]}
            raise AssertionError(f"{what}: loss terms of remat="
                                 f"{other['remat']} differ: {diff}")
    off, on = runs[0::2], runs[1::2]
    same = list(zip(off, off[1:])) + list(zip(on, on[1:]))
    cross = list(zip(runs, runs[1:]))
    out = dict(losses=a["losses"], launches=a["launches"], runs=len(runs))
    failures = []
    for key in ("grad", "update"):
        floor = rel_errors(same, key)
        err = rel_errors(cross, key)
        floor = {k: floor.get(k, 0.0) for k in err}
        noise = ([k for k in err if floor[k] > NOISE_LEAF]
                 if key == "update" else [])
        kept = {k: err[k] for k in err if k not in noise}
        bad = {k: (kept[k], floor[k]) for k in kept
               if kept[k] > REMAT_FACTOR * floor[k] + BF16_ROUNDING}
        med_err = float(np.median(list(kept.values())))
        med_floor = float(np.median([floor[k] for k in kept]))
        worst = max(kept, key=kept.get)
        out[key] = dict(
            leaves=len(kept), worst_leaf=worst, worst=kept[worst],
            floor_of_worst=floor[worst], median=med_err,
            floor_median=med_floor, noise_leaves=len(noise), noise=None)
        noise_ok = True
        if noise:
            out[key]["noise"], noise_ok = noise_hold(
                err, floor, rel_errors(list(zip(off, off[1:])), key),
                rel_errors(list(zip(on, on[1:])), key), noise)
        if (bad or not noise_ok
                or med_err > REMAT_FACTOR * med_floor + REMAT_FLOOR):
            failures.append(f"{key}: leaves (error, floor) "
                            f"{list(bad.items())[:5]}; {out[key]}")
    warm_off, warm_on = off[1:], on[1:]
    out["ms"] = {"no_remat": float(np.median([r["ms"] for r in warm_off])),
                 "remat": float(np.median([r["ms"] for r in warm_on]))}
    out["ms_runs"] = {"no_remat": [r["ms"] for r in off],
                      "remat": [r["ms"] for r in on]}
    out["peak_memory_bytes"] = {"no_remat": max(r["peak"] for r in off),
                                "remat": max(r["peak"] for r in on)}
    if failures:
        raise AssertionError(f"{what}: remat errors out of bounds: "
                             + " | ".join(failures))
    return out
