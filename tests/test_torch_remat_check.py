"""`tools.remat_check.check_remat`, the hold of chip_smoke.py phase 10, on
synthetic runs in turns (no remat, remat, no remat, remat): the loss terms
bit-equal, every gradient leaf and every quiet update leaf near its floor,
and the noise leaves (update floor above NOISE_LEAF) held by the quantile
of their error over floor against the same statistic between runs of one
mode. One noise leaf at 7x its floor with the medians at the floor (what
PR 11's final call read once by chance) passes; every noise leaf moved
10x fails, as does a gradient leaf moved past its floor.
"""
import pytest
import torch

from semi_detr_tpu_torch.tools import remat_check
from semi_detr_tpu_torch.tools.remat_check import check_remat

N_NOISE, N_QUIET, SIZE = 190, 40, 256


def _runs(seed, shift=None):
    """Four runs in turns. Each leaf is its base plus noise of a fixed size
    per leaf, redrawn per run (noise leaves at 1e-2 of the base, over
    NOISE_LEAF; quiet ones and gradients at 1e-6): the floor. `shift`
    ({leaf: factor}) moves both remat runs of a leaf by one fixed
    direction of factor times its noise, so its error against the runs
    without remat is about that factor times its floor."""
    g = torch.Generator().manual_seed(seed)
    leaves = {f"noise{i}": ("update", 1e-2) for i in range(N_NOISE)}
    leaves.update({f"quiet{i}": ("update", 1e-6) for i in range(N_QUIET)})
    leaves.update({f"g{i}": ("grad", 1e-6) for i in range(30)})
    base = {k: torch.randn(SIZE, generator=g) for k in leaves}
    moved = {k: torch.randn(SIZE, generator=g) for k in leaves}
    runs = []
    for r in range(4):
        remat = bool(r % 2)
        run = dict(remat=remat, losses={"loss": 1.25}, launches=(48, 24),
                   ms=100.0 + r, peak=2 ** 30, update={}, grad={})
        for k, (key, rel) in leaves.items():
            size = rel * base[k].norm() / SIZE ** 0.5
            v = base[k] + size * torch.randn(SIZE, generator=g)
            if remat and shift and k in shift:
                v = v + shift[k] * size * moved[k]
            run[key][k] = v
        runs.append(run)
    return runs


def test_noise_leaves_at_their_floor_pass():
    out = check_remat(_runs(0), "synthetic")
    n = out["update"]["noise"]
    assert out["update"]["noise_leaves"] == N_NOISE
    assert n["ratio_median"] < remat_check.REMAT_FACTOR
    assert n["ratio_quantile"] <= n["limit"]


def test_one_noise_leaf_at_seven_times_its_floor_passes():
    out = check_remat(_runs(1, shift={"noise7": 7.0}), "synthetic")
    n = out["update"]["noise"]
    assert n["worst_leaf"] == "noise7" and n["ratio_max"] > 4.0
    assert n["ratio_median"] < 2.0


def test_every_noise_leaf_moved_tenfold_fails():
    shift = {f"noise{i}": 10.0 for i in range(N_NOISE)}
    with pytest.raises(AssertionError, match="update"):
        check_remat(_runs(2, shift=shift), "synthetic")


def test_a_gradient_leaf_past_its_floor_fails():
    with pytest.raises(AssertionError, match="grad"):
        check_remat(_runs(3, shift={"g4": 1e5}), "synthetic")


def test_loss_terms_must_be_bit_equal():
    runs = _runs(4)
    runs[1]["losses"] = {"loss": 1.25 + 1e-7}
    with pytest.raises(AssertionError, match="loss terms"):
        check_remat(runs, "synthetic")
