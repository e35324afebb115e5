"""The SSOD steps of `tests/test_torch_ssod_step.py` laid out: FSDP (2
ranks), TP (tp 2 on 2 ranks, data 1) and FSDP + TP (2 x 2 ranks).

The trajectory they start from (`run`) and the data-parallel legs they are
held to (`ranks`) are built once per test run and shared with
`tests/test_torch_ssod_step.py` and `tests/test_torch_ssod_step_ranks.py`.
"""
import numpy as np
import pytest
import torch

from semi_detr_tpu_torch.data.pipeline import to_device

import torch_dist_workers as workers
from test_torch_ssod_step import CASES, CFG, SSOD_KW, _batch
from test_torch_ssod_step import run  # noqa: F401 (the fixture)
from test_torch_ssod_step_ranks import (RTOL_ONE_PROCESS, WITNESS_FACTOR,
                                        _close, _grad_norm_matches_jax,
                                        _losses_match_jax,
                                        _sets_and_gmm_match_jax,
                                        _updates_and_teacher_match_jax)
from test_torch_ssod_step_ranks import ranks  # noqa: F401 (the fixture)
from test_torch_train_step import _rel_l2

# --------------------------------------------------------------------------
# the same steps laid out: FSDP (2 ranks), TP (tp 2 on 2 ranks, data 1)
# and FSDP + TP (2 x 2 ranks)
# --------------------------------------------------------------------------
# `parallel.sharding.shard_state` lays out the state the data-parallel legs
# start from; the step is the same. Held to the JAX step on the global
# batch, to the port's one-process step and to its data-parallel ranks by
# the data-parallel legs' bounds. The TP ranks of one model group see the
# same data; the kept sets concatenate over the data ranks.
LAYOUTS = {"fsdp": ({"fsdp": True, "tp": 1}, 2),
           "tp": ({"fsdp": False, "tp": 2}, 2),
           "fsdp_tp": ({"fsdp": True, "tp": 2}, 4)}


@pytest.fixture(scope="module")
def layouts(run, tmp_path_factory):
    """The steps of `run` on every layout, one spawn each, all taken before
    the first test compares a layout with the data-parallel legs (which
    test_torch_ssod_step_ranks.py builds meanwhile on another worker)."""
    cases = [{"state": run[c]["blob"], "warm_up": w, "score_thr": t,
              "noises": run[c]["noises"]} for c, (w, t) in CASES.items()]
    out = {}
    for name, (layout, world) in LAYOUTS.items():
        spec = {"cfg": CFG, "ssod_kw": SSOD_KW, "cases": cases,
                "batch": to_device(_batch(), "cpu"), "layout": layout}
        got = workers.spawn(tmp_path_factory.mktemp(name), "ssod", spec,
                            world=world)
        out[name] = {"name": name, "world": world,
                     "ranks": [dict(zip(CASES, r)) for r in got]}
    return out


@pytest.fixture(scope="module", params=list(LAYOUTS))
def laid_out(request, layouts):
    """The steps of `run` on one layout."""
    return layouts[request.param]


def _data_cat(laid_out, case, key):
    """A set of the layout's ranks in global batch order: one rank per data
    rank."""
    by_data = {r[case]["data_rank"]: r[case] for r in laid_out["ranks"]}
    return np.concatenate([by_data[d]["sets"][key].numpy()
                           for d in sorted(by_data)])


@pytest.mark.parametrize("case", list(CASES))
def test_layout_ranks_agree_and_hold_their_shards(laid_out, case):
    recs = [r[case] for r in laid_out["ranks"]]
    layout, world = LAYOUTS[laid_out["name"]]
    data = world // layout["tp"]
    assert {r["data_world"] for r in recs} == {data}
    assert sorted(r["data_rank"] for r in recs) == sorted(
        list(range(data)) * layout["tp"])
    for r in recs:
        assert r["metrics"] == recs[0]["metrics"]
        assert r["replicated"]


@pytest.mark.parametrize("case", list(CASES))
def test_layout_equals_one_process_and_data_parallel(laid_out, ranks,
                                                     case):
    got = laid_out["ranks"][0][case]
    for ref in (ranks["one"][case], ranks["ranks"][0][case]):
        total = ref["metrics"]["total_loss"]
        assert got["metrics"].keys() == ref["metrics"].keys()
        for k, b in ref["metrics"].items():
            if "loss" in k and k != "total_loss":
                assert abs(got["metrics"][k] - b) <= (
                    RTOL_ONE_PROCESS * total), k
            else:
                assert _close(got["metrics"][k], b, RTOL_ONE_PROCESS), (k, b)
    ref = ranks["one"][case]
    for key in ("valid", "keep_sup", "keep_cons"):
        np.testing.assert_array_equal(_data_cat(laid_out, case, key),
                                      ref["sets"][key].numpy(), err_msg=key)
    flat = [torch.cat([g.flatten() for g in r["grads"].values()]).numpy()
            for r in (got, ref, ranks["witness"][case])]
    witness = _rel_l2(flat[2], flat[1])
    assert _rel_l2(flat[0], flat[1]) <= (RTOL_ONE_PROCESS
                                         + WITNESS_FACTOR * witness)


@pytest.mark.parametrize("case", list(CASES))
def test_layout_matches_jax(run, laid_out, case):
    """The data-parallel legs' JAX checks on the layout's rank 0: losses,
    kept sets and the GMM's element, grad_norm, updates and teacher."""
    r = laid_out["ranks"][0][case]
    _losses_match_jax(run, case, r["metrics"])
    _sets_and_gmm_match_jax(run, case, r["metrics"],
                            lambda key: _data_cat(laid_out, case, key))
    _grad_norm_matches_jax(run, case, r)
    _updates_and_teacher_match_jax(run, case, r, laid_out["ranks"][0])
