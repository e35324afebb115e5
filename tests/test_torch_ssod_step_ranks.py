"""The SSOD steps of `tests/test_torch_ssod_step.py` on 2 gloo ranks of
1 + 1 images (data parallel), from the state each step there started
from: held to the JAX step on the global batch and to the port's
one-process step.

The one-process file's trajectory (`run`: both packages' two steps) is
built once per test run and shared between the files; so is this file's
`ranks`, which `tests/test_torch_ssod_step_layouts.py` compares with.
"""
import numpy as np
import pytest
import torch

from semi_detr_tpu.train import optim as joptim
from semi_detr_tpu.utils.torch_weights import (convert_dino_detector,
                                               convert_projector)
from semi_detr_tpu_torch.data.pipeline import to_device

import torch_dist_workers as workers
from shared_result import shared
from test_torch_ssod_step import (CASES, CFG, SSOD_KW, _batch, _negligible,
                                  run)  # noqa: F401 (the fixture)
from test_torch_train_step import (UPDATE_ABS, UPDATE_MEDIAN, UPDATE_WORST,
                                   _leaves, _rel_l2)

# --------------------------------------------------------------------------
# Each rank takes 1 + 1 images of the batch of test_torch_ssod_step.py and
# its rows of the same CDN draws, from the state each step there started
# from. In the warm-up one unlabeled image keeps a supervision box and the
# other keeps none, so the ranks differ: the CDN partition's size, the
# consistency group size, the loss denominators, the Projector's batch
# statistics and the GMM pool span the ranks. A third case runs the warm-
# up step with the step's own (seed, step) draw: the ranks must take their
# rows of the global draw, not draw again. Bounds against the JAX step:
# test_torch_ssod_step.py's; against the port's one-process step: equal
# kept sets; total_loss, grad_norm, gmm_thr and the per-image counts
# within 1e-5 relative; each loss term within 1e-5 of the total loss (a
# small term near cancellation, an iou loss of 1 - giou near giou = 1,
# read 9e-5 relative on a term of 1.7e-4 while the total moved by 1e-7:
# the ranks' kernels see batches of 1, with other rounding); the whole
# gradient within 1e-5 relative plus WITNESS_FACTOR times what one float32
# rounding of the images moves it by in one process (the ranks' read
# 1.4e-5 and 1.7e-5 in the warm-up cases). The ranks' parameters after
# each step are equal to the bit.
SEEDED = "warm_up_seeded"
RTOL_ONE_PROCESS, WITNESS_FACTOR = 1e-5, 4.0


def _nudged(batch):
    """Every image value moved by one float32 rounding."""
    out = {k: dict(v) for k, v in batch.items()}
    for part, key in (("sup", "images"), ("unsup", "student_images"),
                      ("unsup", "teacher_images")):
        x = out[part][key]
        out[part][key] = torch.nextafter(x, torch.full_like(x, 1e30))
    return out


@pytest.fixture(scope="module")
def ranks(run, tmp_path_factory):
    """The steps of `run` on 2 ranks, and in one process through the same
    code (with the seeded case and the rounding witness); once per test
    run."""
    return shared(tmp_path_factory, "ssod_step_ranks",
                  lambda: _ranks(run, tmp_path_factory), users=2)


def _ranks(run, tmp_path_factory):
    cases = [{"state": run[c]["blob"], "warm_up": w, "score_thr": t,
              "noises": run[c]["noises"]} for c, (w, t) in CASES.items()]
    cases.append(dict(cases[0], noises=None))
    spec = {"cfg": CFG, "ssod_kw": SSOD_KW, "cases": cases,
            "batch": to_device(_batch(), "cpu")}
    names = list(CASES) + [SEEDED]
    one = dict(zip(names, workers.run_ssod_cases(spec)))
    witness = dict(zip(names, workers.run_ssod_cases(
        dict(spec, batch=_nudged(spec["batch"]), cases=cases[:2]))))
    got = workers.spawn(tmp_path_factory.mktemp("ssod"), "ssod", spec)
    return {"one": one, "witness": witness,
            "ranks": [dict(zip(names, r)) for r in got]}


def _rank_cat(ranks, case, key):
    return np.concatenate([r[case]["sets"][key].numpy()
                           for r in ranks["ranks"]])


def _close(a, b, rtol):
    return abs(a - b) <= rtol * max(abs(b), 1e-6)


def _jax_layout(student, projector=None):
    np_sd = {k: v.float().numpy() for k, v in student.items()}
    tree = {"detector": convert_dino_detector(
        np_sd, n_heads=CFG["n_heads"])["params"]}
    if projector is not None:
        tree["projector"] = convert_projector(
            {f"projector.{k}": v.float().numpy()
             for k, v in projector.items()})
    return tree


def _grad_tree(r):
    """A rank's gradients in the JAX layout (buffers as zeros)."""
    student = {k: r["grads"].get(k, torch.zeros_like(v))
               for k, v in r["student"].items()}
    return _jax_layout(student, {k[len("projector."):]: v
                                 for k, v in r["grads"].items()
                                 if k.startswith("projector.")})


@pytest.mark.parametrize("case", list(CASES) + [SEEDED])
def test_two_ranks_agree_and_stay_replicated(ranks, case):
    r0, r1 = (r[case] for r in ranks["ranks"])
    assert r0["metrics"] == r1["metrics"]
    assert r0["frozen_sq"] == r1["frozen_sq"]
    assert r0["replicated"] and r1["replicated"]
    # the ranks see different images: their kept sets differ in the warm-up
    if case == "warm_up":
        kept = [r[case]["sets"]["keep_sup"].any().item()
                for r in ranks["ranks"]]
        assert sorted(kept) == [False, True]


@pytest.mark.parametrize("case", list(CASES) + [SEEDED])
def test_two_ranks_equal_one_process(ranks, case):
    got, ref = ranks["ranks"][0][case], ranks["one"][case]
    assert got["metrics"].keys() == ref["metrics"].keys()
    total = ref["metrics"]["total_loss"]
    for k, b in ref["metrics"].items():
        if "loss" in k and k != "total_loss":
            assert abs(got["metrics"][k] - b) <= RTOL_ONE_PROCESS * total, k
        else:
            assert _close(got["metrics"][k], b, RTOL_ONE_PROCESS), (k, b)
    for key in ("valid", "keep_sup", "keep_cons"):
        np.testing.assert_array_equal(_rank_cat(ranks, case, key),
                                      ref["sets"][key].numpy(), err_msg=key)
    np.testing.assert_array_equal(got["vis_keep"], ref["vis_keep"])
    if case == SEEDED:             # the ranks return no tensors for it
        return
    flat = [torch.cat([g.flatten() for g in r["grads"].values()]).numpy()
            for r in (got, ref, ranks["witness"][case])]
    witness = _rel_l2(flat[2], flat[1])
    assert witness > 0
    assert _rel_l2(flat[0], flat[1]) <= (RTOL_ONE_PROCESS
                                         + WITNESS_FACTOR * witness)


def _losses_match_jax(run, case, pm):
    jm = run[case]["jm"]
    keys = {k for k in jm if "loss" in k}
    assert keys == {k for k in pm if "loss" in k}
    for k in sorted(keys):
        assert _close(pm[k], float(jm[k]), 1e-4), (k, pm[k], float(jm[k]))
    assert pm["ema_momentum"] == float(jm["ema_momentum"])


def _sets_and_gmm_match_jax(run, case, pm, cat):
    """`cat(key)`: the ranks' per-image sets in global batch order."""
    jm, js = run[case]["jm"], run[case]["jsets"]
    for key, mask in (("pseudo_per_img", "valid"),
                      ("sup_set_per_img", "keep_sup"),
                      ("cons_set_per_img", "keep_cons")):
        assert pm[key] == float(jm[key]), key
        np.testing.assert_array_equal(cat(mask), js[mask], err_msg=mask)
    # the threshold is a cost of the pool that spans both ranks: the same
    # pseudo box as the JAX step's
    valid = js["valid"].reshape(-1)
    costs = cat("costs").reshape(-1)
    got = np.flatnonzero(valid & (costs == np.float32(pm["gmm_thr"])))
    ref = np.flatnonzero(valid & (js["costs"].reshape(-1)
                                  == np.float32(js["gmm_thr"])))
    assert ref.size == 1 and list(got) == list(ref), (got, ref)
    assert _close(pm["gmm_thr"], float(jm["gmm_thr"]), 1e-4)


def _grad_norm_matches_jax(run, case, r):
    """The JAX step's grad_norm counts the frozen leaves too."""
    got = np.sqrt(r["metrics"]["grad_norm"] ** 2 + r["frozen_sq"])
    ref = float(run[case]["jm"]["grad_norm"])
    assert abs(got - ref) <= 1e-3 * ref, (got, ref)


def _updates_and_teacher_match_jax(run, case, r, records):
    """test_updates_match_jax and test_ema_teacher_matches_jax on one
    rank's state (`records`: that run's rank-0 records, by case)."""
    before = _leaves(run[case]["before"]["jax"])
    after = _leaves(_jax_layout(r["student"], r["projector"]))
    ref_after = _leaves(run[case]["after"]["jax"])
    skip = set.intersection(*[
        _negligible(_grad_tree(records[c])) for c in CASES
        if c in (case, "warm_up")])
    upd, moved = {}, set()
    for path, p0 in before.items():
        du, dr = after[path] - p0, ref_after[path] - p0
        if joptim.is_frozen(path):
            assert not du.any() and not dr.any(), path
            continue
        assert np.abs(du - dr).max() <= UPDATE_ABS, path
        if du.any():
            moved.add(path.split("/")[0])
        if path not in skip:
            upd[path] = _rel_l2(du, dr)
    assert moved == {"detector", "projector"}
    grads = _leaves(_grad_tree(r))
    proj = [p for p in grads if p.startswith("projector/")]
    assert any(grads[p].any() for p in proj) == CASES[case][0]
    assert {p for p in proj if p not in upd} <= {"projector/fc1/bias"}
    assert len(upd) > 100
    worst = max(upd, key=upd.get)
    assert upd[worst] <= UPDATE_WORST, (worst, upd[worst])
    assert float(np.median(list(upd.values()))) <= UPDATE_MEDIAN
    teacher = _leaves(_jax_layout(r["teacher"])["detector"])
    for path, ref in _leaves(run[case]["teacher"]["jax"]).items():
        np.testing.assert_allclose(teacher[path], ref, rtol=0,
                                   atol=UPDATE_ABS, err_msg=path)


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_losses_match_jax(run, ranks, case):
    _losses_match_jax(run, case, ranks["ranks"][0][case]["metrics"])


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_pseudo_sets_and_gmm_match_jax(run, ranks, case):
    _sets_and_gmm_match_jax(run, case, ranks["ranks"][0][case]["metrics"],
                            lambda key: _rank_cat(ranks, case, key))


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_grad_norm_matches_jax(run, ranks, case):
    """The JAX step's grad_norm counts the frozen leaves too."""
    _grad_norm_matches_jax(run, case, ranks["ranks"][0][case])


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_updates_and_teacher_match_jax(run, ranks, case):
    """test_updates_match_jax and test_ema_teacher_matches_jax on rank 0's
    state."""
    _updates_and_teacher_match_jax(run, case, ranks["ranks"][0][case],
                                   ranks["ranks"][0])
