"""The port's SSOD train step against the JAX package's
`make_ssod_train_step`, jitted and unchanged.

Tiny DINO of tests/test_multidevice_and_e2e.py (d_model 64, 2 heads, 1+2
layers, 24 queries, 7 classes, CDN budget 16, max_gt 8; max_pseudo 4, 2
consistency groups, NMS 16 of 32 candidates), float32. Weights are random,
drawn with numpy in the reference layout and carried into both packages
(the detector by `test_torch_detector.build_pair`, the projector by the
JAX converter and `projector_state_dict_from_jax`). The batch is 2
supervised + 2 unlabeled 64x64 images; the student view is the teacher
view flipped, with the flip's matrix, so the cross-view transform does
real work. Both packages build their CDN blocks from the same draws of the
JAX step's keys (`test_torch_dn.jax_noise`).

Two cases run in one module-scoped trajectory: a warm-up step from the
initial state, then a Hungarian step from the JAX package's result, carried
into the port with its Adam moments (`_carry`), so both start that step
from one state, and the projector's zero-gradient update after the warm-up
is compared too.
The random weights score pseudo boxes at 0.85-0.95, so at the recipe's
0.4 every pseudo box supervises (the Hungarian case); the warm-up case
runs at 0.91, where one image keeps a supervision box and the other keeps
nothing at all and receives the fake consistency RoI.

The JAX step returns no per-image sets, so the JAX side's pseudo labels,
costs, GMM threshold and kept sets are derived again from the JAX
package's functions under the step's teacher and student weights, and
held to the step's own counts and threshold.

The same two steps then run on 2 gloo ranks of 1 + 1 images from the
state each started from (`ranks`, `torch_dist_workers`), held to the JAX
step on the global batch and to the port's one-process step, and laid out
by FSDP, TP and FSDP + TP (`laid_out`; the blocks at the end of this file).

Bounds: losses 1e-4 relative (as the supervised test); the counts and the
kept sets equal; the GMM picks the same pool element, and gmm_thr within
1e-4 relative, the bound of the JAX step against its own re-derived sets
(two XLA compiles of one cost differ by up to 1.0e-5); grad_norm 1e-3
relative; updates and the EMA teacher under
tests/test_torch_train_step.py's UPDATE bounds, leaves whose gradient is
below 1e-6 of their module's gradient norm (float noise around a true
zero) left out of the relative bounds.
"""
import copy

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_detr_tpu.models import ssod as jssod
from semi_detr_tpu.models.dino_head import DinoConfig as JaxDinoConfig
from semi_detr_tpu.models.dino_head import DINODetector as JaxDetector
from semi_detr_tpu.ops.gmm import fit_gmm_threshold as jax_gmm
from semi_detr_tpu.train import optim as joptim
from semi_detr_tpu.train.ssod import make_ssod_train_step as jax_ssod_step
from semi_detr_tpu.train.state import TrainState as JaxTrainState
from semi_detr_tpu.train.state import ema_update as jax_ema_update
from semi_detr_tpu.utils.torch_weights import (convert_dino_detector,
                                               convert_projector)
from semi_detr_tpu_torch.data.pipeline import synthetic_ssod_batch, to_device
from semi_detr_tpu_torch.models.ssod import Projector, SsodConfig
from semi_detr_tpu_torch.models.dino_head import DinoConfig
from semi_detr_tpu_torch.train import optim
from semi_detr_tpu_torch.train.ssod import make_ssod_train_step
from semi_detr_tpu_torch.train.state import TrainState
from semi_detr_tpu_torch.utils.torch_weights import (
    projector_state_dict_from_jax, ssod_state_dicts_from_jax)

import torch_dist_workers as workers
from test_torch_detector import build_pair
from test_torch_dn import jax_noise
from test_torch_ssod_components import _reference_projector_sd
from test_torch_train_step import (UPDATE_ABS, UPDATE_MEDIAN, UPDATE_WORST,
                                   _leaves, _rel_l2)

CFG = dict(num_classes=7, num_queries=24, d_model=64, n_heads=2,
           num_encoder_layers=1, num_decoder_layers=2, d_ffn=64,
           dn_single_pad=4, dn_groups=2, max_gt=8)
SSOD_KW = dict(max_pseudo=4, cons_groups=2, nms_max_out=16, nms_pre_topk=32)
K, CAP, N_UN = CFG["num_classes"], 16, 2
CASES = {"warm_up": (True, 0.91), "hungarian": (False, 0.4)}
NEGLIGIBLE = 1e-6


def _batch():
    b = synthetic_ssod_batch(2, N_UN, 64, 64, CFG["max_gt"], gt_per_image=3,
                             seed=3, student_flip=True)
    b["sup"]["gt"]["labels"] %= K
    return b


def _tree(batch, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in batch.items()}


def _noises(rng, step):
    """The JAX step's three CDN keys (train/ssod.py:272-273, :77)."""
    rng_sup, rng_unsup = jax.random.split(jax.random.fold_in(rng, step))
    rng_dn1, rng_dn2 = jax.random.split(rng_unsup)
    return [jax_noise(rng_sup, 2, CAP, K), jax_noise(rng_dn1, N_UN, CAP, K),
            jax_noise(rng_dn2, N_UN, CAP, K)]


def _port_tree(model, projector, what):
    """Parameters ("param") or gradients ("grad") in the JAX layout."""
    def sd_of(m, prefix=""):
        out = {}
        for k, v in m.state_dict(keep_vars=True).items():
            t = v.grad if what == "grad" and isinstance(
                v, torch.nn.Parameter) else v
            out[prefix + k] = (np.zeros(v.shape, np.float32) if t is None
                               else t.detach().float().numpy().copy())
        return out
    det = convert_dino_detector(sd_of(model), n_heads=CFG["n_heads"])
    tree = {"detector": det["params"]}
    if projector is not None:
        tree["projector"] = convert_projector(sd_of(projector, "projector."))
    return tree


def _jax_sets(jdet, student, teacher, batch_stats, jb, cfg):
    """The JAX package's pseudo labels, GMM threshold and kept sets of one
    step, from its functions under the step's teacher and student."""
    fwd = jax.jit(jdet.apply)
    un = jb["unsup"]
    t = fwd({"params": teacher, "batch_stats": batch_stats},
            un["teacher_images"], un["teacher_hw"])
    pl = jssod.decode_pseudo_labels(t["cls"][-1], t["coord"][-1],
                                    un["teacher_hw"], cfg)
    pl = jssod.transform_pseudo_to_student(pl, un["teacher_tmat"],
                                           un["student_tmat"],
                                           un["student_hw"])
    norm = jssod.normalize_boxes(pl.boxes_s, un["student_hw"])
    s = fwd({"params": student, "batch_stats": batch_stats},
            un["student_images"], un["student_hw"])
    costs = jssod.pseudo_matching_costs(s["cls"][-1], s["coord"][-1], norm,
                                        pl.labels, pl.valid)
    thr = jax_gmm(costs.reshape(-1), pl.valid.reshape(-1))
    keep_sup, keep_cons = jssod.dual_filter(costs, pl.scores, pl.valid, thr,
                                            cfg.score_thr)
    return {"valid": np.asarray(pl.valid), "keep_sup": np.asarray(keep_sup),
            "keep_cons": np.asarray(keep_cons), "costs": np.asarray(costs),
            "gmm_thr": float(thr)}


def _state_copy(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _carry(jstate, state):
    """The JAX state into the port's: student, teacher, projector and the
    Adam moments, so the next step starts from one state on both sides."""
    n_dec = CFG["num_decoder_layers"]
    masked = optax.MaskedNode

    def is_masked(x):
        return isinstance(x, masked)

    adam = [jstate.opt_state[2].inner_states[g].inner_state[0]
            for g in ("head", "backbone")]
    moments = {}
    for field in ("mu", "nu"):
        tree = jax.tree.map(lambda a, b: b if is_masked(a) else a,
                            *[getattr(s, field) for s in adam],
                            is_leaf=is_masked)
        tree = jax.tree.map(
            lambda m, p: np.zeros(p.shape, np.float32) if is_masked(m)
            else np.asarray(m), tree, jstate.params, is_leaf=is_masked)
        moments[field] = ssod_state_dicts_from_jax(
            tree, jstate.batch_stats, tree["detector"], n_dec)
    sds = ssod_state_dicts_from_jax(jstate.params, jstate.batch_stats,
                                    jstate.teacher_params, n_dec)
    with torch.no_grad():
        state.model.load_state_dict(sds["student"])
        state.teacher.load_state_dict(sds["teacher"])
        state.projector.load_state_dict(sds["projector"])
    count = {int(s.count) for s in adam}
    assert count == {int(jstate.step)} == {state.step}
    adamw = state.optimizer.adamw
    for key, module in (("student", state.model),
                        ("projector", state.projector)):
        for name, p in module.named_parameters():
            if key == "projector" or optim.param_group(name) != "frozen":
                adamw.state[p] = {
                    "step": torch.tensor(float(state.step)),
                    "exp_avg": moments["mu"][key][name].clone(),
                    "exp_avg_sq": moments["nu"][key][name].clone()}


@pytest.fixture(scope="module")
def run():
    jdet, jvars, port = build_pair(seed=2, cfg_kw=CFG)
    jproj = convert_projector(_reference_projector_sd(CFG["d_model"], 2))
    params = {"detector": jvars["params"], "projector": jproj}
    tx = joptim.make_optimizer(params)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jvars["batch_stats"],
        teacher_params=jax.tree.map(jnp.copy, jvars["params"]),
        opt_state=tx.init(params))
    batch = _batch()
    jb = _tree(batch, jnp.asarray)
    tb = to_device(batch, "cpu")
    rng = jax.random.PRNGKey(7)

    port.train()
    projector = Projector(CFG["d_model"])
    projector.load_state_dict(projector_state_dict_from_jax(jproj))
    opt = optim.make_optimizer(port, head_modules=(projector,))
    frozen = [p for n, p in port.named_parameters()
              if optim.param_group(n) == "frozen"]
    for p in frozen:            # gradients only for grad_norm's frozen part
        p.requires_grad_(True)
    state = TrainState.create(port, opt, projector=projector)

    out = {}
    for step, (case, (warm_up, thr)) in enumerate(CASES.items()):
        if step:
            _carry(jstate, state)
        # the step's start, for the same step on 2 ranks (`ranks`)
        blob = {"step": state.step, "student": _state_copy(port),
                "teacher": _state_copy(state.teacher),
                "projector": _state_copy(projector),
                "optimizer": copy.deepcopy(state.optimizer.adamw.state_dict())}
        noises = _noises(rng, step)
        jcfg = jssod.SsodConfig(dino=JaxDinoConfig(**CFG), score_thr=thr,
                                **SSOD_KW)
        pcfg = SsodConfig(dino=DinoConfig(**CFG), score_thr=thr, **SSOD_KW)
        teacher = jax_ema_update(jstate.teacher_params,
                                 jstate.params["detector"], jstate.step,
                                 jcfg.ema_momentum)
        jsets = _jax_sets(jdet, jstate.params["detector"], teacher,
                          jstate.batch_stats, jb, jcfg)
        before = {"jax": jstate.params, "port": _port_tree(port, projector,
                                                           "param")}
        step_fn = jax_ssod_step(jdet, jssod.Projector(CFG["d_model"]), tx,
                                jcfg, warm_up)
        jstate, jm = step_fn(jstate, jb, rng)
        for p in frozen:
            p.grad = None
        pm = make_ssod_train_step(pcfg, warm_up)(state, tb, noises=noises)
        frozen_sq = sum(float((p.grad.double() ** 2).sum()) for p in frozen)
        out[case] = dict(
            blob=blob, noises=[list(n) for n in noises],
            warm_up=warm_up, jm=jm, pm=pm, jsets=jsets, before=before,
            frozen_sq=frozen_sq,
            after={"jax": jstate.params,
                   "port": _port_tree(port, projector, "param")},
            grads=_port_tree(port, projector, "grad"),
            teacher={"jax": jstate.teacher_params,
                     "port": _port_tree(state.teacher, None,
                                        "param")["detector"]})
    assert state.step == 2 and int(jstate.step) == 2
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_losses_match_jax(run, case):
    r = run[case]
    jm, pm = r["jm"], r["pm"]
    keys = {k for k in jm if "loss" in k}
    assert keys == {k for k in pm if "loss" in k}
    assert any(k.startswith("unsup_consis_loss") for k in keys) == r[
        "warm_up"]
    for k in sorted(keys):
        a, b = float(pm[k]), float(jm[k])
        assert abs(a - b) <= 1e-4 * max(abs(b), 1e-6), (k, a, b)
    assert float(pm["ema_momentum"]) == float(jm["ema_momentum"])


@pytest.mark.parametrize("case", list(CASES))
def test_pseudo_sets_and_gmm_match_jax(run, case):
    r = run[case]
    jm, pm, js = r["jm"], r["pm"], r["jsets"]
    # the re-derived JAX sets are the JAX step's own; its threshold, a cost
    # of the pool, up to the float32 noise of a separately compiled forward
    assert abs(float(jm["gmm_thr"]) - js["gmm_thr"]) <= 1e-4 * abs(
        js["gmm_thr"])
    for key, mask in (("pseudo_per_img", "valid"),
                      ("sup_set_per_img", "keep_sup"),
                      ("cons_set_per_img", "keep_cons")):
        assert float(jm[key]) == js[mask].sum() / N_UN, key
        assert float(pm[key]) == float(jm[key]), key
        np.testing.assert_array_equal(pm["pseudo_sets"][mask].numpy(),
                                      js[mask], err_msg=mask)
    np.testing.assert_array_equal(pm["pseudo_vis"]["keep"].numpy(),
                                  np.asarray(jm["pseudo_vis"]["keep"]))
    # the threshold is a cost of the pool: both packages pick the same
    # pseudo box, and its cost agrees as the JAX step with its own sets
    valid = js["valid"].reshape(-1)

    def picked(pool, thr):
        return np.flatnonzero(valid & (pool.reshape(-1) == np.float32(thr)))

    got = picked(pm["pseudo_sets"]["costs"].numpy(), float(pm["gmm_thr"]))
    ref = picked(js["costs"], js["gmm_thr"])
    assert ref.size == 1 and list(got) == list(ref), (got, ref)
    a, b = float(pm["gmm_thr"]), float(jm["gmm_thr"])
    assert abs(a - b) <= 1e-4 * abs(b), (a, b)


def test_cases_exercise_every_branch(run):
    """A non-empty supervision set (an unlabeled CDN from real pseudo
    boxes) in both cases; in the warm-up a non-empty consistency set and an
    image that keeps nothing and gets the fake RoI."""
    for case in CASES:
        js = run[case]["jsets"]
        assert js["keep_sup"].any(), case
        assert js["keep_cons"].any(), case
    js = run["warm_up"]["jsets"]
    assert (~js["keep_cons"].any(1)).any()
    assert not js["keep_sup"].all()


@pytest.mark.parametrize("case", list(CASES))
def test_grad_norm_matches_jax(run, case):
    """The JAX step's grad_norm counts the frozen leaves too."""
    r = run[case]
    got = np.sqrt(float(r["pm"]["grad_norm"]) ** 2 + r["frozen_sq"])
    ref = float(r["jm"]["grad_norm"])
    assert abs(got - ref) <= 1e-3 * ref, (got, ref)


def _negligible(grads):
    """Trainable leaves whose gradient is float noise around a true zero:
    below NEGLIGIBLE of their module's (detector's or projector's)
    gradient norm. The projector's whole gradient is ~1e-4 of the
    detector's, so one global norm would hide it."""
    out = set()
    for module, tree in grads.items():
        leaves = {f"{module}/{p}": g for p, g in _leaves(tree).items()
                  if not joptim.is_frozen(f"{module}/{p}")}
        gnorm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                            for g in leaves.values()))
        out |= {p for p, g in leaves.items()
                if np.linalg.norm(g) < NEGLIGIBLE * gnorm}
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_updates_match_jax(run, case):
    r = run[case]
    before = {k: _leaves(v) for k, v in r["before"].items()}
    after = {k: _leaves(v) for k, v in r["after"].items()}
    # a leaf's update is noise only where every gradient so far was
    skip = set.intersection(*[_negligible(run[c]["grads"]) for c in CASES
                              if c in (case, "warm_up")])
    upd, moved = {}, set()
    for path, p0 in before["jax"].items():
        du = after["port"][path] - before["port"][path]
        dr = after["jax"][path] - p0
        if joptim.is_frozen(path):
            assert not du.any() and not dr.any(), path
            continue
        assert np.abs(du - dr).max() <= UPDATE_ABS, path
        if du.any():
            moved.add(path.split("/")[0])
        if path not in skip:
            upd[path] = _rel_l2(du, dr)
    # the projector moves in both cases: after the warm-up only by Adam's
    # momentum and the weight decay, on a zero gradient
    assert moved == {"detector", "projector"}
    grads = _leaves(r["grads"])
    proj = [p for p in grads if p.startswith("projector/")]
    assert any(grads[p].any() for p in proj) == r["warm_up"]
    # fc1's bias feeds a batch norm: its true gradient is 0
    assert {p for p in proj if p not in upd} <= {"projector/fc1/bias"}
    assert len(upd) > 100
    worst = max(upd, key=upd.get)
    assert upd[worst] <= UPDATE_WORST, (worst, upd[worst])
    assert float(np.median(list(upd.values()))) <= UPDATE_MEDIAN


@pytest.mark.parametrize("case", list(CASES))
def test_ema_teacher_matches_jax(run, case):
    r = run[case]
    got, ref = _leaves(r["teacher"]["port"]), _leaves(r["teacher"]["jax"])
    assert sorted(got) == sorted(ref)
    for path in ref:
        np.testing.assert_allclose(got[path], ref[path], rtol=0,
                                   atol=UPDATE_ABS, err_msg=path)


TINY_OPTIONS = {
    "model.d_model": 64, "model.n_heads": 2, "model.num_encoder_layers": 1,
    "model.num_decoder_layers": 2, "model.d_ffn": 64,
    "model.num_queries": 24, "model.dn_single_pad": 4, "model.dn_groups": 2,
    "model.max_gt": 8, "ssod.max_pseudo": 4, "ssod.cons_groups": 2,
    "model.dtype": "float32"}
SSOD_CONFIG = "configs/detr_ssod/semi_detr_r50_coco_120k.py"


# --------------------------------------------------------------------------
# the same steps on 2 gloo ranks (data parallel)
# --------------------------------------------------------------------------
# Each rank takes 1 + 1 images of the batch above and its rows of the same
# CDN draws, from the state each step above started from. In the warm-up
# one unlabeled image keeps a supervision box and the other keeps none, so
# the ranks differ: the CDN partition's size, the consistency group size,
# the loss denominators, the Projector's batch statistics and the GMM pool
# span the ranks. A third case runs the warm-up step with the step's own
# (seed, step) draw: the ranks must take their rows of the global draw,
# not draw again. Bounds against the JAX step: this file's; against the
# port's one-process step: equal kept sets; total_loss, grad_norm, gmm_thr
# and the per-image counts within 1e-5 relative; each loss term within
# 1e-5 of the total loss (a small term near cancellation, an iou loss of
# 1 - giou near giou = 1, read 9e-5 relative on a term of 1.7e-4 while the
# total moved by 1e-7: the ranks' kernels see batches of 1, with other
# rounding); the whole gradient within 1e-5 relative plus WITNESS_FACTOR
# times what one float32 rounding of the images moves it by in one
# process (the ranks' read 1.4e-5 and 1.7e-5 in the warm-up cases). The
# ranks' parameters after each step are equal to the bit.
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
    code (with the seeded case and the rounding witness)."""
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


@pytest.fixture(scope="module", params=list(LAYOUTS))
def laid_out(request, run, tmp_path_factory):
    """The steps of `run` on one layout: one spawn per layout."""
    layout, world = LAYOUTS[request.param]
    cases = [{"state": run[c]["blob"], "warm_up": w, "score_thr": t,
              "noises": run[c]["noises"]} for c, (w, t) in CASES.items()]
    spec = {"cfg": CFG, "ssod_kw": SSOD_KW, "cases": cases,
            "batch": to_device(_batch(), "cpu"), "layout": layout}
    got = workers.spawn(tmp_path_factory.mktemp(request.param), "ssod",
                        spec, world=world)
    return {"name": request.param, "world": world,
            "ranks": [dict(zip(CASES, r)) for r in got]}


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
def test_layout_equals_one_process_and_data_parallel(ranks, laid_out,
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
