"""The bf16 SSOD step's drift from the JAX package's over 20 steps.

tests/test_torch_bf16_decoder.py measures one bf16 layer: the port's gap
to the JAX bf16 model is about 1.5x the JAX package's own float32-vs-bf16
gap. This file measures what that gap does over a trajectory. On the
tiny SSOD setup of tests/test_torch_ssod_step.py (the same carried
weights, batch, CDN draws and score thresholds), three trajectories of 20
steps (10 warm-up, 10 Hungarian), each from the same initial state and
each on its own results:

* the JAX package's jitted `make_ssod_train_step` in bfloat16;
* the same in float32 (the control);
* the port's `make_ssod_train_step` in bfloat16.

Per step, the relative gap of total_loss to the JAX bf16 trajectory. The
port's mean gap must stay within LIMIT times the control's (the per-layer
test's bound), over the whole run and over each half (a gap that grows
with the steps shows in the second half).

Marked slow: four JAX compiles of the whole SSOD step (two stages, two
dtypes) and 60 steps on the CPU take several minutes. Run it with
`python -m pytest tests/test_torch_bf16_drift.py -m slow -s`; `-s` prints
the three trajectories and the gaps.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_detr_tpu.models import ssod as jssod
from semi_detr_tpu.models.dino_head import DinoConfig as JaxDinoConfig
from semi_detr_tpu.models.dino_head import DINODetector as JaxDetector
from semi_detr_tpu.train import optim as joptim
from semi_detr_tpu.train.ssod import make_ssod_train_step as jax_ssod_step
from semi_detr_tpu.train.state import TrainState as JaxTrainState
from semi_detr_tpu.utils.torch_weights import convert_projector
from semi_detr_tpu_torch.data.pipeline import to_device
from semi_detr_tpu_torch.models.dino_head import DinoConfig, DINODetector
from semi_detr_tpu_torch.models.ssod import Projector, SsodConfig
from semi_detr_tpu_torch.train import optim
from semi_detr_tpu_torch.train.ssod import make_ssod_train_step
from semi_detr_tpu_torch.train.state import TrainState
from semi_detr_tpu_torch.utils.torch_weights import \
    projector_state_dict_from_jax

from test_torch_detector import build_pair
from test_torch_ssod_components import _reference_projector_sd
from test_torch_ssod_step import CASES, CFG, SSOD_KW, _batch, _noises, _tree

STEPS, WARM_UP_STEPS = 20, 10
LIMIT = 2.0


def _threshold(step):
    return CASES["warm_up" if step < WARM_UP_STEPS else "hungarian"]


def _jax_trajectory(jvars, jproj, jb, rng, dtype):
    jdet = JaxDetector(JaxDinoConfig(**CFG, dtype=dtype))
    params = {"detector": jvars["params"], "projector": jproj}
    tx = joptim.make_optimizer(params)
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jvars["batch_stats"],
        teacher_params=jax.tree.map(jnp.copy, jvars["params"]),
        opt_state=tx.init(params))
    fns, out = {}, []
    for step in range(STEPS):
        warm_up, thr = _threshold(step)
        if warm_up not in fns:
            cfg = jssod.SsodConfig(dino=JaxDinoConfig(**CFG, dtype=dtype),
                                   score_thr=thr, **SSOD_KW)
            fns[warm_up] = jax_ssod_step(jdet, jssod.Projector(CFG["d_model"]),
                                         tx, cfg, warm_up)
        state, m = fns[warm_up](state, jb, rng)
        out.append(float(m["total_loss"]))
    return np.asarray(out)


def _port_trajectory(port, jproj, tb, rng):
    model = DINODetector(DinoConfig(**CFG, dtype="bfloat16"))
    model.load_state_dict(port.state_dict())
    model.train()
    projector = Projector(CFG["d_model"])
    projector.load_state_dict(projector_state_dict_from_jax(jproj))
    opt = optim.make_optimizer(model, head_modules=(projector,))
    state = TrainState.create(model, opt, projector=projector)
    fns, out = {}, []
    for step in range(STEPS):
        warm_up, thr = _threshold(step)
        if warm_up not in fns:
            cfg = SsodConfig(dino=DinoConfig(**CFG, dtype="bfloat16"),
                             score_thr=thr, **SSOD_KW)
            fns[warm_up] = make_ssod_train_step(cfg, warm_up)
        m = fns[warm_up](state, tb, noises=_noises(rng, step))
        out.append(float(m["total_loss"]))
    return np.asarray(out)


@pytest.mark.slow
def test_bf16_step_drift_stays_within_the_control():
    _, jvars, port = build_pair(seed=2, cfg_kw=CFG)
    jproj = convert_projector(_reference_projector_sd(CFG["d_model"], 2))
    batch = _batch()
    rng = jax.random.PRNGKey(7)
    jb = _tree(batch, jnp.asarray)
    with torch.no_grad():
        tb = to_device(batch, "cpu")
    jax_bf16 = _jax_trajectory(jvars, jproj, jb, rng, jnp.bfloat16)
    jax_f32 = _jax_trajectory(jvars, jproj, jb, rng, jnp.float32)
    port_bf16 = _port_trajectory(port, jproj, tb, rng)

    gap = np.abs(port_bf16 - jax_bf16) / np.abs(jax_bf16)
    control = np.abs(jax_f32 - jax_bf16) / np.abs(jax_bf16)
    np.set_printoptions(precision=6, linewidth=150)
    print("\ntotal_loss, JAX bf16:", jax_bf16)
    print("total_loss, JAX f32: ", jax_f32)
    print("total_loss, port bf16:", port_bf16)
    print("relative gap, port bf16 vs JAX bf16:", gap)
    print("relative gap, JAX f32 vs JAX bf16 (control):", control)
    halves = {"all": slice(None), "first": slice(0, STEPS // 2),
              "second": slice(STEPS // 2, None)}
    for name, part in halves.items():
        ratio = gap[part].mean() / control[part].mean()
        print(f"{name} steps: mean gap {gap[part].mean():.3e}, control "
              f"{control[part].mean():.3e}, ratio {ratio:.3f}")
        assert np.isfinite(port_bf16).all()
        assert ratio <= LIMIT, (name, ratio)
