"""The SSOD options no shipped config sets, turned on: `ema_decay_intervals`
/ `ema_decay_factor` (the reference MeanTeacher's decay schedule) and
`cls_avg_groups` (the reference's per-GPU cls avg factor).

* the EMA with decay intervals against the JAX `ema_momentum` /
  `ema_update`: the momentum equal in float32, the teacher within 1e-7;
* the grouped cls factor through the pseudo-label loss (the SSOD
  unlabeled branch, `is_pseudo_label=True`) against the JAX
  `detection_loss`, on batches whose size the group divides;
* the port's SSOD step hands each option to the functions that use them,
  as `semi_detr_tpu/train/ssod.py:197,270-271,305-306,329-330` does.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semi_detr_tpu.models.criterion import detection_loss as jax_loss
from semi_detr_tpu.train import state as jax_state
from semi_detr_tpu_torch.data.pipeline import synthetic_ssod_batch, to_device
from semi_detr_tpu_torch.models.criterion import detection_loss
from semi_detr_tpu_torch.train import ssod as port_ssod
from semi_detr_tpu_torch.train import state as port_state
from semi_detr_tpu_torch.train import supervised as port_supervised

from test_torch_criterion import K, RTOL, _case

INTERVALS, FACTOR = (2000, 2005), 0.9
TINY_SSOD = {"model.d_model": 32, "model.n_heads": 2,
             "model.num_encoder_layers": 1, "model.num_decoder_layers": 2,
             "model.d_ffn": 64, "model.num_queries": 24,
             "model.dn_single_pad": 4, "model.dn_groups": 2,
             "model.max_gt": 8, "model.dtype": "float32",
             "ssod.max_pseudo": 4, "ssod.cons_groups": 2}


@pytest.mark.parametrize("step", [0, 3, 2001, 2010, 2100])
def test_ema_with_decay_intervals_matches_jax(step):
    kw = dict(decay_intervals=INTERVALS, decay_factor=FACTOR)
    m = port_state.ema_momentum(step, 0.999, **kw)
    ref = jax_state.ema_momentum(jnp.asarray(step), 0.999, **kw)
    assert np.float32(m) == np.float32(ref)
    if step > INTERVALS[0]:                  # the schedule bites
        assert m != port_state.ema_momentum(step, 0.999)
    rs = np.random.RandomState(step)
    t, s = (rs.randn(3, 4).astype(np.float32) for _ in range(2))
    teacher, student = torch.nn.Linear(4, 3, bias=False), \
        torch.nn.Linear(4, 3, bias=False)
    with torch.no_grad():
        teacher.weight.copy_(torch.from_numpy(t))
        student.weight.copy_(torch.from_numpy(s))
    port_state.ema_update(teacher, student, step, 0.999, **kw)
    ref_t = jax_state.ema_update({"w": jnp.asarray(t)}, {"w": jnp.asarray(s)},
                                 jnp.asarray(step), 0.999, **kw)["w"]
    np.testing.assert_allclose(teacher.weight.detach().numpy(),
                               np.asarray(ref_t), rtol=0, atol=1e-7)


@pytest.mark.parametrize("warm_up", [False, True], ids=["hungarian", "o2m"])
@pytest.mark.parametrize("group", [1, 2])
def test_pseudo_label_loss_grouped_cls_factor_matches_jax(group, warm_up):
    j_out, j_gt, t_out, t_gt = _case((3, 0, 8, 5), seed=group)
    ref = jax_loss(j_out, j_gt, K, warm_up, is_pseudo_label=True,
                   cls_group=group)
    got = detection_loss(t_out, t_gt, K, warm_up, is_pseudo_label=True,
                         cls_group=group)
    plain = detection_loss(t_out, t_gt, K, warm_up, is_pseudo_label=True)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=RTOL,
                                   atol=1e-7, err_msg=k)
    # after the warm-up the grouped factor differs from the global one on
    # this batch; in the warm-up the pseudo-label loss has no factor it
    # acts on (task-aligned cls loss, CDN losses zeroed), as in JAX
    moved = any(float(got[k]) != float(plain[k]) for k in got if "cls" in k)
    assert moved != warm_up


def test_ssod_step_passes_the_options(monkeypatch):
    state, cfg = port_state.init_ssod_state(
        "configs/detr_ssod/semi_detr_r50_coco_120k.py", device="cpu",
        cfg_options=TINY_SSOD)
    cfg = dataclasses.replace(cfg, ema_decay_intervals=INTERVALS,
                              ema_decay_factor=FACTOR,
                              cls_avg_groups=(1, 2))
    seen = []

    def spy(real):
        def loss(*args, cls_group=None, **kw):
            seen.append(cls_group)
            return real(*args, cls_group=cls_group, **kw)
        return loss

    monkeypatch.setattr(port_ssod, "detection_loss",
                        spy(port_ssod.detection_loss))
    monkeypatch.setattr(port_supervised, "detection_loss",
                        spy(port_supervised.detection_loss))
    batch = to_device(synthetic_ssod_batch(1, 2, 64, 80, 8, 4, seed=1),
                      "cpu")
    state.step = 2010
    metrics = port_ssod.make_ssod_train_step(cfg, warm_up=False)(state,
                                                                 batch)
    assert seen == [1, 2]                 # supervised, then unlabeled
    want = port_state.ema_momentum(2010, cfg.ema_momentum,
                                   decay_intervals=INTERVALS,
                                   decay_factor=FACTOR)
    assert float(metrics["ema_momentum"]) == float(want)
    assert want != port_state.ema_momentum(2010, cfg.ema_momentum)
