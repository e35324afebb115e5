"""The port's SSOD state and step on their own, on the CPU:
`init_ssod_state`'s parameter groups and the projector's zero-gradient
update, and the step's default CDN noise seeded by (seed, step).

These need none of tests/test_torch_ssod_step.py's JAX trajectories, and
sit in a file of their own so that a parallel run (one file per worker)
gives them to another worker than that file's long fixtures.
"""
import numpy as np
import torch

from semi_detr_tpu_torch.data.pipeline import to_device
from semi_detr_tpu_torch.train import optim
from semi_detr_tpu_torch.train.ssod import make_ssod_train_step

from test_torch_ssod_step import SSOD_CONFIG, TINY_OPTIONS, _batch


def test_init_ssod_state_groups_and_zero_gradient_update():
    """init_ssod_state: the recipe's SsodConfig, the teacher a copy of the
    detector only, the projector in the head group while the detector's
    rules still see the detector's names; a projector without a gradient
    still gets AdamW's weight decay, as optax gives it."""
    from semi_detr_tpu_torch.train.state import init_ssod_state
    state, cfg = init_ssod_state(SSOD_CONFIG, device="cpu", seed=1,
                                 cfg_options=TINY_OPTIONS)
    assert (cfg.max_pseudo, cfg.cons_groups, cfg.score_thr,
            cfg.unsup_weight) == (4, 2, 0.4, 4.0)
    assert cfg.dino is state.model.cfg
    names = {n for n, _ in state.teacher.named_parameters()}
    assert names == {n for n, _ in state.model.named_parameters()}
    head, backbone = state.optimizer.adamw.param_groups
    proj = list(state.projector.parameters())
    assert all(any(p is q for q in head["params"]) for p in proj)
    groups = {n: optim.param_group(n)
              for n, _ in state.model.named_parameters()}
    for group, members in (("head", head["params"]),
                           ("backbone", backbone["params"])):
        ids = {id(p) for p in members}
        for n, p in state.model.named_parameters():
            assert (id(p) in ids) == (groups[n] == group), n
    assert {g for g in groups.values()} == {"head", "backbone", "frozen"}

    before = [p.detach().clone() for p in proj]
    state.optimizer.zero_grad()
    for p in state.model.parameters():
        if p.requires_grad:
            p.grad = torch.ones_like(p)
    state.optimizer.step(0)
    lr, wd = 1e-4, 1e-4
    for p, p0 in zip(proj, before):
        assert p.grad is not None and not p.grad.any()
        torch.testing.assert_close(p.detach(), p0 * (1 - lr * wd),
                                   rtol=1e-7, atol=0)


def test_step_default_noise_is_seeded_by_step():
    """Without noises the three CDN draws come, in order, from a generator
    seeded by (seed, step): the same state gives the same step, and
    passing those draws explicitly gives it too."""
    import copy
    from semi_detr_tpu_torch.models.dn import draw_cdn_noise
    from semi_detr_tpu_torch.train.state import init_ssod_state
    state, cfg = init_ssod_state(SSOD_CONFIG, device="cpu", seed=2,
                                 cfg_options=TINY_OPTIONS)
    state.step = 3
    batch = _batch()
    batch["unsup"]["student_images"] = batch["unsup"]["student_images"][:1]
    for k in ("student_hw", "student_tmat", "teacher_images", "teacher_hw",
              "teacher_tmat"):
        batch["unsup"][k] = batch["unsup"][k][:1]
    tb = to_device(batch, "cpu")
    twin = copy.deepcopy(state)
    step = make_ssod_train_step(cfg, warm_up=True, seed=5)
    got = step(state, tb)
    g = torch.Generator().manual_seed((5 << 32) + 3)
    c = cfg.dino
    noises = [draw_cdn_noise(g, n, c.dn_pad_size, c.num_classes, "cpu")
              for n in (2, 1, 1)]
    ref = step(twin, tb, noises=noises)
    assert state.step == twin.step == 4
    keys = {k for k in got if "loss" in k}
    assert any(k.startswith("unsup_consis_loss") for k in keys)
    assert set(got) == set(ref) and {
        "total_loss", "grad_norm", "ema_momentum", "pseudo_per_img",
        "sup_set_per_img", "cons_set_per_img", "gmm_thr", "pseudo_vis",
        "pseudo_sets"} <= set(got)
    for k in keys | {"grad_norm", "gmm_thr"}:
        assert float(got[k]) == float(ref[k]), k
    assert float(got["ema_momentum"]) == np.float32(0.75)
