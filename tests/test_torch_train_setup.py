"""The shared training setup of the port: `train.state.init_train_state`
(detector, config optimizer, EMA teacher from a config file) and
`data.pipeline.synthetic_batch` (seeded images and GT through `pack` and
`stack`), which `chip_smoke.py` phase 5 and `tools/profile_train.py` both
build on. On the CPU, at a small size: the DINO-R50 config with the
transformer cut to d_model 32, 2 heads, 2+2 layers, 20 queries, 5
classes, a CDN budget of 16 slots and max_gt 8, and 64x96 images.
"""
import numpy as np
import pytest
import torch

from semi_detr_tpu_torch.data.pipeline import synthetic_batch, to_device
from semi_detr_tpu_torch.train.state import init_train_state
from semi_detr_tpu_torch.train.supervised import make_supervised_train_step

CONFIG = "configs/dino_detr/dino_detr_r50_coco.py"
SMALL = {"model.num_classes": 5, "model.num_queries": 20,
         "model.d_model": 32, "model.n_heads": 2,
         "model.num_encoder_layers": 2, "model.num_decoder_layers": 2,
         "model.d_ffn": 64, "model.dn_single_pad": 4, "model.dn_groups": 2,
         "model.max_gt": 8, "model.dtype": "float32"}
BUCKET = (64, 96)


def test_synthetic_batch_layout():
    a = synthetic_batch(np.random.RandomState(0), BUCKET, (0, 3, 12), 8, 5)
    b = synthetic_batch(np.random.RandomState(0), BUCKET, (0, 3, 12), 8, 5)
    assert a["images"].shape == (3, 64, 96, 3)
    assert a["images"].dtype == np.uint8
    assert a["gt"]["boxes"].shape == (3, 8, 4)
    # GT beyond max_gt is dropped, as `pack` drops it
    assert a["gt"]["valid"].sum(1).tolist() == [0, 3, 8]
    assert (a["gt"]["labels"] < 5).all()
    for i, (h, w) in enumerate(a["img_hw"]):
        assert 48 <= h <= 64 and 72 <= w <= 96
        assert not a["images"][i, h:].any() and not a["images"][i, :, w:].any()
    boxes = a["gt"]["boxes"][a["gt"]["valid"]]
    assert ((boxes > 0) & (boxes <= 1)).all()
    for k in ("images", "img_hw", "tmat"):
        np.testing.assert_array_equal(a[k], b[k])     # seeded
    np.testing.assert_array_equal(a["gt"]["boxes"], b["gt"]["boxes"])


def test_init_train_state_follows_the_config():
    state = init_train_state(CONFIG, device="cpu", seed=0,
                             cfg_options=dict(SMALL, **{
                                 "model.dtype": "bfloat16"}))
    model, opt = state.model, state.optimizer
    assert state.step == 0 and model.compute_dtype == torch.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    head, backbone = opt.adamw.param_groups
    assert (head["lr_mult"], backbone["lr_mult"]) == (1.0, 0.1)
    assert head["weight_decay"] == backbone["weight_decay"] == 1e-4
    assert opt.clip_norm == 0.1
    assert opt.sched(80699) == np.float32(1e-4)
    assert opt.sched(80700) == np.float32(1e-4) * np.float32(0.1)
    frozen = [k for k, p in model.named_parameters() if not p.requires_grad]
    assert frozen and all(k.startswith(("backbone.conv1.", "backbone.bn1.",
                                        "backbone.layer1."))
                          for k in frozen)
    for (k, p), q in zip(model.named_parameters(),
                         state.teacher.parameters()):
        assert torch.equal(p, q) and not q.requires_grad, k


@pytest.mark.parametrize("warm_up", [True, False])
def test_step_on_a_synthetic_batch(warm_up):
    state = init_train_state(CONFIG, device="cpu", seed=0,
                             cfg_options=SMALL)
    model = state.model
    batch = to_device(synthetic_batch(np.random.RandomState(1), BUCKET,
                                      (0, 5), model.cfg.max_gt, 5), "cpu")
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step = make_supervised_train_step(warm_up=warm_up)
    # two steps: the box MLPs' last layers start at zero, so the layers
    # before them get their first gradient in the second step
    for _ in range(2):
        metrics = step(state, batch)
        assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    assert state.step == 2
    for k, p in model.named_parameters():
        moved = not torch.equal(p, before[k])
        assert moved == p.requires_grad, k
