"""The modules and tools off the main path, against the JAX package.

`LegacyMultiheadAttention` (float32, 1e-5: other summation orders), the
two samplers and the three registered losses (1e-6 relative: the same
float32 formulas) against their JAX counterparts on numpy-seeded inputs;
`capacity_probe`'s GT statistics and exact NMS against the JAX tool's;
the wandb sink of `MetricsLogger` (its warning when wandb cannot be
imported, and what it logs through a stand-in module);
`recipe_rehearsal.analyze` on canned logs; `browse_dataset` on a small
synthetic set; `capacity_probe`'s pseudo-label path on a tiny checkpoint
of this package.
"""
import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_detr_tpu.core import samplers as jax_samplers
from semi_detr_tpu.models import losses as jax_losses
from semi_detr_tpu.models.attention import \
    LegacyMultiheadAttention as JaxLegacyMHA
from semi_detr_tpu_torch.core import samplers
from semi_detr_tpu_torch.data.image_io import read_image
from semi_detr_tpu_torch.data.synthetic import write_synthetic_coco
from semi_detr_tpu_torch.models import losses
from semi_detr_tpu_torch.models.attention import (
    LegacyMultiheadAttention, legacy_mha_state_dict_from_jax)
from semi_detr_tpu_torch.tools import (browse_dataset, capacity_probe,
                                       recipe_rehearsal)
from semi_detr_tpu_torch.utils.logging import MetricsLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name, path):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mask_kind", ["none", "bool", "float", "kpm",
                                       "per_head", "vdim"])
def test_legacy_mha_matches_jax(mask_kind):
    rs = np.random.RandomState(3)
    b, l, s, e, heads = 2, 5, 7, 16, 4
    vdim = 12 if mask_kind == "vdim" else e
    q = rs.randn(b, l, e).astype(np.float32)
    k = rs.randn(b, s, e).astype(np.float32)
    v = rs.randn(b, s, vdim).astype(np.float32)
    kpm = attn = None
    if mask_kind == "bool":
        attn = rs.rand(l, s) < 0.3
    elif mask_kind == "float":
        attn = rs.randn(l, s).astype(np.float32)
    elif mask_kind == "kpm":
        kpm = np.zeros((b, s), bool)
        kpm[:, -2:] = True
    elif mask_kind == "per_head":
        attn = rs.rand(b * heads, l, s) < 0.3
    jmod = JaxLegacyMHA(num_heads=heads)
    params = jmod.init(jax.random.PRNGKey(0), q, k, v)["params"]
    params = jax.tree_util.tree_map(
        lambda x: rs.randn(*x.shape).astype(np.float32), params)
    want, want_w = jmod.apply(
        {"params": params}, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        key_padding_mask=None if kpm is None else jnp.asarray(kpm),
        attn_mask=None if attn is None else jnp.asarray(attn))
    mod = LegacyMultiheadAttention(e, heads, vdim=vdim)
    mod.load_state_dict(legacy_mha_state_dict_from_jax(params))
    got, got_w = mod(torch.from_numpy(q), torch.from_numpy(k),
                     torch.from_numpy(v),
                     key_padding_mask=None if kpm is None
                     else torch.from_numpy(kpm),
                     attn_mask=None if attn is None
                     else torch.from_numpy(attn))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_w.detach().numpy(), np.asarray(want_w),
                               rtol=1e-5, atol=1e-6)


def test_legacy_mha_parameter_names_are_the_reference():
    assert sorted(LegacyMultiheadAttention(8, 2).state_dict()) == [
        "out_proj.bias", "out_proj.weight"]


def _gt_inds(rng, n, g):
    return rng.randint(-1, g + 1, n).astype(np.int64)


@pytest.mark.parametrize("seed", range(3))
def test_ignore_sampling_masks_match_jax(seed):
    rng = np.random.RandomState(seed)
    gt_inds = _gt_inds(rng, 12, 4)
    boxes = rng.randn(4, 4).astype(np.float32)
    labels = rng.randint(0, 5, 12)
    got = samplers.ignore_sampling_masks(torch.from_numpy(gt_inds),
                                         torch.from_numpy(boxes),
                                         torch.from_numpy(labels))
    ref = jax_samplers.ignore_sampling_masks(jnp.asarray(gt_inds),
                                             jnp.asarray(boxes),
                                             jnp.asarray(labels))
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert int(got.num_pos) == int(ref.num_pos)


@pytest.mark.parametrize("with_labels", [False, True])
def test_double_sampling_masks_match_jax(with_labels):
    rng = np.random.RandomState(7)
    g1, g2 = _gt_inds(rng, 10, 3), _gt_inds(rng, 10, 3)
    boxes = rng.randn(3, 4).astype(np.float32)
    l1, l2 = (rng.randint(0, 5, 10) if with_labels else None
              for _ in range(2))
    t = (lambda a: None if a is None else torch.from_numpy(a))
    j = (lambda a: None if a is None else jnp.asarray(a))
    got = samplers.double_sampling_masks(t(g1), t(g2), t(boxes), t(l1),
                                         t(l2))
    ref = jax_samplers.double_sampling_masks(j(g1), j(g2), j(boxes), j(l1),
                                             j(l2))
    for name in ref._fields:
        r = getattr(ref, name)
        if r is None:
            assert getattr(got, name) is None, name
            continue
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(r), err_msg=name)


@pytest.mark.parametrize("reduction,class_weight", [
    ("sum", None), ("mean", None), ("none", None), ("sum", "w")])
def test_softmax_focal_loss_matches_jax(reduction, class_weight):
    rs = np.random.RandomState(0)
    logits = rs.randn(12, 7).astype(np.float32)
    labels = rs.randint(0, 7, 12)
    cw = rs.uniform(0.5, 2, 7).astype(np.float32) if class_weight else None
    got = losses.softmax_focal_loss(torch.from_numpy(logits),
                                    torch.from_numpy(labels), gamma=1.5,
                                    class_weight=cw, reduction=reduction)
    ref = jax_losses.softmax_focal_loss(jnp.asarray(logits),
                                        jnp.asarray(labels), gamma=1.5,
                                        class_weight=cw, reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("binary", [False, True])
def test_binary_kl_div_loss_matches_jax(binary):
    rs = np.random.RandomState(1)
    logits = rs.randn(9, 5).astype(np.float32)
    target = rs.rand(9, 5).astype(np.float32)
    target[0, :2] = 0.0                       # 0 log 0 = 0
    got = losses.binary_kl_div_loss(torch.from_numpy(logits),
                                    torch.from_numpy(target), binary=binary)
    ref = jax_losses.binary_kl_div_loss(jnp.asarray(logits),
                                        jnp.asarray(target), binary=binary)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True])
def test_focal_kl_loss_matches_jax(weighted):
    rs = np.random.RandomState(2)
    logits = rs.randn(8, 6).astype(np.float32)
    target = rs.rand(8, 6).astype(np.float32)
    target[1] = 0.0
    weight = rs.rand(8).astype(np.float32) if weighted else None
    avg = 5.0 if weighted else None
    got = losses.focal_kl_loss(
        torch.from_numpy(logits), torch.from_numpy(target), gamma=0.5,
        weight=None if weight is None else torch.from_numpy(weight),
        avg_factor=avg)
    ref = jax_losses.focal_kl_loss(
        jnp.asarray(logits), jnp.asarray(target), gamma=0.5,
        weight=None if weight is None else jnp.asarray(weight),
        avg_factor=avg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def _annotations(path):
    """A COCO file with crowd boxes, an image without boxes and
    annotations of an image outside the images list."""
    rng = np.random.RandomState(4)
    images = [{"id": i, "file_name": f"{i}.jpg", "height": 10, "width": 10}
              for i in range(12)]
    anns, aid = [], 0
    for img_id, n in enumerate(rng.randint(0, 9, 12)):
        for _ in range(n):
            anns.append({"id": aid, "image_id": img_id, "category_id": 1,
                         "bbox": [0, 0, 2, 2], "area": 4,
                         "iscrowd": int(rng.rand() < 0.1)})
            aid += 1
    anns += [{"id": aid + i, "image_id": 99, "category_id": 1,
              "bbox": [0, 0, 1, 1], "area": 1, "iscrowd": 0}
             for i in range(3)]
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "person"}]}, f)


def test_gt_stats_match_the_jax_tool(tmp_path, capsys):
    ann = str(tmp_path / "ann.json")
    _annotations(ann)
    jax_tool = _jax_tool("jax_capacity_probe",
                         "tools/misc/capacity_probe.py")
    jax_tool.gt_stats(ann, 5, 8)
    want = capsys.readouterr().out
    out = capacity_probe.gt_stats(ann, 5, 8)
    assert capsys.readouterr().out == want
    assert out["caps"]["max_gt=5"]["images_over"] > 0
    assert out["gts"] > 0


@pytest.mark.parametrize("seed", range(3))
def test_exact_nms_matches_the_jax_tool(seed):
    jax_tool = _jax_tool("jax_capacity_probe",
                         "tools/misc/capacity_probe.py")
    rng = np.random.RandomState(seed)
    ctr = rng.uniform(0, 1, (30, 2))
    wh = rng.uniform(0.05, 0.3, (30, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(
        np.float32)
    scores = rng.uniform(0, 1, (30, 4)).astype(np.float32)
    got = capacity_probe.exact_multiclass_nms_np(boxes, scores, 0.3, 0.5, 40)
    ref = jax_tool.exact_multiclass_nms_np(boxes, scores, 0.3, 0.5, 40)
    assert got[0] == ref[0]
    np.testing.assert_array_equal(got[1], ref[1])


def test_pseudo_stats_on_a_checkpoint_of_this_package(tmp_path, capsys):
    from semi_detr_tpu_torch.models.dino_head import (DinoConfig,
                                                      DINODetector)
    paths, img_dir = write_synthetic_coco(str(tmp_path / "set"), n=2,
                                          hw=(48, 64), max_boxes=2)
    opts = ["model.num_classes=1", "model.d_model=32", "model.n_heads=2",
            "model.num_encoder_layers=1", "model.num_decoder_layers=1",
            "model.d_ffn=32", "model.num_queries=30", "model.dtype=float32"]
    det = DINODetector(DinoConfig(num_classes=1, d_model=32, n_heads=2,
                                  num_encoder_layers=1, num_decoder_layers=1,
                                  d_ffn=32, num_queries=30)).init_weights(5)
    sd = det.state_dict()
    ckpt = str(tmp_path / "step_10.pt")
    torch.save({"step": 10, "student": sd, "teacher": sd,
                "projector": None, "optimizer": {}}, ckpt)
    args = ["--ann", paths, "--images", img_dir, "--ckpt", ckpt,
            "--config", "configs/detr_ssod/semi_detr_r50_coco_120k.py",
            "--num-images", "1", "--pre-topk", "10", "--device", "cpu",
            "--cfg-options", *opts]
    out = capacity_probe.main(args)
    text = capsys.readouterr().out
    assert "pre_topk=10 recall vs exact" in text
    p = out["pseudo"]
    assert 0 < p["recall_total"] and 0 <= p["recall_hits"] <= \
        p["recall_total"]


def test_wandb_unavailable_warns(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    logger = MetricsLogger(str(tmp_path), use_tensorboard=False,
                           interval=1, use_wandb=True)
    logger.log_step(0, {"total_loss": torch.tensor(1.5)})
    logger.close()
    assert logger.wandb is None
    with open(tmp_path / "train.log") as f:
        assert "wandb unavailable; wandb disabled" in f.read()


def test_wandb_sink_logs_steps_and_evals(tmp_path, monkeypatch):
    calls = []
    fake = types.SimpleNamespace(
        init=lambda **kw: calls.append(("init", kw)),
        log=lambda d, step: calls.append(("log", d, step)),
        finish=lambda: calls.append(("finish",)))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    logger = MetricsLogger(str(tmp_path), use_tensorboard=False,
                           interval=2, use_wandb=True)
    logger.log_step(1, {"total_loss": torch.tensor(9.0)})      # skipped
    logger.log_step(2, {"total_loss": torch.tensor(1.5)})
    logger.log_eval(2, {"mAP": 0.25, "AP_per_class": {}}, "student")
    logger.close()
    assert calls[0] == ("init", {"dir": str(tmp_path)})
    assert calls[1][0] == "log" and calls[1][2] == 2
    assert calls[1][1]["train/total_loss"] == 1.5
    assert calls[2] == ("log", {"eval_student/mAP": 0.25}, 2)
    assert calls[-1] == ("finish",)


def test_rehearsal_analyze_reads_canned_logs(tmp_path):
    rows = [{"step": 0, "time": 9.0, "total_loss": 10.0},
            {"step": 50, "time": 0.5, "total_loss": 8.0},
            {"step": 100, "time": 0.7, "total_loss": 7.0},
            {"step": 150, "time": 0.6, "total_loss": 6.5}]
    with open(tmp_path / "metrics.jsonl", "w") as f:
        f.write("\n".join(json.dumps(r) for r in rows) + "\n")
    log = "\n".join([
        "x - INFO - Iter [0] total_loss: 10.0000",
        "x - INFO - device memory: {'peak_gb': 11.5, 'total_gb': 79.1, "
        "'headroom_gb': 67.6}",
        "x - INFO - Eval[teacher] iter 100: mAP=0.0100 mAP_50=0.0300 "
        "mAP_s=nan",
        "x - INFO - Eval[student] iter 100: mAP=0.0500 mAP_50=0.1200 "
        "mAP_s=nan",
        "x - INFO - device memory: {'peak_gb': 11.9, 'total_gb': 79.1, "
        "'headroom_gb': 67.2}",
        'x - INFO - msda launches: {"fwd": 40, "bwd": 20}',
        "x - INFO - resumed from step 125",
        "x - INFO - device memory: {'peak_gb': 12.1, 'total_gb': 79.1, "
        "'headroom_gb': 67.0}"])
    with open(tmp_path / "train.log", "w") as f:
        f.write(log + "\n")
    a = recipe_rehearsal.analyze(str(tmp_path))
    assert a["median_step_s"] == 0.6
    assert a["images_per_s"] == 5 / 0.6
    assert a["steps_logged"] == [0, 50, 100, 150]
    assert a["losses_logged"] == [10.0, 8.0, 7.0, 6.5]
    assert a["peak_memory"]["peak_gb"] == 12.1
    assert a["resumed_from"] == [125]
    assert a["msda_launches"] == [{"fwd": 40, "bwd": 20}]
    assert a["evals"][100]["teacher"]["mAP"] == 0.01
    assert a["evals"][100]["student"]["mAP_50"] == 0.12
    assert np.isnan(a["evals"][100]["student"]["mAP_s"])


def test_rehearsal_splits_and_report_path(tmp_path):
    s = recipe_rehearsal.rehearsal_splits(100)
    assert (len(s["sup"]), len(s["unsup"]), len(s["val"])) == (20, 70, 10)
    assert recipe_rehearsal.rehearsal_splits(40)["sup"] == range(0, 8)
    with pytest.raises(ValueError, match="RECIPE_REHEARSAL.md"):
        recipe_rehearsal.main(["--workdir", str(tmp_path), "--out",
                               os.path.join(REPO, "RECIPE_REHEARSAL.md")])


@pytest.mark.parametrize("pipeline", ["weak", "strong", "sup"])
def test_browse_dataset_renders_boxes(tmp_path, pipeline):
    paths, img_dir = write_synthetic_coco(str(tmp_path / "set"), n=2,
                                          hw=(120, 160), max_boxes=2)
    out = str(tmp_path / "viz")
    written = browse_dataset.main(["--ann", paths, "--prefix", img_dir,
                                   "--pipeline", pipeline, "--out", out,
                                   "--num", "2"])
    assert [os.path.basename(p) for p in written] == [
        f"{pipeline}_0.jpg", f"{pipeline}_1.jpg"]
    img = read_image(written[0])
    green = (img[..., 1] > 200) & (img[..., 0] < 60) & (img[..., 2] < 60)
    assert img.ndim == 3 and green.sum() > 20
