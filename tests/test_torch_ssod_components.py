"""The port's SSOD components against the JAX package's, one by one.

Inputs come from numpy seeds and go through both functions. Bounds:

* GMM threshold: equal (the threshold is an element of the pool);
* RoIAlign: max abs error 1e-5 at float32 and with bfloat16 features (both
  weight the taps in float32);
* Projector, carried weights: max abs error 1e-5 of the output's largest
  magnitude;
* pseudo-label decode: equal validity, labels and slot order, boxes within
  1e-4; cross-view transform and matching costs within 1e-5 relative;
* the dual filter, the fake RoI, the consistency partition, slots and
  attention mask: bit-equal; positions (a log) within 1e-6;
* consistency loss: 1e-6 relative, and no gradient into the teacher.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_detr_tpu.data.synthetic import (
    synthetic_ssod_batch as jax_synthetic_ssod_batch)
from semi_detr_tpu.models import dn as jdn
from semi_detr_tpu.models import ssod as jssod
from semi_detr_tpu.models.dino_head import DinoConfig as JaxDinoConfig
from semi_detr_tpu.ops import gmm as jgmm
from semi_detr_tpu.ops import roi_align as jroi
from semi_detr_tpu.utils.torch_weights import convert_projector
from semi_detr_tpu_torch.data.pipeline import synthetic_ssod_batch
from semi_detr_tpu_torch.models import ssod
from semi_detr_tpu_torch.models.dino_head import DinoConfig
from semi_detr_tpu_torch.ops import gmm, roi_align
from semi_detr_tpu_torch.utils.torch_weights import (
    projector_state_dict_from_jax)

K = 7
SSOD_KW = dict(max_pseudo=4, cons_groups=2, nms_max_out=16, nms_pre_topk=32)
JCFG = jssod.SsodConfig(dino=JaxDinoConfig(num_classes=K), **SSOD_KW)
PCFG = ssod.SsodConfig(dino=DinoConfig(num_classes=K), **SSOD_KW)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


# --------------------------------------------------------------------------
# GMM threshold
# --------------------------------------------------------------------------

def _pool(kind, rs):
    k = 40
    if kind == "bimodal":
        c = np.concatenate([rs.normal(2.0, 0.3, 20), rs.normal(6.0, 0.8, 12)])
    elif kind == "unimodal":
        c = rs.normal(4.0, 1.0, 25)
    elif kind == "all_equal":
        c = np.full(9, 3.25)
    elif kind == "empty":
        c = np.zeros(0)
    else:                                    # one valid point
        c = np.asarray([2.5])
    costs = np.zeros(k, np.float32)
    valid = np.zeros(k, bool)
    idx = rs.permutation(k)[:len(c)]
    costs[idx] = c
    valid[idx] = True
    costs[~valid] = rs.uniform(0, 9, (~valid).sum())   # padding is ignored
    return costs, valid


@pytest.mark.parametrize("kind", ["bimodal", "unimodal", "all_equal",
                                  "empty", "one"])
def test_gmm_threshold_matches_jax(kind):
    costs, valid = _pool(kind, np.random.RandomState(len(kind)))
    ref = float(jgmm.fit_gmm_threshold(jnp.asarray(costs),
                                       jnp.asarray(valid)))
    got = gmm.fit_gmm_threshold(_t(costs), _t(valid))
    assert got == ref, (got, ref)
    if valid.any():
        assert got in costs[valid]
    else:
        assert got == 0.0


# --------------------------------------------------------------------------
# RoIAlign
# --------------------------------------------------------------------------

IMG = 256
STRIDES = (8, 16, 32, 64)
ROIS = np.asarray([
    [[10, 12, 60, 70],          # level 0
     [40, 30, 180, 170],        # level 1
     [0, 0, 256, 256],          # level 2, on the borders
     [-120, -90, 400, 420],     # level 3, past every border
     [30, 40, 30, 90],          # zero width: 0
     [5, 100, 255, 110],        # elongated: 5 adaptive taps, capped at 4
     [250, 250, 300, 262]],     # partly past the bottom-right border
    [[100, 100, 101.5, 102],    # tiny
     [-5, -5, 20, 20],
     [60, 10, 250, 240],
     [0, 0, 0, 0],              # zero area
     [12.3, 200.7, 140.9, 255.5],
     [128, 0, 135, 256],        # tall: capped
     [33, 33, 97, 97]]], np.float32)


def _feats(dtype, seed=0, c=6):
    rs = np.random.RandomState(seed)
    return [rs.randn(2, c, -(-IMG // s), -(-IMG // s)).astype(np.float32)
            for s in STRIDES]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multi_level_roi_align_matches_jax(dtype):
    feats = _feats(dtype)
    tdt = getattr(torch, dtype)
    got = roi_align.multi_level_roi_align(
        [_t(f).to(tdt) for f in feats], _t(ROIS))
    assert got.dtype == torch.float32 and got.shape == (2, 7, 6, 7, 7)
    levels = roi_align.roi_levels(_t(ROIS), 4)
    assert set(levels.flatten().tolist()) == {0, 1, 2, 3}
    for i in range(2):
        jf = [jnp.asarray(f[i].transpose(1, 2, 0)).astype(getattr(jnp, dtype))
              for f in feats]
        ref = np.asarray(jroi.multi_level_roi_align(jf, jnp.asarray(ROIS[i])))
        np.testing.assert_allclose(_np(got[i]).transpose(0, 2, 3, 1), ref,
                                   rtol=0, atol=1e-5)
    # the zero-width and zero-area RoIs pool to 0
    assert not got[0, 4].any() and not got[1, 3].any()


@pytest.mark.parametrize("level", [0, 1])
def test_roi_align_level_matches_jax(level):
    """Every RoI on one level, adaptive taps (the JAX default is 2)."""
    feat = _feats("float32", seed=1)[level]
    stride = float(STRIDES[level])
    got = roi_align.roi_align_level(_t(feat), _t(ROIS), stride)
    for i in range(2):
        ref = np.asarray(jroi.roi_align_level(
            jnp.asarray(feat[i].transpose(1, 2, 0)), jnp.asarray(ROIS[i]),
            stride, sampling_ratio=0))
        np.testing.assert_allclose(_np(got[i]).transpose(0, 2, 3, 1), ref,
                                   rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# Projector and its weights
# --------------------------------------------------------------------------

def _reference_projector_sd(c, seed=0):
    """Reference-layout projector weights, random, with the BN running
    statistics a reference checkpoint carries."""
    rs = np.random.RandomState(seed)
    shapes = ssod.Projector(c).state_dict()
    sd = {}
    for k, v in shapes.items():
        shape = tuple(v.shape)
        if len(shape) >= 2:
            a = rs.randn(*shape) / np.sqrt(np.prod(shape[1:]))
        elif k.endswith("weight"):
            a = 1.0 + 0.1 * rs.randn(*shape)
        else:
            a = 0.1 * rs.randn(*shape)
        sd["projector." + k] = a.astype(np.float32)
    for bn, n in (("bn1", c), ("bn2", c), ("bn", 1024)):
        sd[f"projector.{bn}.running_mean"] = rs.randn(n).astype(np.float32)
        sd[f"projector.{bn}.running_var"] = np.ones(n, np.float32)
    return sd


def test_projector_matches_jax():
    c, r = 8, 10
    sd = _reference_projector_sd(c)
    jparams = convert_projector(sd)
    port = ssod.Projector(c)
    port.load_state_dict(projector_state_dict_from_jax(jparams))
    rs = np.random.RandomState(1)
    x = rs.randn(r, c, 7, 7).astype(np.float32)
    mask = np.asarray([1, 1, 0, 1, 0, 1, 1, 1, 0, 1], bool)
    ref = np.asarray(jssod.Projector(c).apply(
        {"params": jparams}, jnp.asarray(x.transpose(0, 2, 3, 1)),
        jnp.asarray(mask)))
    got = port(_t(x), _t(mask))
    assert got.dtype == torch.float32 and got.shape == (r, c)
    np.testing.assert_allclose(_np(got), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    # the masked-out RoIs leave the statistics: changing them changes only
    # their own rows
    x2 = x.copy()
    x2[~mask] *= 3.0
    got2 = port(_t(x2), _t(mask))
    np.testing.assert_allclose(_np(got2)[mask], _np(got)[mask], rtol=1e-6,
                               atol=1e-6)


def test_projector_weights_round_trip():
    """port -> JAX -> port is the identity; a reference checkpoint (with
    running statistics) loads into the port through the JAX layout, and
    the port's own state dict is the reference's names and layout."""
    c = 8
    sd = _reference_projector_sd(c, seed=3)
    port_sd = projector_state_dict_from_jax(convert_projector(sd))
    expect = {k[len("projector."):]: v for k, v in sd.items()
              if "running" not in k}
    assert sorted(port_sd) == sorted(expect)
    for k, v in expect.items():
        np.testing.assert_array_equal(port_sd[k].numpy(), v, err_msg=k)
    port = ssod.Projector(c)
    port.load_state_dict(port_sd)
    again = convert_projector({"projector." + k: v.numpy()
                               for k, v in port.state_dict().items()})
    ref = convert_projector(sd)
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        got = again
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(np.asarray(got), np.asarray(leaf))


def test_projector_init_distributions():
    """The seeded init draws from the JAX Projector's distributions."""
    p = ssod.Projector(64).init_weights(torch.Generator().manual_seed(0))
    p.requires_grad_(False)
    w1 = p.fc1.weight
    std = np.sqrt(1.0 / w1.shape[1])
    assert abs(float(w1.std()) - std) < 0.02 * std
    assert float(w1.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    b = np.sqrt(6.0 / ((64 + 64) * 9))
    assert float(p.conv1.weight.abs().max()) <= b
    assert abs(float(p.conv1.weight.std()) - b / np.sqrt(3)) < 0.02 * b
    assert not p.fc1.bias.any() and not p.fc2.bias.any()
    assert (p.bn.weight == 1).all() and not p.bn.bias.any()


# --------------------------------------------------------------------------
# pseudo labels, transform, matching costs
# --------------------------------------------------------------------------

def _teacher_outputs(seed=0, b=3, nq=24):
    rs = np.random.RandomState(seed)
    logits = rs.normal(-3.0, 2.0, (b, nq, K)).astype(np.float32)
    ctr = rs.uniform(0.1, 0.9, (b, nq, 2))
    wh = rs.uniform(0.05, 0.5, (b, nq, 2))
    coords = np.concatenate([ctr, wh], -1).astype(np.float32)
    # image 2: one box above the NMS score threshold -> no pseudo labels
    logits[2] = -9.0
    logits[2, 5, 3] = 1.0
    hw = np.asarray([[64, 80], [48, 64], [64, 64]], np.int32)
    return logits, coords, hw


def _pl_pair(seed=0):
    logits, coords, hw = _teacher_outputs(seed)
    ref = jssod.decode_pseudo_labels(jnp.asarray(logits), jnp.asarray(coords),
                                     jnp.asarray(hw), JCFG)
    got = ssod.decode_pseudo_labels(_t(logits), _t(coords), _t(hw), PCFG)
    return ref, got, hw


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_pseudo_labels_matches_jax(seed):
    ref, got, _ = _pl_pair(seed)
    np.testing.assert_array_equal(_np(got.valid), np.asarray(ref.valid))
    assert _np(got.valid)[:2].any() and not _np(got.valid)[2].any()
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(_np(got.labels)[v], np.asarray(ref.labels)[v])
    np.testing.assert_allclose(_np(got.scores), np.asarray(ref.scores),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(got.boxes_t)[v], np.asarray(ref.boxes_t)[v],
                               rtol=0, atol=1e-4)


def test_transform_pseudo_to_student_matches_jax():
    ref, got, hw = _pl_pair(0)
    b = hw.shape[0]
    t_teacher = np.tile(np.diag([1.25, 0.8, 1.0]).astype(np.float32), (b, 1, 1))
    t_teacher[:, 0, 2] = 3.0
    flip = np.asarray([[-1, 0, 96], [0, 1, 0], [0, 0, 1]], np.float32)
    scale = np.diag([0.75, 1.5, 1.0]).astype(np.float32)
    t_student = np.einsum("ij,bjk->bik", flip @ scale, t_teacher)
    s_hw = np.asarray([[72, 96], [60, 90], [70, 96]], np.int32)
    r = jssod.transform_pseudo_to_student(ref, jnp.asarray(t_teacher),
                                          jnp.asarray(t_student),
                                          jnp.asarray(s_hw))
    g = ssod.transform_pseudo_to_student(got, _t(t_teacher), _t(t_student),
                                         _t(s_hw))
    v = np.asarray(ref.valid)
    np.testing.assert_allclose(_np(g.boxes_s)[v], np.asarray(r.boxes_s)[v],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        _np(ssod.normalize_boxes(g.boxes_s, _t(s_hw)))[v],
        np.asarray(jssod.normalize_boxes(r.boxes_s, jnp.asarray(s_hw)))[v],
        rtol=1e-5, atol=1e-6)


def test_pseudo_matching_costs_match_jax():
    rs = np.random.RandomState(4)
    b, nq, p = 3, 24, 4
    logits = rs.normal(0, 1.5, (b, nq, K)).astype(np.float32)
    preds = np.concatenate([rs.uniform(0.2, 0.8, (b, nq, 2)),
                            rs.uniform(0.05, 0.4, (b, nq, 2))], -1).astype(
        np.float32)
    boxes = np.concatenate([rs.uniform(0.2, 0.8, (b, p, 2)),
                            rs.uniform(0.05, 0.4, (b, p, 2))], -1).astype(
        np.float32)
    labels = rs.randint(0, K, (b, p)).astype(np.int32)
    valid = np.asarray([[1, 1, 1, 0], [1, 0, 0, 0], [0, 0, 0, 0]], bool)
    ref = np.asarray(jssod.pseudo_matching_costs(
        jnp.asarray(logits), jnp.asarray(preds), jnp.asarray(boxes),
        jnp.asarray(labels), jnp.asarray(valid)))
    got = _np(ssod.pseudo_matching_costs(_t(logits), _t(preds), _t(boxes),
                                         _t(labels).long(), _t(valid)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert not got[~valid].any() and (got[valid] != 0).all()


# --------------------------------------------------------------------------
# dual filter and the consistency block
# --------------------------------------------------------------------------

def _kept(seed):
    rs = np.random.RandomState(seed)
    b, p = 4, 4
    valid = rs.rand(b, p) < 0.7
    valid[3] = False                         # an image with no pseudo box
    scores = rs.uniform(0, 1, (b, p)).astype(np.float32) * valid
    costs = rs.uniform(1, 8, (b, p)).astype(np.float32) * valid
    return costs, scores, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dual_filter_and_fake_roi_match_jax(seed):
    costs, scores, valid = _kept(seed)
    thr = float(np.median(costs[valid]))
    rk = jssod.dual_filter(jnp.asarray(costs), jnp.asarray(scores),
                           jnp.asarray(valid), jnp.float32(thr), 0.6)
    gk = ssod.dual_filter(_t(costs), _t(scores), _t(valid), thr, 0.6)
    for a, r in zip(gk, rk):
        np.testing.assert_array_equal(_np(a), np.asarray(r))
    rs = np.random.RandomState(seed + 10)
    bt = rs.uniform(0, 60, (4, 4, 4)).astype(np.float32)
    bs = rs.uniform(0, 60, (4, 4, 4)).astype(np.float32)
    t_hw = np.asarray([[64, 80], [48, 64], [64, 64], [33, 47]], np.int32)
    s_hw = t_hw[:, ::-1].copy()
    ref = jssod.inject_fake_consistency_roi(rk[1], jnp.asarray(bt),
                                            jnp.asarray(bs),
                                            jnp.asarray(t_hw),
                                            jnp.asarray(s_hw))
    got = ssod.inject_fake_consistency_roi(gk[1], _t(bt), _t(bs), _t(t_hw),
                                           _t(s_hw))
    for a, r in zip(got, ref):
        np.testing.assert_array_equal(_np(a), np.asarray(r))
    assert _np(got[0])[3, 0] and not _np(gk[1])[3].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_consistency_slots_match_jax(seed):
    costs, scores, valid = _kept(seed)
    packed = np.asarray(jnp.take_along_axis(
        jnp.asarray(valid), jdn.pack_order(jnp.asarray(valid)), axis=1))
    cap = 2 * 4
    rsp, ridx, rw = jssod.consistency_partition(jnp.asarray(packed), 2, cap)
    gsp, gidx, gw = ssod.consistency_partition(_t(packed), 2, cap)
    assert int(gsp) == int(rsp)
    np.testing.assert_array_equal(_np(gidx), np.asarray(ridx))
    np.testing.assert_array_equal(_np(gw), np.asarray(rw))
    rs = np.random.RandomState(seed)
    content = rs.randn(4, 4, 5).astype(np.float32)
    np.testing.assert_array_equal(
        _np(ssod.scatter_to_slots(_t(content), gidx, gw)),
        np.asarray(jssod.scatter_to_slots(jnp.asarray(content), ridx, rw)))
    boxes = np.concatenate([rs.uniform(-5, 30, (4, 4, 2)),
                            rs.uniform(35, 70, (4, 4, 2))], -1).astype(
        np.float32)
    hw = np.asarray([[64, 64], [48, 60], [64, 40], [30, 64]], np.int32)
    # a log: not bit-equal between the two packages' CPU libraries
    np.testing.assert_allclose(
        _np(ssod.consistency_positions(_t(boxes), _t(hw), gw, gidx)),
        np.asarray(jssod.consistency_positions(jnp.asarray(boxes),
                                               jnp.asarray(hw), rw, ridx)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("cons_sp,dn_sp,dn_groups", [
    (1, 2, 2), (1, 3, 1), (3, 1, 4), (4, 4, 1), (2, 2, 2)])
def test_combined_attn_mask_matches_jax(cons_sp, dn_sp, dn_groups):
    """Adaptive (traced-size) consistency and dn partitions inside static
    budgets: cons_pad 8 in 2 groups, dn capacity 8."""
    cap, nq = 8, 12
    ref = np.asarray(jssod.combined_attn_mask(
        8, 2, jnp.int32(dn_sp), jnp.int32(dn_groups), nq, dn_capacity=cap,
        cons_single_pad=jnp.int32(cons_sp)))
    got = ssod.combined_attn_mask(8, 2, torch.tensor(dn_sp),
                                  torch.tensor(dn_groups), nq, cap,
                                  torch.tensor(cons_sp))
    np.testing.assert_array_equal(_np(got), ref)
    # python-int partitions give the same mask
    np.testing.assert_array_equal(
        _np(ssod.combined_attn_mask(8, 2, dn_sp, dn_groups, nq, cap,
                                    cons_sp)), ref)


def test_consistency_loss_matches_jax_and_detaches_the_teacher():
    rs = np.random.RandomState(5)
    n_dec, b, pad, c = 2, 3, 8, 6
    hs_s = rs.randn(n_dec, b, pad, c).astype(np.float32)
    hs_t = rs.randn(n_dec, b, pad, c).astype(np.float32)
    w = rs.rand(b, pad) < 0.5
    counts = np.asarray([3, 1, 2], np.int32)
    ref = jssod.consistency_loss(jnp.asarray(hs_s), jnp.asarray(hs_t),
                                 jnp.asarray(w), jnp.asarray(counts), JCFG,
                                 10.0)
    ts, tt = _t(hs_s).requires_grad_(True), _t(hs_t).requires_grad_(True)
    got = ssod.consistency_loss(ts, tt, _t(w), _t(counts), PCFG, 10.0)
    assert sorted(got) == sorted(ref) == ["consis_loss.d0", "consis_loss.d1"]
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-6)
    sum(got.values()).backward()
    assert tt.grad is None and ts.grad.abs().sum() > 0
    gref = jax.grad(lambda s, t: sum(jssod.consistency_loss(
        s, t, jnp.asarray(w), jnp.asarray(counts), JCFG, 10.0).values()),
        argnums=(0, 1))(jnp.asarray(hs_s), jnp.asarray(hs_t))
    np.testing.assert_allclose(_np(ts.grad), np.asarray(gref[0]), rtol=1e-5,
                               atol=1e-7)
    assert not np.asarray(gref[1]).any()


def test_synthetic_ssod_batch_matches_jax():
    got = synthetic_ssod_batch(2, 3, 32, 48, 6, gt_per_image=4, seed=3)
    ref = jax_synthetic_ssod_batch(2, 3, 32, 48, 6, gt_per_image=4, seed=3)
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    for path, leaf in flat:
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_array_equal(g, leaf)
    flip = synthetic_ssod_batch(2, 3, 32, 48, 6, seed=3, student_flip=True)
    un = flip["unsup"]
    np.testing.assert_array_equal(un["student_images"],
                                  un["teacher_images"][:, :, ::-1])
    box = np.asarray([[[4.0, 2.0, 10.0, 8.0]]], np.float32)
    from semi_detr_tpu_torch.core.boxes import transform_boxes
    moved = transform_boxes(_t(box), _t(un["student_tmat"][:1]))
    np.testing.assert_array_equal(moved.numpy(), [[[38.0, 2.0, 44.0, 8.0]]])
