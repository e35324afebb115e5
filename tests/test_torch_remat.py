"""Activation checkpointing (`DinoConfig.remat`) on the CPU.

With remat, each encoder layer and decoder step runs under a selective
checkpoint that saves the output of `semi_detr::ms_deform_attn` and
recomputes the rest (the JAX package's `save_only_these_names("msda_out")`).
On a tiny detector (the TINY config of tests/test_export.py, float32) with
random weights carried from the JAX package:

* remat against no remat: loss and gradients equal within 1e-6 relative
  (the recomputed forward repeats the same float32 ops);
* remat against the JAX package's remat=True gradients: relative L2 per
  leaf, worst <= 5e-3 and median <= 5e-4 (the bounds of
  tests/test_torch_train_step.py: float32 op order through a ResNet-50 and
  the transformer);
* the MSDA forward runs once per layer in the forward and backward
  together (its CPU implementation's calls counted); with a policy that
  recomputes everything it would run twice, which the count shows too;
* without grad (the teacher's passes, serving) nothing is checkpointed.
"""
import copy
import functools

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

import jax
import jax.numpy as jnp

from semi_detr_tpu.models.dino_head import DinoConfig as JaxConfig
from semi_detr_tpu.models.dino_head import DINODetector as JaxDetector
from semi_detr_tpu.train import optim as joptim
from semi_detr_tpu.utils.torch_weights import convert_dino_detector
from semi_detr_tpu_torch.models import transformer
from semi_detr_tpu_torch.models.dino_head import DinoConfig, DINODetector
from semi_detr_tpu_torch.ops import ms_deform_attn_cuda as cuda_mod

from test_torch_detector import build_pair

TINY = dict(num_classes=7, num_queries=24, d_model=64, n_heads=2,
            num_encoder_layers=2, num_decoder_layers=2, d_ffn=64,
            dn_single_pad=4, dn_groups=2, max_gt=8)
LAYERS = TINY["num_encoder_layers"] + TINY["num_decoder_layers"]


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randn(2, 64, 96, 3).astype(np.float32)
    img_hw = np.asarray([[64, 96], [52, 80]], np.int32)
    # fixed projections of every layer's class logits and boxes
    p_cls = rng.randn(TINY["num_decoder_layers"], 2, TINY["num_queries"],
                      TINY["num_classes"]).astype(np.float32)
    p_box = rng.randn(TINY["num_decoder_layers"], 2, TINY["num_queries"],
                      4).astype(np.float32)
    return images, img_hw, p_cls, p_box


def _port_loss(det, images, img_hw, p_cls, p_box):
    out = det(torch.from_numpy(images), torch.from_numpy(img_hw))
    return ((out["cls"] * torch.from_numpy(p_cls)).sum()
            + (out["coord"] * torch.from_numpy(p_box)).sum()
            + out["enc_cls"].square().mean())


def _grads(det):
    return {k: p.grad.detach().clone() for k, p in det.named_parameters()
            if p.grad is not None}


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=4, cfg_kw=TINY)


def _with_remat(port, remat):
    det = copy.deepcopy(port).train()
    det.bbox_head.transformer.remat = remat
    det.zero_grad(set_to_none=True)
    return det


@pytest.fixture(scope="module")
def runs(pair):
    """{remat: (loss, grads, MSDA forward calls)} of the port."""
    _, _, port = pair
    calls = [0]
    plain = cuda_mod.ms_deform_attn

    def counted(*args):
        calls[0] += 1
        return plain(*args)

    out = {}
    cuda_mod.ms_deform_attn = counted
    try:
        for remat in (False, True):
            det = _with_remat(port, remat)
            calls[0] = 0
            loss = _port_loss(det, *_inputs())
            loss.backward()
            out[remat] = (float(loss.detach()), _grads(det), calls[0])
    finally:
        cuda_mod.ms_deform_attn = plain
    return out


def test_config_reaches_the_transformer():
    det = DINODetector(DinoConfig(**TINY, remat=True))
    assert det.bbox_head.transformer.remat is True
    assert DINODetector(DinoConfig(**TINY)).bbox_head.transformer.remat \
        is False


def test_remat_equals_no_remat(runs):
    loss0, g0, _ = runs[False]
    loss1, g1, _ = runs[True]
    assert abs(loss1 - loss0) <= 1e-6 * abs(loss0)
    assert g0.keys() == g1.keys() and len(g0) > 100
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6,
                                   atol=1e-6 * float(g0[k].abs().max()),
                                   msg=k)


def test_msda_forward_is_saved_not_replayed(runs):
    assert runs[False][2] == LAYERS
    assert runs[True][2] == LAYERS


def test_a_recompute_all_policy_would_replay_msda(pair, monkeypatch):
    """The control of the count above: with nothing saved, the backward
    replays every layer's MSDA forward."""
    _, _, port = pair
    monkeypatch.setattr(transformer, "_MSDA_SAVED", functools.partial(
        create_selective_checkpoint_contexts,
        lambda ctx, op, *a, **k: CheckpointPolicy.PREFER_RECOMPUTE))
    calls = [0]
    plain = cuda_mod.ms_deform_attn

    def counted(*args):
        calls[0] += 1
        return plain(*args)

    monkeypatch.setattr(cuda_mod, "ms_deform_attn", counted)
    _port_loss(_with_remat(port, True), *_inputs()).backward()
    assert calls[0] == 2 * LAYERS


def test_no_grad_passes_are_not_checkpointed(pair, monkeypatch):
    _, _, port = pair
    det = _with_remat(port, True).eval()

    def refuse(*a, **k):
        raise AssertionError("checkpoint under no_grad")

    monkeypatch.setattr(transformer, "checkpoint", refuse)
    images, img_hw, _, _ = _inputs()
    with torch.no_grad():
        det(torch.from_numpy(images), torch.from_numpy(img_hw))


def test_remat_grads_match_jax_remat(pair, runs):
    jdet, jvars, _ = pair
    images, img_hw, p_cls, p_box = _inputs()
    jr = JaxDetector(JaxConfig(**TINY, remat=True))

    def loss_fn(params):
        out = jr.apply({"params": params,
                        "batch_stats": jvars["batch_stats"]},
                       jnp.asarray(images), jnp.asarray(img_hw))
        return ((out["cls"] * p_cls).sum() + (out["coord"] * p_box).sum()
                + jnp.mean(out["enc_cls"] ** 2))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jvars["params"])
    port_loss, port_grads, _ = runs[True]
    assert abs(port_loss - float(loss)) <= 1e-4 * abs(float(loss))

    sd = {k: (port_grads[k].numpy() if k in port_grads
              else np.zeros(tuple(v.shape), np.float32))
          for k, v in pair[2].state_dict().items()}
    got = convert_dino_detector(sd, n_heads=TINY["n_heads"])["params"]
    leaves = {joptim._path_str(p): np.asarray(v) for p, v in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    ref = {joptim._path_str(p): np.asarray(v) for p, v in
           jax.tree_util.tree_flatten_with_path(grads)[0]}
    gnorm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                        for g in ref.values()))
    errs = {}
    for path, rg in ref.items():
        tg = leaves[path]
        if joptim.is_frozen(path) or (
                np.linalg.norm(rg) < 1e-6 * gnorm
                and np.linalg.norm(tg) < 1e-6 * gnorm):
            continue              # frozen, or a true zero on both sides
        d = np.linalg.norm(tg.astype(np.float64) - rg.astype(np.float64))
        errs[path] = d / max(np.linalg.norm(rg.astype(np.float64)), 1e-12)
    assert len(errs) > 100
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 5e-3, (worst, errs[worst])
    assert float(np.median(list(errs.values()))) <= 5e-4
