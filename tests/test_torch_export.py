"""The exported serving program (`tools/export_model.py`) on the CPU.

A tiny detector (the TINY config of tests/test_export.py) gets random
weights in the reference layout, carried into the JAX package by its own
converter; the port's export CLI reads them from a `.pth`, exports the
teacher's predict with `torch.export` (top-k and NMS), saves the `.pt2`
and loads it back. The loaded program must match the eager port to the
bit (the same aten ops on the same inputs) and the JAX `make_predict_fn`
within rtol/atol 1e-4 (the JAX export test's tolerance; float32 on both
sides, other summation orders), labels exactly. The NMS fixpoint, traced
as a `while_loop`, must keep the same sets as the eager loop on seeded
near-tie cases.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semi_detr_tpu.models import inference as jax_inference
from semi_detr_tpu_torch.models.dino_head import DinoConfig, DINODetector
from semi_detr_tpu_torch.models.inference import ServingProgram, predict
from semi_detr_tpu_torch.ops.nms import multiclass_nms
from semi_detr_tpu_torch.tools import export_model

from test_torch_detector import build_pair

TINY = dict(num_classes=7, num_queries=24, d_model=64, n_heads=2,
            num_encoder_layers=2, num_decoder_layers=2, d_ffn=64,
            dn_single_pad=4, dn_groups=2, max_gt=8)
CONFIG = "configs/dino_detr/dino_detr_r50_coco.py"
BUCKET = (64, 96)
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg_options():
    return [f"model.{k}={v}" for k, v in TINY.items()] + [
        "model.dtype=float32"]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(jax detector, jax variables, eager port detector, {use_nms: loaded
    program}), the programs exported by the CLI from a .pth."""
    jax_det, jax_vars, port = build_pair(seed=3, cfg_kw=TINY)
    tmp = tmp_path_factory.mktemp("export")
    ckpt = str(tmp / "tiny.pth")
    torch.save({"state_dict": port.state_dict()}, ckpt)
    programs = {}
    for use_nms in (False, True):
        out = str(tmp / f"tiny_{'nms' if use_nms else 'topk'}.pt2")
        argv = [CONFIG, "--checkpoint", ckpt, "--out", out, "--device",
                "cpu", "--bucket", ",".join(map(str, BUCKET)),
                "--cfg-options", *_cfg_options()]
        export_model.main(argv + (["--with-nms"] if use_nms else []))
        programs[use_nms] = export_model.main(
            [CONFIG, "--load", out, "--device", "cpu", "--selftest",
             "--bucket", ",".join(map(str, BUCKET))])
    return jax_det, jax_vars, port, programs


def _request(seed, hw):
    rng = np.random.RandomState(seed)
    img = np.zeros((1,) + BUCKET + (3,), np.uint8)
    img[0, :hw[0], :hw[1]] = rng.randint(0, 256, hw + (3,))
    return img, np.asarray([hw], np.int32)


@pytest.mark.parametrize("use_nms", [False, True], ids=["topk", "nms"])
@pytest.mark.parametrize("hw", [(64, 96), (50, 77)])
def test_loaded_program_matches_eager_port_and_jax(exported, use_nms, hw):
    jax_det, jax_vars, port, programs = exported
    img, img_hw = _request(11, hw)
    args = (torch.from_numpy(img), torch.from_numpy(img_hw))
    want = predict(port, *args, use_nms=use_nms)
    with torch.inference_mode():
        got = programs[use_nms](*args)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    ref = jax_inference.make_predict_fn(jax_det, use_nms=use_nms)(
        jax_vars, jnp.asarray(img), jnp.asarray(img_hw))
    boxes, scores, labels = (t.numpy() for t in got)
    np.testing.assert_array_equal(labels, np.asarray(ref[2]))
    np.testing.assert_allclose(scores, np.asarray(ref[1]), **TOL)
    np.testing.assert_allclose(boxes, np.asarray(ref[0]), **TOL)
    if use_nms:
        assert int((scores > 0).sum()) > 0


def test_program_carries_the_op_and_the_while_loop(exported):
    """MSDA is the registered op in the graph (one call per layer), and
    the NMS decode a while_loop."""
    *_, programs = exported
    for use_nms, program in programs.items():
        code = program.code
        assert code.count("semi_detr.ms_deform_attn.default") == (
            TINY["num_encoder_layers"] + TINY["num_decoder_layers"])
        assert ("while_loop" in code) == use_nms


def _near_ties(seed, n=40, c=3):
    """Clusters of near-duplicate boxes with near-equal scores: long
    suppression chains whose order rests on the last bits."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(0, 50, (n // 4, 2))
    ctr = np.repeat(base, 4, 0) + rng.uniform(-1.5, 1.5, (n, 2))
    wh = rng.uniform(8, 12, (n, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    scores = np.repeat(rng.uniform(0.2, 0.9, (n // 4, c)), 4, 0)
    scores = scores + rng.uniform(-1e-6, 1e-6, scores.shape)
    return (torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(scores.astype(np.float32)))


class _Nms(torch.nn.Module):
    def forward(self, boxes, scores):
        out = multiclass_nms(boxes, scores, 0.05, 0.5, max_out=60,
                             pre_topk=100)
        return out["box_idx"], out["labels"], out["valid"], out["scores"]


@pytest.mark.parametrize("seed", range(4))
def test_traced_nms_fixpoint_keeps_the_eager_sets(seed, tmp_path):
    boxes, scores = _near_ties(seed)
    want = _Nms()(boxes, scores)
    ep = torch.export.export(_Nms(), (boxes, scores))
    assert "while_loop" in ep.graph_module.code
    path = str(tmp_path / "nms.pt2")
    torch.export.save(ep, path)
    # another draw through the same program: the loop's trip count is
    # the data's, not the trace's
    for b, s in ((boxes, scores), _near_ties(seed + 10)):
        got = torch.export.load(path).module()(b, s)
        ref = _Nms()(b, s)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=0, atol=0)
    kept = int(want[2].sum())
    assert 0 < kept < 100


def test_serving_program_is_predict():
    det = DINODetector(DinoConfig(**TINY)).init_weights(1).eval()
    img, img_hw = _request(12, (40, 90))
    args = (torch.from_numpy(img), torch.from_numpy(img_hw))
    with torch.inference_mode():
        got = ServingProgram(det, use_nms=True)(*args)
    for g, w in zip(got, predict(det, *args, use_nms=True)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
