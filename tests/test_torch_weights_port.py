"""Weights carried from the JAX package into the port, the port's seeded
init, and the port's independence from JAX.

`state_dict_from_jax` must equal the JAX package's `export_dino_detector`
of the same variables key for key and array for array, and must load into
the port's modules with strict key matching.
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_detr_tpu.models.dino_head import DinoConfig as JaxConfig
from semi_detr_tpu.models.dino_head import DINODetector as JaxDetector
from semi_detr_tpu.utils.torch_weights import export_dino_detector
from semi_detr_tpu_torch.models.dino_head import DinoConfig, DINODetector
from semi_detr_tpu_torch.ops.ms_deform_attn import sampling_offsets_init_bias
from semi_detr_tpu_torch.utils.torch_weights import state_dict_from_jax

from test_torch_detector import TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_variables():
    model = JaxDetector(JaxConfig(**TINY))
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.asarray([[64, 64]], jnp.int32))
    return jax.tree.map(np.asarray, variables)


def test_state_dict_from_jax_equals_export(jax_variables):
    n_dec = TINY["num_decoder_layers"]
    got = state_dict_from_jax(jax_variables, n_dec)
    ref = export_dino_detector(jax_variables, n_dec)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)


def test_port_modules_carry_the_reference_names(jax_variables):
    port = DINODetector(DinoConfig(**TINY))
    sd = state_dict_from_jax(jax_variables, TINY["num_decoder_layers"])
    assert sorted(port.state_dict()) == sorted(sd)
    port.load_state_dict(sd, strict=True)
    # the decoder heads are shared: one tensor behind every index
    head = port.bbox_head
    assert head.fc_cls[0] is head.fc_cls[-1]
    assert head.fc_reg[0] is head.fc_reg[-1]


def test_seeded_init_follows_the_jax_initializers():
    cfg = DinoConfig(**TINY)
    a = DINODetector(cfg).init_weights(seed=3)
    b = DINODetector(cfg).init_weights(seed=3)
    c = DINODetector(cfg).init_weights(seed=4)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["backbone.conv1.weight"],
                           c.state_dict()["backbone.conv1.weight"])
    head = a.bbox_head
    prior = -math.log(0.99 / 0.01)
    torch.testing.assert_close(head.fc_cls[0].bias,
                               torch.full((TINY["num_classes"],), prior))
    assert torch.count_nonzero(head.fc_reg[0].layers[-1].weight) == 0
    assert torch.count_nonzero(head.fc_enc_reg.layers[-1].weight) == 0
    msda = head.transformer.encoder.layers[0].self_attn
    assert torch.count_nonzero(msda.sampling_offsets.weight) == 0
    np.testing.assert_array_equal(
        msda.sampling_offsets.bias.detach().numpy(),
        sampling_offsets_init_bias(TINY["n_heads"], 4, 4))
    w = a.backbone.layer1[0].conv2.weight                  # xavier bound
    assert w.abs().max() <= math.sqrt(6 / (2 * 64 * 9)) and w.std() > 0
    torch.testing.assert_close(a.backbone.bn1.running_var, torch.ones(64))


def test_compute_dtype_keeps_sampling_projections_float32():
    """Parameters stay float32 (flax's param_dtype); layers compute in the
    compute dtype, except the sampling-offset and attention-logit
    projections, which compute in float32."""
    det = DINODetector(DinoConfig(**TINY, dtype="bfloat16"))
    msda = det.bbox_head.transformer.decoder.layers[0].cross_attn
    assert det.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in det.parameters())
    assert msda.value_proj.compute_dtype == torch.bfloat16
    assert msda.sampling_offsets.compute_dtype == torch.float32
    assert msda.attention_weights.compute_dtype == torch.float32
    assert det.backbone.bn1.running_var.dtype == torch.float32
    x = torch.randn(2, 3, TINY["d_model"])
    assert msda.value_proj(x).dtype == torch.bfloat16
    assert msda.sampling_offsets(x).dtype == torch.float32
    # a bfloat16 layer equals float32 math on bf16-rounded inputs/weights
    ref = torch.nn.functional.linear(
        x.bfloat16().float(), msda.value_proj.weight.bfloat16().float(),
        msda.value_proj.bias.bfloat16().float())
    torch.testing.assert_close(msda.value_proj(x).float(), ref,
                               rtol=2 ** -7, atol=1e-2)


def test_port_imports_no_jax():
    code = ("import sys, semi_detr_tpu_torch, semi_detr_tpu_torch.api, "
            "semi_detr_tpu_torch.models.inference, "
            "semi_detr_tpu_torch.ops.ms_deform_attn_cuda, "
            "semi_detr_tpu_torch.ops.hungarian, "
            "semi_detr_tpu_torch.models.dn, "
            "semi_detr_tpu_torch.models.losses, "
            "semi_detr_tpu_torch.models.assign, "
            "semi_detr_tpu_torch.models.criterion, "
            "semi_detr_tpu_torch.train.optim, "
            "semi_detr_tpu_torch.train.state, "
            "semi_detr_tpu_torch.train.schedules, "
            "semi_detr_tpu_torch.train.supervised, "
            "semi_detr_tpu_torch.data.pipeline, "
            "semi_detr_tpu_torch.tools.msda_bench, "
            "semi_detr_tpu_torch.utils.torch_weights\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'semi_detr_tpu')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
