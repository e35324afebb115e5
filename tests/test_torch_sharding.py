"""The port's FSDP / TP layout (`semi_detr_tpu_torch.parallel.sharding`)
against the JAX package's, and donation.

* The plan: `fsdp_sharding`, `tp_sharding` and their composition (TP over
  an FSDP base) of the port's detector and Projector against
  `semi_detr_tpu.parallel.mesh.fsdp_sharding` / `tp_sharding` on the same
  weights converted to the JAX layout (`convert_dino_detector`,
  `convert_projector`), on conftest's 8-device CPU mesh cut three ways;
  nothing is compiled. Each JAX leaf's spec is written into an array of the
  leaf's shape (the index along the sharded dim, plus one; zeros where
  replicated) and carried back to the port's layout by the JAX package's
  exporter, so each port parameter reads which of its dims JAX shards: the
  same dim, or replicated, for every leaf. The tiny widths reach the
  odd-dim fallback (900 queries over 8), `min_size` (biases, norms, the
  stacked-leaf counts) and TP over FSDP.
* Donation: the SSOD step's update made a few tensors at a time against
  one call over the state, from the same state: every parameter, teacher
  leaf and moment equal to the bit, and each keeps its storage across the
  step.
"""
import numpy as np
import pytest
import torch

import jax

from semi_detr_tpu.parallel import mesh as jmesh
from semi_detr_tpu.utils.torch_weights import (convert_dino_detector,
                                               convert_projector,
                                               export_dino_detector)
from semi_detr_tpu_torch.data.pipeline import synthetic_ssod_batch, to_device
from semi_detr_tpu_torch.models.dino_head import DinoConfig, DINODetector
from semi_detr_tpu_torch.models.ssod import Projector
from semi_detr_tpu_torch.parallel import sharding
from semi_detr_tpu_torch.train import optim
from semi_detr_tpu_torch.train.ssod import make_ssod_train_step
from semi_detr_tpu_torch.train.state import init_ssod_state
from semi_detr_tpu_torch.utils.torch_weights import (
    projector_state_dict_from_jax)

from test_torch_ssod_step import SSOD_CONFIG, TINY_OPTIONS

CFG = dict(num_classes=80, num_queries=900, d_model=64, n_heads=2,
           num_encoder_layers=1, num_decoder_layers=2, d_ffn=64,
           dn_single_pad=4, dn_groups=2, max_gt=8)
MESHES = [(2, 4), (4, 2), (8, 1)]


@pytest.fixture(scope="module")
def models():
    det = DINODetector(DinoConfig(**CFG)).init_weights(seed=0)
    proj = Projector(CFG["d_model"]).init_weights(
        torch.Generator().manual_seed(1))
    sd = {k: v.numpy() for k, v in det.state_dict().items()}
    jvars = convert_dino_detector(sd, n_heads=CFG["n_heads"])
    jproj = convert_projector({f"projector.{k}": v.numpy()
                               for k, v in proj.state_dict().items()})
    return det, proj, jvars, jproj


def _encoded(shardings, tree, axis):
    """Per leaf: the index along the dim its sharding splits over `axis`,
    plus one (zeros where `axis` splits none)."""
    def enc(s, x):
        shape = np.shape(x)
        spec = tuple(s.spec) + (None,) * (len(shape) - len(s.spec))
        dims = [i for i, a in enumerate(spec) if a == axis]
        assert len(dims) <= 1
        if not dims:
            return np.zeros(shape, np.float32)
        return (np.indices(shape)[dims[0]] + 1).astype(np.float32)
    return jax.tree.map(enc, shardings, tree)


def _dim_of(x):
    """The one dim along which x varies (None: x is all zeros)."""
    x = np.asarray(x)
    if not x.any():
        return None
    dims = [d for d in range(x.ndim)
            if np.ptp(x, axis=d).any()]
    assert len(dims) == 1, dims
    return dims[0]


def _jax_dims(models, shardings, axis):
    """{port name: the port dim JAX shards over `axis`, or None}."""
    det, proj, jvars, jproj = models
    det_enc = _encoded(shardings["detector"], jvars["params"], axis)
    stats = jax.tree.map(np.zeros_like, jvars["batch_stats"])
    sd = export_dino_detector({"params": det_enc, "batch_stats": stats},
                              CFG["num_decoder_layers"])
    out = {n: _dim_of(sd[n]) for n, _ in det.named_parameters()}
    psd = projector_state_dict_from_jax(
        _encoded(shardings["projector"], jproj, axis))
    out.update({f"projector.{n}": _dim_of(psd[n].numpy())
                for n, _ in proj.named_parameters()})
    return out


def _port_dims(models, plan_of, axis):
    det, proj = models[:2]
    out = {}
    for prefix, m in (("", det), ("projector.", proj)):
        for n, spec in plan_of(m).items():
            out[prefix + n] = spec.index(axis) if axis in spec else None
    return out


def _tree(models):
    return {"detector": models[2]["params"], "projector": models[3]}


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_fsdp_plan_equals_jax(models, shape):
    mesh = jmesh.make_mesh(shape)
    ref = _jax_dims(models, jmesh.fsdp_sharding(mesh, _tree(models)), "data")
    got = _port_dims(models, lambda m: sharding.fsdp_sharding(m, shape[0]),
                     "data")
    assert got.keys() == ref.keys()
    bad = {n: (got[n], ref[n]) for n in ref if got[n] != ref[n]}
    assert not bad, bad
    # the rule's branches are all reached: sharded, small, and no divisor
    det = models[0]
    # the stacked decoder kernels reach min_size, the encoder's (1 layer)
    # do not
    assert got["bbox_head.transformer.decoder.layers.0.linear1.weight"] == 1
    assert got["bbox_head.transformer.encoder.layers.0.linear1.weight"] \
        is None
    assert got["bbox_head.transformer.decoder.norm.weight"] is None
    # 900 queries do not divide over 8: their embedding falls back to 64
    assert got["bbox_head.transformer.tgt_embed.weight"] == (
        1 if shape[0] == 8 else 0)
    assert sum(v is not None for v in got.values()) > 50
    assert len(got) == len(list(det.parameters())) + len(
        list(models[1].parameters()))


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_tp_plan_over_fsdp_equals_jax(models, shape):
    mesh = jmesh.make_mesh(shape)
    tree = _tree(models)
    for base in (None, jmesh.fsdp_sharding(mesh, tree)):
        specs = jmesh.tp_sharding(mesh, tree, base=base)

        def port_plan(m, base=base):
            b = sharding.fsdp_sharding(m, shape[0]) if base else None
            return sharding.tp_sharding(m, shape[1], base=b)

        for axis in ("data", "model"):
            ref = _jax_dims(models, specs, axis)
            got = _port_dims(models, port_plan, axis)
            bad = {n: (got[n], ref[n]) for n in ref if got[n] != ref[n]}
            assert not bad, (axis, bad)
        if shape[1] > 1:
            got = _port_dims(models, port_plan, "model")
            ffn = [n for n in got if n.split(".")[-2] in ("linear1",
                                                          "linear2")]
            assert len(ffn) == 4 * 3
            assert {n for n in ffn if got[n] is not None} == {
                n for n in ffn if not n.endswith("linear2.bias")}


def test_plan_of_the_train_state():
    """`plan` is `_state_sharding`'s choice: FSDP, TP over FSDP, or
    replicated; TP wins on its leaves."""
    det = DINODetector(DinoConfig(**CFG))
    both = sharding.plan(det, 2, 2, True)
    fsdp = sharding.plan(det, 2, 1, True)
    none = sharding.plan(det, 2, 1, False)
    name = "bbox_head.transformer.decoder.layers.0.linear1.weight"
    assert both[name] == ("model", None) and fsdp[name] == (None, "data")
    assert set(map(tuple, none.values())) <= {(None,) * k for k in range(5)}
    assert both["bbox_head.transformer.enc_output.weight"] == fsdp[
        "bbox_head.transformer.enc_output.weight"]


def test_donated_step_is_bit_equal_and_keeps_storage(monkeypatch):
    """Every step is donated: the EMA's products and AdamW's denominators
    are made UPDATE_CHUNK elements at a time (set small here, so both
    split), the same update to the bit as one call over the state, every
    state tensor updated in place."""
    # one thread: the CPU's threaded convolution backward can round the
    # backbone's gradients differently from one call to the next
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _donated_steps(monkeypatch)
    finally:
        torch.set_num_threads(threads)


def _donated_steps(monkeypatch):
    # the whole state in one call, then a few tensors at a time
    chunks = (1 << 62, 300_000)
    states = [init_ssod_state(SSOD_CONFIG, device="cpu",
                              cfg_options=TINY_OPTIONS)
              for _ in chunks]
    cfg = states[0][1]
    states = [s for s, _ in states]
    batch = to_device(synthetic_ssod_batch(1, 1, 64, 64, 8, 3, seed=4,
                                           student_flip=True), "cpu")

    def tensors(state):
        out = {}
        for tag, m in (("s", state.model), ("t", state.teacher),
                       ("p", state.projector)):
            out.update({f"{tag}.{n}": p for n, p in m.named_parameters()})
        for i, st in enumerate(state.optimizer.adamw.state.values()):
            out.update({f"m{i}.{k}": v for k, v in st.items()})
        return out

    ptrs = []
    for warm_up in (True, False):
        step = make_ssod_train_step(cfg, warm_up=warm_up)
        metrics = []
        for s, chunk in zip(states, chunks):
            monkeypatch.setattr(optim, "UPDATE_CHUNK", chunk)
            metrics.append(step(s, batch))
        assert float(metrics[0]["total_loss"]) == float(
            metrics[1]["total_loss"])
        assert float(metrics[0]["grad_norm"]) == float(
            metrics[1]["grad_norm"])
        now = [tensors(s) for s in states]
        assert now[0].keys() == now[1].keys() and len(now[0]) > 1000
        for k in now[0]:
            assert torch.equal(now[0][k], now[1][k]), k
        ptrs.append({k: v.data_ptr() for k, v in now[1].items()})
    # the moments exist from the first step on: the second kept them all
    assert ptrs[0] == ptrs[1]
    # the small chunk split the state
    trainable = [p for _, p, _ in states[1].optimizer.params]
    assert len(optim.chunk_slices(trainable)) > sum(
        p.numel() for p in trainable) // 300_000 // 2


def test_local_slice_owns_its_storage():
    """A moment cut for a shard (`GroupedAdamW.rebuilt` on a resumed run)
    is a copy: a view would keep the whole tensor alive on every rank."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from semi_detr_tpu_torch.parallel import dist

    dist.init_distributed("gloo", "cpu", 0, 1,
                          f"tcp://127.0.0.1:{dist.free_port()}")
    try:
        mesh = init_device_mesh("cpu", (1,))
        for d in (0, 1):
            like = distribute_tensor(torch.zeros(4, 3), mesh, [Shard(d)])
            full = torch.arange(12.0).reshape(4, 3)
            out = sharding.local_slice(full, like)
            assert torch.equal(out, full) and out.is_contiguous()
            assert (out.untyped_storage().data_ptr()
                    != full.untyped_storage().data_ptr())
    finally:
        dist.destroy()
