"""FSDP and tensor parallelism of the train state: the counterpart of
`semi_detr_tpu/parallel/mesh.py:91-171` (`fsdp_sharding`, `tp_sharding`)
and of the JAX trainers' `_state_sharding` (`train/loop.py:57-67`).

The plan (`fsdp_sharding`, `tp_sharding`, `plan`) is JAX's rule, per
parameter name, as a spec: one entry per dim of the port's tensor, the mesh
axis that dim is split over ("data", "model") or None. The rules read each
leaf as the JAX package lays it out (`jax_view`): a Dense kernel (in, out)
where the port has (out, in), a conv kernel HWIO, the attention's per-head
q / k / v kernels (C, H, Dh) and output kernel (H, Dh, C), and the encoder
and decoder layers stacked on a leading layer axis; the dim JAX picks is
then named in the port's layout.

* FSDP over `data` (`mesh.py:91`): each leaf of at least `min_size`
  (8,192) elements shards its largest dim that divides the axis (the first
  of equal ones); smaller leaves, and leaves with no such dim, replicate.
* TP over `model` (`mesh.py:126`, Megatron FFN pairs): every `linear1`
  leaf shards its output dim, the `linear2` kernel its input dim; the
  `linear2` bias and everything else take the base plan (FSDP's, or
  replicated). TP takes precedence over FSDP on its leaves.

`shard_state` applies the plan to a train state whose ranks hold the same
full tensors (`dist.broadcast_state` first): TP through
`parallelize_module` (`ColwiseParallel` on the 12 `linear1`,
`RowwiseParallel` on the 12 `linear2`, over the `model` axis), then FSDP
through `fully_shard` per backbone stage, then the root (which holds the
transformer: see `_units`), over the `data` axis, with `shard_placement_fn`
naming the plan's dim. The student, the EMA teacher (laid out like the student) and
the Projector are sharded; the optimizer is rebuilt over the local shards
with its moments cut from the full ones.

Leaves that FSDP does not shard (the plan's replicated ones, the TP leaves,
and the one leaf the SSOD step reads outside any forward,
`READ_OUTSIDE_FORWARD`: FSDP gathers a parameter only inside a forward) are
`ignored_params`: their gradients are summed over the data group by the
optimizer, as in data parallel. FSDP's reduce-scatter sums (not averages:
`set_force_sum_reduction_for_comms` with a divide factor of 1, plain
ReduceOp.SUM, which gloo and NCCL both run) the gradients of the leaves it
shards, so each rank's gradient is the sum over ranks of its share of the
global loss, the port's data-parallel semantics.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
from torch.distributed.tensor import DTensor

from . import dist

FSDP_MIN_SIZE = 8192
# a parameter the SSOD step reads outside any forward (the CDN queries'
# label embedding): FSDP cannot gather it there, so it stays replicated
READ_OUTSIDE_FORWARD = ("bbox_head.label_enc.weight",)
# the detector methods the steps call besides forward; FSDP hooks them
FORWARD_METHODS = ("encode_images", "decode_queries")

Spec = Tuple[Optional[str], ...]
_LAYER = re.compile(r"\.(encoder|decoder)\.layers\.(\d+)\.")


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

def jax_view(model: nn.Module) -> Dict[str, Tuple[tuple, list]]:
    """{name: (shape of the JAX package's leaf, the port's dim of each of
    its dims)} for every parameter of `model`; a dim of None is the
    stacked layer axis, which the port does not have."""
    from ..models.transformer import MultiheadSelfAttention
    layers = {}                  # stack -> its number of layers
    for name, _ in model.named_parameters():
        m = _LAYER.search(name)
        if m:
            layers[m.group(1)] = max(layers.get(m.group(1), 0),
                                     int(m.group(2)) + 1)
    out = {}
    for mname, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            shape = tuple(p.shape)
            if isinstance(module, MultiheadSelfAttention):
                h = module.n_heads
                c = shape[-1]
                if pname == "in_proj_weight":     # each of q, k, v
                    view = ((c, h, c // h), [1, 0, 0])
                else:                             # in_proj_bias
                    view = ((h, c // (3 * h)), [0, 0])
            elif mname.endswith("self_attn.out_proj") and isinstance(
                    model.get_submodule(mname.rsplit(".", 1)[0]),
                    MultiheadSelfAttention):
                c = shape[0]
                h = model.get_submodule(mname.rsplit(".", 1)[0]).n_heads
                view = (((h, shape[1] // h, c), [1, 1, 0]) if p.dim() == 2
                        else (shape, [0]))
            elif isinstance(module, nn.Linear) and p.dim() == 2:
                view = ((shape[1], shape[0]), [1, 0])
            elif isinstance(module, nn.Conv2d) and p.dim() == 4:
                view = ((shape[2], shape[3], shape[1], shape[0]),
                        [2, 3, 1, 0])
            else:
                view = (shape, list(range(len(shape))))
            m = _LAYER.search(name)
            if m:
                view = ((layers[m.group(1)],) + view[0], [None] + view[1])
            out[name] = view
    return out


def _replicated(ndim: int) -> Spec:
    return (None,) * ndim


def fsdp_sharding(model: nn.Module, n: int, axis: str = "data",
                  min_size: int = FSDP_MIN_SIZE) -> Dict[str, Spec]:
    """JAX's `fsdp_sharding` (`mesh.py:91`) over an axis of `n` ranks:
    {name: spec} of every parameter of `model`."""
    out = {}
    params = dict(model.named_parameters())
    for name, (shape, dims) in jax_view(model).items():
        spec = list(_replicated(params[name].dim()))
        numel = 1
        for d in shape:
            numel *= d
        best, size = None, 0
        if numel >= min_size:
            for i, d in enumerate(shape):
                if d % n == 0 and d > size:
                    best, size = i, d
        if best is not None:
            if dims[best] is None:
                raise ValueError(f"{name}: JAX's rule shards the stacked "
                                 "layer axis, which the port does not have")
            spec[dims[best]] = axis
        out[name] = tuple(spec)
    return out


def tp_sharding(model: nn.Module, n: int, axis: str = "model",
                base: Optional[Dict[str, Spec]] = None) -> Dict[str, Spec]:
    """JAX's `tp_sharding` (`mesh.py:126`): every leaf under a `linear1`
    shards its output dim, a `linear2` kernel its input dim, over `axis` of
    `n` ranks (where the dim divides it); every other leaf takes `base`'s
    spec, or replicates."""
    out = {}
    for name, p in model.named_parameters():
        keys = name.split(".")
        fallback = (base or {}).get(name, _replicated(p.dim()))
        dim = None
        if "linear1" in keys:
            dim = 0                      # (out,) and (out, in): the out dim
        elif "linear2" in keys and keys[-1] == "weight" and p.dim() >= 2:
            dim = 1                      # (out, in): the in dim
        if dim is None or p.shape[dim] % n:
            out[name] = fallback
            continue
        spec = list(_replicated(p.dim()))
        spec[dim] = axis
        out[name] = tuple(spec)
    return out


def plan(model: nn.Module, data: int, tp: int, fsdp: bool
         ) -> Dict[str, Spec]:
    """The JAX trainers' `_state_sharding` (`loop.py:57`) for one module:
    FSDP over `data` ranks when `fsdp`, else replicated, with TP over `tp`
    ranks on top when tp > 1."""
    base = (fsdp_sharding(model, data) if fsdp else
            {n: _replicated(p.dim()) for n, p in model.named_parameters()})
    return tp_sharding(model, tp, base=base) if tp > 1 else base


# --------------------------------------------------------------------------
# local shards and full tensors
# --------------------------------------------------------------------------

def is_sharded(t: torch.Tensor) -> bool:
    return isinstance(t, DTensor)


@torch.no_grad()
def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's tensor of `t`: the local shard of a DTensor (its own
    storage, not a copy), else `t`."""
    return t.to_local() if is_sharded(t) else t


def _shard_dims(t) -> List[Tuple[int, int]]:
    """(mesh dim, tensor dim) of each Shard placement of a DTensor."""
    return [(i, pl.dim) for i, pl in enumerate(t.placements)
            if pl.is_shard()]


def sharded_axes(t: torch.Tensor) -> Tuple[str, ...]:
    """The mesh axes `t` is split over (none for a plain tensor)."""
    if not is_sharded(t):
        return ()
    names = t.device_mesh.mesh_dim_names
    return tuple(names[i] for i, _ in _shard_dims(t))


@torch.no_grad()
def local_slice(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the full tensor `full`, laid out as the
    parameter `like` (a copy on its device, which keeps none of `full`
    alive; `full` itself for a plain `like`)."""
    if not is_sharded(like):
        return full
    coord = like.device_mesh.get_coordinate()
    out = full
    for i, d in _shard_dims(like):
        out = out.chunk(like.device_mesh.size(i), d)[coord[i]]
    return out.to(like.to_local().device, copy=True,
                  memory_format=torch.contiguous_format)


@torch.no_grad()
def full_tensor(t: torch.Tensor, like: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """The whole tensor of `t` (a DTensor, or a local shard laid out as the
    DTensor `like`), gathered over the mesh axes it is split over; a
    collective of those groups. A plain tensor is returned as it is."""
    like = t if like is None else like
    if not is_sharded(like):
        return t
    out = local(t)
    for i, d in reversed(_shard_dims(like)):
        parts = dist.gather_over(out, like.device_mesh.get_group(i))
        out = torch.cat(list(parts.unbind(0)), d)
    return out


def shard_key(t: torch.Tensor) -> int:
    """Which shard of `t` this rank holds (0 for a replicated tensor): the
    ranks of one key must hold the same bits."""
    if not is_sharded(t):
        return 0
    coord = t.device_mesh.get_coordinate()
    key = 0
    for i, _ in _shard_dims(t):
        key = key * t.device_mesh.size(i) + coord[i] + 1
    return key


# --------------------------------------------------------------------------
# applying the plan
# --------------------------------------------------------------------------

def is_fsdp(module: Optional[nn.Module]) -> bool:
    from torch.distributed.fsdp import FSDPModule
    return isinstance(module, FSDPModule)


def reshard(*modules: Optional[nn.Module]):
    """Free the gathered parameters of FSDP roots, so their parameters are
    the local shards again (the EMA and the checks read those)."""
    for m in modules:
        if is_fsdp(m):
            m.reshard()


def _units(module: nn.Module) -> List[nn.Module]:
    """The FSDP units below the root: the backbone's stages of a detector
    (none for other modules). The encoder and decoder layers join the
    root's unit: `model.remat` checkpoints each layer's call, and a unit of
    its own would run FSDP's hooks inside the checkpointed region, whose
    recompute then replays another sequence of operations than its forward
    (the layers are ~14 M parameters at full width, gathered with the
    root's)."""
    backbone = getattr(module, "backbone", None)
    if backbone is None:
        return []
    return [getattr(backbone, f"layer{i}") for i in range(1, 5)
            if hasattr(backbone, f"layer{i}")]


def apply_tp(module: nn.Module, mesh):
    """ColwiseParallel on every `linear1` and RowwiseParallel on every
    `linear2` of the encoder and decoder layers, over the `model` axis."""
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel,
                                                   parallelize_module)
    head = getattr(module, "bbox_head", None)
    if head is None:
        return
    tr = head.transformer
    for layer in list(tr.encoder.layers) + list(tr.decoder.layers):
        parallelize_module(layer, mesh["model"],
                           {"linear1": ColwiseParallel(),
                            "linear2": RowwiseParallel()})


def apply_fsdp(module: nn.Module, specs: Dict[str, Spec], mesh):
    """fully_shard per unit, then the root, over the `data` axis: the
    leaves whose spec names "data" shard at that dim; every other leaf is
    ignored by FSDP (replicated, or TP's)."""
    from torch.distributed.fsdp import (fully_shard,
                                        register_fsdp_forward_method)
    from torch.distributed.tensor import Shard
    params = dict(module.named_parameters())
    dims = {id(params[n]): spec.index("data") for n, spec in specs.items()
            if "data" in spec and n not in READ_OUTSIDE_FORWARD}
    ignored = {p for p in params.values() if id(p) not in dims}

    def placement(p):
        return Shard(dims[id(p)])

    for unit in _units(module) + [module]:
        fully_shard(unit, mesh=mesh["data"], shard_placement_fn=placement,
                    ignored_params=ignored)
        # a sum over the ranks, as data parallel's; plain ReduceOp.SUM
        unit.set_force_sum_reduction_for_comms(True)
        unit.set_gradient_divide_factor(1.0)
    for name in FORWARD_METHODS:
        if hasattr(module, name):
            register_fsdp_forward_method(module, name)


def is_laid_out(module: nn.Module) -> bool:
    """Whether `shard_module` split some of the module's parameters."""
    return getattr(module, "_laid_out", False)


def shard_module(module: nn.Module, mesh, fsdp: bool, tp: int):
    """`module` laid out by `plan` on `mesh`, in place."""
    specs = plan(module, mesh.size(0), tp, fsdp)
    if tp > 1:
        odd = [n for n, p in module.named_parameters()
               if n.split(".")[-2] in ("linear1", "linear2")
               and n.endswith("weight") and "model" not in specs[n]]
        if odd:
            raise ValueError(f"tp={tp} does not divide the FFN width of "
                             f"{odd[0]}")
        apply_tp(module, mesh)
    if fsdp and mesh.size(0) > 1:
        apply_fsdp(module, specs, mesh)
    module._laid_out = any(is_sharded(p) for p in module.parameters())
    return module


def shard_state(state, mesh, fsdp: bool, tp: int):
    """The train state laid out on `mesh` (from `dist.make_mesh`), in
    place: the student, the teacher and the Projector by `plan`, and the
    optimizer rebuilt over the local shards with its moments cut from the
    full ones. Every rank must hold the same full state (after
    `dist.broadcast_state`). A no-op without a mesh (one process)."""
    if mesh is None or (not fsdp and tp <= 1):
        return state
    moments = state.optimizer.moments_by_name()
    for m in (state.model, state.teacher, state.projector):
        if m is not None:
            shard_module(m, mesh, fsdp, tp)
    state.optimizer = state.optimizer.rebuilt(moments)
    return state


def local_state_bytes(state) -> int:
    """Bytes of this rank's share of the state: parameters, gradients,
    Adam moments and the teacher (local shards only). A trainable parameter
    counts one gradient of its local size whether the step has made it yet
    or not, on every layout alike."""
    total = 0
    seen = set()
    for m in (state.model, state.teacher, state.projector):
        if m is None:
            continue
        for p in m.parameters():
            if id(p) in seen:
                continue
            seen.add(id(p))
            t = local(p)
            total += t.numel() * t.element_size() * (
                2 if p.requires_grad else 1)
    for st in state.optimizer.adamw.state.values():
        for v in st.values():
            if isinstance(v, torch.Tensor):
                total += v.numel() * v.element_size()
    return total
