"""Data parallelism over `torch.distributed`: the counterpart of
`semi_detr_tpu/parallel/mesh.py`.

The JAX package trains with one jitted step over a 1-D `data` mesh: the
batch is a global array sharded on axis 0, so "sums over the batch axis ARE
the cross-device reductions, and the GMM cost pool is simply the
(fixed-capacity, masked) global array" (`mesh.py:1-18`). Here each rank
holds its own B images and runs the step eagerly; the step computes what
the JAX step computes on the global batch of W * B images by reducing the
global quantities explicitly, in the same order on every rank:

* the trainable gradients, summed in flat buckets before the global-norm
  clip (`train/optim.py`);
* the loss avg factors and the cls group weights (`models/criterion.py`);
* the CDN partition's largest GT count and each rank's rows of the
  global-batch noise draw (`models/dn.py`);
* the consistency group size and loss denominator, and the Projector's
  masked batch statistics, whose gradient reaches every rank through
  `all_sum_grad` (`models/ssod.py`);
* the GMM cost pool and the logged metrics (`train/ssod.py`).

Without a process group every collective here returns its input (one
process is the global batch); with one, even of world 1, each runs through
the group. The backend follows the device: NCCL for CUDA, gloo for the CPU.
Two ranks on one card run gloo on CUDA tensors: gloo runs all_reduce,
broadcast and all_gather on CUDA tensors itself (each through a host copy
of its own), so no collective here stages a tensor by hand.

The mesh (`make_mesh`, the counterpart of `mesh.make_mesh((dp, mp))`): a
2-D `(data, model)` device mesh over the group, `data = W / tp`. The batch
is split over `data` only, so the `tp` ranks of one model group share one
data shard, and every global-batch collective here (the sums, maxima and
gathers, `all_sum_`, `rank_rows`) runs over this rank's **data** group:
`rank()` and `world()` are the data rank and the data world. Without a mesh
(data parallel) the data group is the world. `world_rank()` and
`world_size()` name the whole group; `is_main()` is world rank 0.
`parallel.sharding` lays the state out over the mesh (FSDP over `data`,
tensor parallelism over `model`).

Not ported: `batch_sharding`, `replicate` and `with_batch_constraint`,
which name XLA shardings and have no meaning for eager tensors (a rank's
tensors are its shard).
"""
from __future__ import annotations

import multiprocessing.connection
import os
import socket
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

# elements per flat bucket of a coalesced collective (64 MiB of float32)
BUCKET_NUMEL = 16 * 2 ** 20


# the (data, model) mesh of `make_mesh`, None without one
_MESH = None


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_rank() -> int:
    """This process's rank in the whole group."""
    return dist.get_rank() if _active() else 0


def world_size() -> int:
    """The whole group's size."""
    return dist.get_world_size() if _active() else 1


def data_group():
    """The process group of this rank's data axis (None: the world)."""
    return None if _MESH is None else _MESH.get_group("data")


def model_group():
    """The process group of this rank's model axis (None without a
    mesh)."""
    return None if _MESH is None else _MESH.get_group("model")


def rank() -> int:
    """This rank's index on the data axis: the shard of the global batch
    it holds."""
    if _MESH is None:
        return world_rank()
    return _MESH.get_local_rank("data")


def world() -> int:
    """The data axis's size: how many shards the global batch has."""
    if _MESH is None:
        return world_size()
    return _MESH.size(0)


def is_main() -> bool:
    return world_rank() == 0


def mesh():
    """The mesh of `make_mesh`, or None."""
    return _MESH


def make_mesh(tp: int = 1, device="cpu"):
    """The `(data, model)` mesh over the group, `data = W / tp`, as the JAX
    trainers' `_build_mesh` makes it (`make_mesh((n // tp, tp))`): raises
    for tp > 1 without a group of more than one process and for W % tp != 0.
    Every collective of this module then runs over the data axis. Returns
    the mesh (None in one process, where there is nothing to lay out).
    `device`: where the ranks' tensors live (the mesh's device type)."""
    global _MESH
    from torch.distributed.device_mesh import init_device_mesh
    n = world_size()
    shape = check_layout(n, tp)
    _MESH = None
    if n > 1:
        _MESH = init_device_mesh(torch.device(device).type, shape,
                                 mesh_dim_names=("data", "model"))
    return _MESH


def check_layout(world: int, tp: int):
    """The mesh shape (data, model) of `world` ranks at `tp`, or the JAX
    `_build_mesh`'s refusals: tp > 1 without more than one process, and a
    tp that does not divide the world."""
    if tp > 1 and world <= 1:
        raise ValueError(f"tp={tp} needs a group of more than one process "
                         "(tensor parallelism splits each model over tp "
                         "ranks)")
    if tp < 1 or world % tp:
        raise ValueError(f"tp={tp} does not divide the world of {world} "
                         "ranks")
    return world // tp, tp


def drop_mesh():
    """Back to the world as the data group (the mesh's groups stay with the
    process group and go with `destroy`). Returns None."""
    global _MESH
    _MESH = None


def backend() -> Optional[str]:
    return dist.get_backend() if _active() else None


def init_distributed(backend: str, device, rank: int, world: int,
                     init_method: str) -> torch.device:
    """Join a process group of `world` ranks as `rank` on `device`
    (`init_method`: "env://" or "tcp://host:port"). A CUDA device must
    exist and becomes the current one. Returns the device."""
    device = torch.device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if device.index is None or device.index >= count:
            raise RuntimeError(f"rank {rank}: device {device} is not one of "
                               f"the {count} CUDA devices")
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return device


def maybe_initialize_distributed(device=None) -> Optional[torch.device]:
    """Join the process group that `torch.distributed.run` describes in the
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT),
    as `semi_detr_tpu.parallel.maybe_initialize_distributed` joins the
    multi-host JAX runtime. A no-op returning None without that
    environment, or when the group exists.

    The device is `device` when it names one (an index, or the CPU), else
    cuda:LOCAL_RANK; the backend is NCCL on CUDA and gloo on the CPU.
    LOCAL_RANK beyond the CUDA devices raises. Returns the device."""
    env = os.environ
    if _active() or "RANK" not in env or "WORLD_SIZE" not in env:
        return None
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
    return init_distributed("nccl" if dev.type == "cuda" else "gloo", dev,
                            int(env["RANK"]), int(env["WORLD_SIZE"]),
                            "env://")


def barrier():
    if not _active():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def destroy():
    drop_mesh()
    if _active():
        dist.destroy_process_group()


def collective_device() -> torch.device:
    """Where the group's collectives take host data: the current card for
    NCCL, else the CPU."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# --------------------------------------------------------------------------
# collectives on device tensors (no host sync)
# --------------------------------------------------------------------------

def all_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over ranks (the input itself without a group)."""
    if not _active():
        return t
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, dist.ReduceOp.SUM, group=data_group())
    return out


def all_max(t: torch.Tensor) -> torch.Tensor:
    """Elementwise max over ranks (the input itself without a group)."""
    if not _active():
        return t
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, dist.ReduceOp.MAX, group=data_group())
    return out


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """(W, *t.shape): every rank's `t`, in rank order (t[None] without a
    group). Every rank passes the same shape and dtype."""
    if not _active():
        return t[None]
    return gather_over(t, data_group())


def gather_over(t: torch.Tensor, group=None) -> torch.Tensor:
    """(group size, *t.shape): every member's `t` in group rank order
    (group None: the world)."""
    t = t.detach().contiguous()
    parts = [torch.empty_like(t)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts)


def all_cat(t: torch.Tensor) -> torch.Tensor:
    """The ranks' `t` concatenated on axis 0 in rank order: a rank's shard
    of a global batch array back to the global array."""
    return all_gather(t).flatten(0, 1)


class _AllSum(torch.autograd.Function):
    """y = sum over ranks of x; dL/dx = sum over ranks of dL_r/dy, the
    gradient of the global loss (the sum of the ranks' losses)."""

    @staticmethod
    def forward(ctx, x):
        return all_sum(x)

    @staticmethod
    def backward(ctx, grad):
        return all_sum(grad)


def all_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """`all_sum` with a gradient: for statistics of the global batch that
    the loss differentiates through (the Projector's batch norms)."""
    return _AllSum.apply(t) if _active() else t


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Consecutive runs of one device and dtype, at most BUCKET_NUMEL
    elements each (a larger tensor is a bucket of its own)."""
    out: List[List[torch.Tensor]] = []
    size = 0
    for t in tensors:
        last = out[-1][-1] if out else None
        if (last is None or last.device != t.device or last.dtype != t.dtype
                or size + t.numel() > BUCKET_NUMEL):
            out.append([])
            size = 0
        out[-1].append(t)
        size += t.numel()
    return out


def _coalesced_(tensors: Sequence[torch.Tensor], op: Callable):
    """Run the in-place collective `op` over `tensors` in flat buckets."""
    for bucket in _buckets(tensors):
        flat = _flatten_dense_tensors(bucket)
        op(flat)
        for t, v in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            t.copy_(v)


def all_sum_(tensors: Sequence[torch.Tensor]):
    """Sum each tensor over ranks, in place, in flat buckets: the gradient
    reduction of the step."""
    if _active() and tensors:
        g = data_group()
        _coalesced_(tensors, lambda f: dist.all_reduce(f, dist.ReduceOp.SUM,
                                                       group=g))


def align_model_group_(tensors: Sequence[torch.Tensor]):
    """The first rank of this rank's model group's values into the group's
    other ranks, in place (a no-op without a model axis of more than one
    rank). The tp ranks of a model group compute the gradients of the
    leaves they both hold from the same data, but a card's atomic sums (the
    MSDA backward) round them differently on each: without this their
    replicas would drift apart."""
    g = model_group()
    if g is None or dist.get_world_size(g) == 1 or not tensors:
        return
    src = dist.get_global_rank(g, 0)
    _coalesced_(tensors, lambda f: dist.broadcast(f, src, group=g))


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0):
    """World rank `src`'s values into every rank's tensors (over the whole
    group), in place. NCCL takes CUDA tensors only: CPU tensors travel
    through the current card."""
    if not _active() or not tensors:
        return
    on_card = backend() == "nccl"
    dev = collective_device()
    staged = [t.to(dev) if on_card and not t.is_cuda else t for t in tensors]
    _coalesced_(staged, lambda f: dist.broadcast(f, src))
    for t, s in zip(tensors, staged):
        if s is not t:
            t.copy_(s)


def broadcast_state(state, src: int = 0):
    """World rank `src`'s train state (parameters, buffers, teacher,
    projector, optimizer moments and the step) to every rank, in place:
    after init, a warm start or a resume, before `sharding.shard_state` cuts
    every shard from the same full tensors. The ranks' optimizer states
    must have one structure (all fresh, or all restored from one
    checkpoint)."""
    if not _active():
        return state
    tensors = [t.detach() for m in (state.model, state.teacher,
                                    state.projector) if m is not None
               for t in m.state_dict(keep_vars=True).values()]
    adamw = state.optimizer.adamw
    for group in adamw.param_groups:
        for p in group["params"]:
            st = adamw.state.get(p, {})
            tensors += [st[k] for k in sorted(st)
                        if isinstance(st[k], torch.Tensor)]
    step = torch.tensor([state.step], dtype=torch.int64)
    broadcast_([*tensors, step], src)
    state.step = int(step)
    return state


def shard_batch(global_batch: Any, rank: int, world: int):
    """Rank `rank`'s contiguous slice on axis 0 of every array of a batch
    pytree (dicts of numpy arrays or tensors), the per-process shard that
    `semi_detr_tpu.parallel.shard_batch` assembles a global array from."""
    if isinstance(global_batch, dict):
        return {k: shard_batch(v, rank, world)
                for k, v in global_batch.items()}
    n = global_batch.shape[0]
    if n % world:
        raise ValueError(f"batch axis {n} does not split over {world} ranks")
    per = n // world
    return global_batch[rank * per:(rank + 1) * per]


def rank_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global-batch array drawn on every rank (the
    CDN noise): `shard_batch` at this process's rank."""
    return shard_batch(t, rank(), world())


def bit_checksum(t: torch.Tensor) -> torch.Tensor:
    """An int64 of `t`'s bits: the position-weighted sum of its elements'
    bit patterns (a float read as the integer of its width), so it differs
    where one bit of one element does, but for collisions of the weighted
    sum (it wraps on overflow, the same way everywhere)."""
    flat = t.detach().contiguous().reshape(-1)
    if flat.is_floating_point():
        flat = flat.view({2: torch.int16, 4: torch.int32,
                          8: torch.int64}[flat.element_size()])
    w = torch.arange(flat.numel(), dtype=torch.int64,
                     device=flat.device) % 65521 + 1
    return (flat.to(torch.int64) * w).sum()


def assert_replicated(tensors: Sequence[torch.Tensor], what: str,
                      keys: Optional[Sequence[int]] = None):
    """Raise unless the ranks hold the same tensors to the bit (their
    `bit_checksum`s gathered over the whole group and compared). `keys`:
    per tensor, which shard of it this rank holds; only ranks of one key
    are compared (None: every rank holds the whole tensor)."""
    if not _active() or not tensors:
        return
    sums = torch.stack([bit_checksum(t) for t in tensors])
    key = torch.tensor(keys if keys is not None else [0] * len(tensors),
                       dtype=torch.int64, device=sums.device)
    gathered = gather_over(torch.stack([sums, key]).to(
        collective_device())).cpu()
    for i in range(len(tensors)):
        first = {}
        for k, v in zip(gathered[:, 1, i].tolist(),
                        gathered[:, 0, i].tolist()):
            if first.setdefault(k, v) != v:
                raise RuntimeError(f"{what} differs across ranks: checksums "
                                   f"{gathered[:, 0].tolist()}")


# --------------------------------------------------------------------------
# a local group of processes (tests, chip_smoke.py)
# --------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_local(fn: Callable, world: int, args: Sequence = (),
              timeout: float = 120.0):
    """Run fn(rank, world, init_method, *args) in `world` spawned processes
    (init_method "tcp://127.0.0.1:<free port>", for `init_distributed`).

    Every process is joined within `timeout` seconds or killed; raises
    TimeoutError when one outlives it and RuntimeError when one exits
    non-zero (the others are then killed at once: their peers are gone)."""
    ctx = torch.multiprocessing.get_context("spawn")
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=fn, args=(r, world, init_method, *args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {[r for r, p in enumerate(procs) if p.is_alive()]}"
                    f" of {world} still running after {timeout} s")
            # polled as well: with CUDA in the ranks, a sentinel was seen
            # to stay unready after its process had ended
            multiprocessing.connection.wait(
                [p.sentinel for p in procs if p.is_alive()],
                timeout=min(left, 0.5))
            if any(p.exitcode not in (None, 0) for p in procs):
                break
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"ranks exited with codes {codes} (None: "
                               f"killed after a peer failed)")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
