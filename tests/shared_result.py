"""A fixture's result built once per test run and shared by the files that
need it.

Under pytest-xdist's `--dist loadfile` each test file runs whole on one
worker, so a module-scoped fixture that several files use is built once
per file. `shared` builds it once: the first worker to ask builds it under
a file lock in the run's shared temp dir (the parent of each worker's
basetemp, new for every run) and pickles it there; the others wait on the
lock and load it. Within one process the result is kept in memory, so a
run without xdist builds it once too. A build that raises leaves nothing
behind: the next file to ask builds it again and raises the same way.

The pickles are large (the SSOD step's states hold a ResNet-50 several
times over), so each is written with equal arrays stored once (the frozen
weights repeat across the student, the teacher and the steps; JAX arrays
are written as numpy ones) and read back as distinct arrays again, and
removed once `users` processes have taken it.
"""
import fcntl
import hashlib
import os
import pickle
from collections.abc import Mapping

import numpy as np
import torch

_MEMO = {}


def _deduplicated(value):
    """`value` with every array equal to an earlier one replaced by that
    one (pickle then stores it once); JAX arrays become numpy arrays."""
    seen = {}

    def walk(o):
        if isinstance(o, Mapping):
            items = [(k, walk(v)) for k, v in o.items()]
            try:
                return type(o)(items)
            except TypeError:
                return dict(items)
        if isinstance(o, (list, tuple)) and not hasattr(o, "_fields"):
            return type(o)(walk(v) for v in o)
        if isinstance(o, torch.Tensor):
            t = o.detach().contiguous()
            raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() \
                if t.numel() else b""
            key = ("torch", str(t.dtype), tuple(t.shape))
        elif isinstance(o, np.ndarray) or (
                hasattr(o, "__array__") and hasattr(o, "shape")
                and hasattr(o, "dtype")):
            o = np.asarray(o)
            raw = np.ascontiguousarray(o).tobytes()
            key = ("numpy", str(o.dtype), o.shape)
        else:
            return o
        key += (hashlib.sha1(raw).hexdigest(),)
        return seen.setdefault(key, o)
    return walk(value)


def _distinct(value):
    """`value` with each array object that recurs after its first place
    replaced by a copy: the callers may update arrays in place (an
    optimizer's moments), so none may share one."""
    seen = set()

    def walk(o):
        if isinstance(o, Mapping):
            items = [(k, walk(v)) for k, v in o.items()]
            try:
                return type(o)(items)
            except TypeError:
                return dict(items)
        if isinstance(o, (list, tuple)) and not hasattr(o, "_fields"):
            return type(o)(walk(v) for v in o)
        if isinstance(o, (torch.Tensor, np.ndarray)):
            if id(o) in seen:
                return o.clone() if isinstance(o, torch.Tensor) else o.copy()
            seen.add(id(o))
        return o
    return walk(value)


def shared(tmp_path_factory, name, build, users):
    """build() once per test run, across processes; its result. The pickle
    goes once `users` processes (the builder among them) have taken it."""
    if name in _MEMO:
        return _MEMO[name]
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        _MEMO[name] = build()
        return _MEMO[name]
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"shared_{name}.pkl"
    taken = root / f"shared_{name}.taken"
    with open(root / f"shared_{name}.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as f:
                value = _distinct(pickle.load(f))
        else:
            value = build()
            tmp = root / f"shared_{name}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                pickle.dump(_deduplicated(value), f,
                            protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
        count = int(taken.read_text()) + 1 if taken.exists() else 1
        taken.write_text(str(count))
        if count >= users:
            path.unlink()
    _MEMO[name] = value
    return value
