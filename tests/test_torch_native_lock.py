"""The JAX package's host library, first loaded by many processes at once.

`semi_detr_tpu.native` builds `libsdt_dataloader.so` at first use straight
into its own directory with no lock between processes, and caches a failed
load for the life of the process: under pytest-xdist a worker that loaded
the library while another worker's g++ was still writing it got None from
every reference decode. The port's tests reach the library only through
`format_writers.load_jax_native`, which loads it under a lock the workers
share. Here six processes first-load a fresh copy of the package's
directory together, each through that helper; every one must decode.
"""
import os
import shutil
import subprocess
import sys
import time

import cv2
import numpy as np

from format_writers import load_jax_native

TESTS = os.path.dirname(os.path.abspath(__file__))
WORKERS = 6
_WORKER = r"""
import importlib.util, os, sys, time
import numpy as np
sys.path.insert(0, {tests!r})
from format_writers import load_jax_native
spec = importlib.util.spec_from_file_location(
    "jax_native_copy", os.path.join({copy!r}, "__init__.py"))
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
while not os.path.exists({go!r}):
    time.sleep(0.001)
load_jax_native(mod)
with open({png!r}, "rb") as f:
    img = mod.decode_image(f.read())
print("none" if img is None else "%d %d %d %d" % (img.shape + (int(img.sum()),)))
"""


def test_jax_library_first_loads_in_six_processes(tmp_path):
    from semi_detr_tpu import native as jax_native_module
    src = os.path.dirname(jax_native_module.__file__)
    copy = tmp_path / "native"
    copy.mkdir()
    for name in ("__init__.py", "dataloader.cpp"):
        shutil.copy(os.path.join(src, name), copy / name)
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (23, 37, 3)).astype(np.uint8)
    png = str(tmp_path / "probe.png")
    cv2.imwrite(png, img[..., ::-1])
    go = str(tmp_path / "go")
    code = _WORKER.format(tests=TESTS, copy=str(copy), go=go, png=png)
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(WORKERS)]
    time.sleep(0.5)  # every worker imported, waiting on the file
    open(go, "w").close()
    want = "%d %d %d %d" % (img.shape + (int(img.sum()),))
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-2000:]
        assert out.strip() == want, (out, err[-2000:])
    assert os.path.exists(copy / "libsdt_dataloader.so")


def test_failed_first_load_is_retried(tmp_path):
    """A library that a first load found broken (a file cut short, as a
    build still writing it leaves it) is built anew and loaded; the
    module's cached failure does not stand."""
    from semi_detr_tpu import native as jax_native_module
    import importlib.util
    src = os.path.dirname(jax_native_module.__file__)
    copy = tmp_path / "native"
    copy.mkdir()
    for name in ("__init__.py", "dataloader.cpp"):
        shutil.copy(os.path.join(src, name), copy / name)
    spec = importlib.util.spec_from_file_location(
        "jax_native_cut", str(copy / "__init__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(copy / "libsdt_dataloader.so", "wb") as f:
        f.write(b"\x7fELF" + bytes(60))  # newer than its source, not a library
    assert mod._load() is False           # the package's own load fails
    load_jax_native(mod)
    assert mod._lib
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (9, 11, 3)).astype(np.uint8)
    ok, buf = cv2.imencode(".png", img[..., ::-1])
    np.testing.assert_array_equal(mod.decode_image(buf.tobytes()), img)
