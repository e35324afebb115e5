"""The C++ MSDA operator library (`csrc/msda_op.cpp`, built by
`ops/msda_cpp.py`) against the Python operator, on the card.

The library registers `semi_detr::ms_deform_attn` itself, so it is loaded
in a child process that never imports `ops/ms_deform_attn_cuda.py` (two
registrations of one schema collide). The child runs the C++ operator on
seeded inputs and reads the library's launch counts; this process runs
the Python operator on the same inputs. Both launch the same forward
kernel through the same instance, so the outputs must be equal to the
bit. Skips without a CUDA device. Imports neither JAX nor the JAX
package:

    python -m pytest --noconftest tests/test_torch_msda_op_cuda.py -q
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

SHAPES = ((12, 16), (6, 8), (3, 4))
S = sum(h * w for h, w in SHAPES)
# (case, Lq, M, D, dtype): the vector instances (8 bf16 or 4 float32
# channels per lane) and the element instance (D = 5)
CASES = (("bf16", 37, 8, 32, "bfloat16", 8), ("f32", 37, 8, 32, "float32", 4),
         ("odd_d", 9, 4, 5, "float32", 1))

CHILD = r"""
import ctypes, json, sys
import numpy as np, torch
lib_path, tmp, cases = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
torch.ops.load_library(lib_path)
counts = ctypes.CDLL(lib_path)
counts.sdt_msda_op_launches.restype = ctypes.c_longlong
shapes = [int(v) for hw in json.loads(sys.argv[4]) for v in hw]
res = {}
for name, *_ in cases:
    d = np.load(f"{tmp}/{name}.npz")
    dtype = getattr(torch, str(d["dtype"]))
    v = torch.from_numpy(d["value"]).cuda().to(dtype)
    loc = torch.from_numpy(d["loc"]).cuda()
    w = torch.from_numpy(d["attn"]).cuda()
    counts.sdt_msda_op_reset()
    out = torch.ops.semi_detr.ms_deform_attn(v, shapes, loc, w)
    torch.cuda.synchronize()
    res[name] = {str(k): counts.sdt_msda_op_launches(k) for k in (1, 4, 8)}
    np.save(f"{tmp}/{name}_out.npy", out.float().cpu().numpy())
try:
    torch.ops.semi_detr.ms_deform_attn(v.cpu(), shapes, loc.cpu(), w.cpu())
    res["cpu"] = "ran"
except Exception as e:
    res["cpu"] = type(e).__name__ + ": " + str(e).splitlines()[0]
print(json.dumps(res))
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_cpp_operator_equals_python_operator(cuda, tmp_path):
    from semi_detr_tpu_torch.ops import msda_cpp
    from semi_detr_tpu_torch.ops import ms_deform_attn_cuda as msda
    lib, _ = msda_cpp.build()
    inputs = {}
    for i, (name, lq, m, d, dtype, _) in enumerate(CASES):
        rng = np.random.RandomState(i)
        value = rng.randn(1, S, m, d).astype(np.float32)
        loc = rng.uniform(-0.2, 1.2, (1, lq, m, len(SHAPES), 4, 2)).astype(
            np.float32)
        attn = rng.rand(1, lq, m, len(SHAPES), 4).astype(np.float32)
        np.savez(tmp_path / f"{name}.npz", value=value, loc=loc, attn=attn,
                 dtype=dtype)
        inputs[name] = (value, loc, attn, dtype)
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, lib, str(tmp_path),
         json.dumps(CASES), json.dumps(SHAPES)],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["cpu"] != "ran" and "CPU" in res["cpu"], res["cpu"]
    for name, _, _, _, _, width in CASES:
        value, loc, attn, dtype = inputs[name]
        v = torch.from_numpy(value).cuda().to(getattr(torch, dtype))
        msda.ms_deform_attn_cuda.launches_by_width.clear()
        want = msda.ms_deform_attn_op(
            v, msda.flat_shapes(SHAPES), torch.from_numpy(loc).cuda(),
            torch.from_numpy(attn).cuda()).float().cpu().numpy()
        assert dict(msda.ms_deform_attn_cuda.launches_by_width) == {width: 1}
        assert res[name] == {str(k): int(k == width) for k in (1, 4, 8)}, (
            name, res[name])
        np.testing.assert_array_equal(
            np.load(tmp_path / f"{name}_out.npy"), want, err_msg=name)
