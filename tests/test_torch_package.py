"""The packaged serving program (`tools/export_model.py --package`), the
C++ MSDA operator's schema and the serving runner, on the CPU.

* The schema that `csrc/msda_op.cpp` defines equals the Python operator's
  letter for letter: the packaged program calls MSDA by that schema, and
  the runner's C++ operator must answer it.
* The export CLI's `--package` writes an AOTInductor package and `--load`
  runs either kind of artifact.
* At the TINY width of tests/test_torch_export.py (float32, weights from
  a `.pth`): the CPU package of the top-k and of the NMS program against
  eager port `predict` and against the JAX `make_predict_fn`, both within
  rtol/atol 1e-4 (the JAX export test's tolerance: Inductor fuses and
  reorders float32 sums), labels exactly. The package compile costs about
  a minute per program here, so these cases are `slow`.
* The runner (`csrc/serve_main.cpp`, built by g++ against the CPU
  libtorch) runs a toy package without Python: no libpython in its
  `ldd`, an emptied environment, outputs equal to the Python-loaded
  package's to the bit, through the documented request and output
  layouts. MSDA's C++ operator launches the CUDA kernel only, so the
  runner's MSDA path runs on the card (`chip_smoke.py` phase 9b,
  tests/test_torch_msda_op_cuda.py).
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from semi_detr_tpu.models import inference as jax_inference
from semi_detr_tpu_torch.models.inference import predict
from semi_detr_tpu_torch.ops import ms_deform_attn_cuda, msda_cpp
from semi_detr_tpu_torch.tools import export_model, serve_runner

from test_torch_detector import build_pair
from test_torch_export import BUCKET, CONFIG, TINY, TOL, _cfg_options, \
    _request


def test_cpp_schema_is_the_python_operators():
    schema = str(torch.ops.semi_detr.ms_deform_attn.default._schema)
    assert schema == "semi_detr::" + msda_cpp.schema_in_source()
    assert ms_deform_attn_cuda.ms_deform_attn_op._opoverload is \
        torch.ops.semi_detr.ms_deform_attn.default


def test_cli_has_the_package_option_and_loads_either_kind(monkeypatch,
                                                          tmp_path):
    """`--package` routes the export through `package_program`, `--load`
    through `load_program`, which tells the kinds apart by contents."""
    calls = []
    monkeypatch.setattr(export_model, "build_teacher", lambda args: "det")
    monkeypatch.setattr(export_model, "export_program",
                        lambda det, b, bucket, nms: ("ep", b, bucket, nms))
    monkeypatch.setattr(export_model, "package_program",
                        lambda ep, path: (calls.append(("package", ep)),
                                          open(path, "wb").close()))
    monkeypatch.setattr(torch.export, "save",
                        lambda ep, path: calls.append(("save", ep)) or
                        open(path, "wb").close())
    out = str(tmp_path / "m.pt2")
    base = [CONFIG, "--out", out, "--device", "cpu", "--bucket", "64,96"]
    export_model.main(base + ["--package", "--with-nms"])
    export_model.main(base)
    assert calls == [("package", ("ep", 1, (64, 96), True)),
                     ("save", ("ep", 1, (64, 96), False))]
    loaded = []
    monkeypatch.setattr(export_model, "load_program",
                        lambda path: loaded.append(path) or "program")
    monkeypatch.setattr(export_model, "is_package", lambda path: True)
    assert export_model.main([CONFIG, "--load", out, "--device", "cpu"]) \
        == "program"
    assert loaded == [out]


class _Toy(torch.nn.Module):
    """A serving-shaped program without MSDA: (images uint8, img_hw int32)
    -> (float32, float32, int32)."""

    def forward(self, images, img_hw):
        x = images.float().mean((1, 2))
        return (x * img_hw[:, :1].float(), x.sum(1),
                (x > 100).to(torch.int32))


@pytest.fixture(scope="module")
def toy_artifacts(tmp_path_factory):
    """(package path, torch.export path) of the toy at 16x24."""
    tmp = tmp_path_factory.mktemp("toy")
    ex = (torch.zeros((1, 16, 24, 3), dtype=torch.uint8),
          torch.tensor([[16, 24]], dtype=torch.int32))
    ep = torch.export.export(_Toy(), ex)
    pkg, pt2 = str(tmp / "toy_pkg.pt2"), str(tmp / "toy.pt2")
    export_model.package_program(ep, pkg)
    torch.export.save(ep, pt2)
    return pkg, pt2


def test_load_program_tells_the_kinds_apart(toy_artifacts):
    pkg, pt2 = toy_artifacts
    assert export_model.is_package(pkg) and not export_model.is_package(pt2)
    args = (torch.randint(0, 256, (1, 16, 24, 3), dtype=torch.uint8),
            torch.tensor([[10, 20]], dtype=torch.int32))
    want = _Toy()(*args)
    for path in (pkg, pt2):
        got = export_model.load_program(path)(*args)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_runner_runs_a_package_without_python(toy_artifacts, tmp_path):
    pkg, _ = toy_artifacts
    binary, _ = serve_runner.build(cuda=False)
    free, ldd = serve_runner.python_free(binary)
    assert free, ldd
    assert set(serve_runner.runner_env()) <= {"LD_LIBRARY_PATH", "TMPDIR"} | {
        k for k in os.environ if k.startswith("CUDA_")}
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, 256, (1, 16, 24, 3)).astype(np.uint8),
             np.asarray([[16, 24 - 3 * i]], np.int32)) for i in range(3)]
    report = serve_runner.run(pkg, reqs, device="cpu", reps=2)
    assert report["device"] == "cpu" and report["reps"] == 2
    assert report["warm_ms"] > 0 and len(report["runs"]) == 3
    assert all(r["launches"] == {"1": 0, "4": 0, "8": 0}
               for r in report["runs"])
    program = export_model.load_program(pkg)
    for (im, hw), outs in zip(reqs, report["outputs"]):
        want = program(torch.from_numpy(im), torch.from_numpy(hw))
        assert len(outs) == len(want)
        for g, w in zip(outs, want):
            assert g.dtype == w.numpy().dtype and g.shape == tuple(w.shape)
            np.testing.assert_array_equal(g, w.numpy())


def test_request_and_output_layouts_round_trip(tmp_path):
    """The request file is the layout serve_main.cpp reads; the output
    reader takes each dtype code the runner writes."""
    rng = np.random.RandomState(1)
    reqs = [(rng.randint(0, 256, (2, 5, 7, 3)).astype(np.uint8),
             rng.randint(1, 9, (2, 2)).astype(np.int32)) for _ in range(2)]
    path = str(tmp_path / "req.bin")
    serve_runner.pack_requests(path, reqs)
    data = open(path, "rb").read()
    assert data[:8] == serve_runner.REQUEST_MAGIC
    assert list(np.frombuffer(data, "<i4", 4, 8)) == [2, 2, 5, 7]
    assert len(data) == 24 + 2 * (2 * 5 * 7 * 3 + 2 * 2 * 4)
    np.testing.assert_array_equal(
        np.frombuffer(data, np.uint8, 210, 24).reshape(2, 5, 7, 3),
        reqs[0][0])
    arrays = [np.arange(6, dtype=np.float32).reshape(2, 3),
              np.asarray([[1, -2]], np.int32), np.asarray([7], np.int64)]
    body = serve_runner.OUTPUT_MAGIC + np.asarray([2, len(arrays)],
                                                  "<i4").tobytes()
    for _ in range(2):
        for code, a in enumerate(arrays):
            body += np.asarray([code, a.ndim], "<i4").tobytes()
            body += np.asarray(a.shape, "<i8").tobytes() + a.tobytes()
    out = str(tmp_path / "out.bin")
    open(out, "wb").write(body)
    runs = serve_runner.read_outputs(out)
    assert len(runs) == 2
    for got in runs:
        for g, a in zip(got, arrays):
            assert g.dtype == a.dtype
            np.testing.assert_array_equal(g, a)


@pytest.fixture(scope="module")
def packaged(tmp_path_factory):
    """(jax detector, jax variables, eager port detector, {use_nms: loaded
    package}), the packages written by the CLI from a .pth."""
    jax_det, jax_vars, port = build_pair(seed=3, cfg_kw=TINY)
    tmp = tmp_path_factory.mktemp("package")
    ckpt = str(tmp / "tiny.pth")
    torch.save({"state_dict": port.state_dict()}, ckpt)
    programs = {}
    for use_nms in (False, True):
        out = str(tmp / f"tiny_{'nms' if use_nms else 'topk'}_pkg.pt2")
        argv = [CONFIG, "--checkpoint", ckpt, "--out", out, "--device",
                "cpu", "--bucket", ",".join(map(str, BUCKET)), "--package",
                "--cfg-options", *_cfg_options()]
        export_model.main(argv + (["--with-nms"] if use_nms else []))
        assert export_model.is_package(out)
        programs[use_nms] = export_model.main(
            [CONFIG, "--load", out, "--device", "cpu", "--selftest",
             "--bucket", ",".join(map(str, BUCKET))])
    return jax_det, jax_vars, port, programs


@pytest.mark.slow
@pytest.mark.parametrize("use_nms", [False, True], ids=["topk", "nms"])
@pytest.mark.parametrize("hw", [(64, 96), (50, 77)])
def test_package_matches_eager_port_and_jax(packaged, use_nms, hw):
    jax_det, jax_vars, port, programs = packaged
    img, img_hw = _request(11, hw)
    args = (torch.from_numpy(img), torch.from_numpy(img_hw))
    want = predict(port, *args, use_nms=use_nms)
    ms_deform_attn_cuda.ms_deform_attn_cuda.launches = 0
    with torch.inference_mode():
        got = programs[use_nms](*args)
    # on the CPU the op takes its plain version: no kernel launch
    assert ms_deform_attn_cuda.ms_deform_attn_cuda.launches == 0
    ref = jax_inference.make_predict_fn(jax_det, use_nms=use_nms)(
        jax_vars, jnp.asarray(img), jnp.asarray(img_hw))
    boxes, scores, labels = (t.numpy() for t in got)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
    np.testing.assert_array_equal(labels, want[2].numpy())
    np.testing.assert_allclose(scores, want[1].numpy(), **TOL)
    np.testing.assert_allclose(boxes, want[0].numpy(), **TOL)
    np.testing.assert_array_equal(labels, np.asarray(ref[2]))
    np.testing.assert_allclose(scores, np.asarray(ref[1]), **TOL)
    np.testing.assert_allclose(boxes, np.asarray(ref[0]), **TOL)
    if use_nms:
        assert int((scores > 0).sum()) > 0
