"""`data.image_io.write_image` against `cv2.imwrite`, and the image demo's
output names and formats against the JAX demo's.

The JAX demo (`demo/image_demo.py`) writes each render under its input's
own name with `cv2.imwrite`, so in the input's format. The port writes
what cv2 5.0 writes for a colour image of every extension it reads:

* .bmp, .ppm, .pnm: cv2's bytes (numpy); .jpg / .jpeg: cv2's bytes (the
  host library's JPEG encoder); .tif / .tiff: cv2's tags, LZW with the
  horizontal predictor, and its bytes under 3,334 pixels of width (the
  host library's encoder); .webp: lossless, read back exact by cv2 and by
  the port's own decoder; .png: read back exact;
* .pgm and .pbm: nothing, as cv2 refuses a colour image there (its
  reason on stderr);
* .avif, which cv2 writes, raises naming the format, "not ported";
  anything else raises (.pfm, .ras / .sr, .pam, .hdr / .pic and .gif:
  test_torch_image_write_formats.py; .jp2: test_torch_jp2_write.py).
"""
import os

import cv2
import numpy as np
import pytest
import torch

from semi_detr_tpu_torch import native
from semi_detr_tpu_torch.data import image_io

BYTES_EQUAL = ("bmp", "ppm", "pnm", "jpg", "jpeg", "tif", "tiff")
LOSSLESS = ("bmp", "ppm", "pnm", "tif", "tiff", "webp", "png")
PICTURES = {"noise_37x53": (37, 53), "smooth_100x200": (100, 200),
            "flat_1x1": (1, 1), "gray_2x3": (2, 3),
            "short_counts_5x1000": (5, 1000), "few_64x64": (64, 64)}


def picture(name):
    h, w = PICTURES[name]
    rs = np.random.RandomState(sum(map(ord, name)))
    if name.startswith("noise"):
        return rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    if name.startswith("flat"):
        return np.full((h, w, 3), (12, 200, 7), np.uint8)
    if name.startswith("gray"):
        return np.full((h, w, 3), 9, np.uint8)
    if name.startswith("few"):
        return (rs.randint(0, 3, (h, w, 3)) * 100).astype(np.uint8)
    ys, xs = np.mgrid[0:h, 0:w]
    return np.stack([(3 * xs) % 256, (2 * ys) % 256, (xs + ys) % 256],
                    -1).astype(np.uint8)


@pytest.mark.parametrize("ext", ["bmp", "ppm", "pnm", "tif", "tiff", "webp",
                                 "jpg", "jpeg", "png"])
@pytest.mark.parametrize("name", list(PICTURES))
def test_write_image_is_cv2_imwrite(tmp_path, ext, name):
    img = picture(name)
    ours = image_io.write_image(str(tmp_path / f"port.{ext}"), img)
    theirs = str(tmp_path / f"cv2.{ext}")
    assert cv2.imwrite(theirs, img[..., ::-1].copy())
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        a, b = f.read(), g.read()
    if ext in BYTES_EQUAL:
        assert a == b
    by_cv2 = cv2.imread(ours, cv2.IMREAD_COLOR)[..., ::-1]
    by_port = image_io.read_image(ours)
    if ext in LOSSLESS:
        np.testing.assert_array_equal(by_cv2, img)
        np.testing.assert_array_equal(by_port, img)
    else:
        np.testing.assert_array_equal(by_port, cv2.imread(
            theirs, cv2.IMREAD_COLOR)[..., ::-1])


@pytest.mark.parametrize("ext", ["tif", "webp"])
def test_large_tiff_and_webp_read_back(tmp_path, ext):
    """A 480x640 picture (TIFF: 120 strips) and a 3,400-wide one (TIFF:
    a strip of one row past libtiff's 10,000-byte ratio check)."""
    for h, w in ((480, 640), (3, 3400)):
        rs = np.random.RandomState(w)
        ys, xs = np.mgrid[0:h, 0:w]
        img = ((xs // 3 + ys // 2)[..., None] + 60 * np.arange(3)
               + rs.randint(0, 40, (h, w, 3))).astype(np.uint8)
        path = image_io.write_image(str(tmp_path / f"a.{ext}"), img)
        np.testing.assert_array_equal(image_io.read_image(path), img)
        np.testing.assert_array_equal(
            cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1], img)


def test_tiff_tags_are_cv2s(tmp_path):
    """The tags of cv2.imwrite's TIFF: LZW, RGB, predictor 2, ~8 KiB
    strips."""
    import struct
    img = picture("smooth_100x200")
    path = image_io.write_image(str(tmp_path / "a.tif"), img)
    with open(path, "rb") as f:
        b = f.read()
    assert b[:4] == b"II*\0"
    off = struct.unpack("<I", b[4:8])[0]
    n = struct.unpack("<H", b[off:off + 2])[0]
    tags = {}
    for i in range(n):
        tag, typ, cnt, val = struct.unpack(
            "<HHII", b[off + 2 + 12 * i:off + 14 + 12 * i])
        tags[tag] = (typ, cnt, val if typ == 4 or cnt > 1 else val & 0xffff)
    assert sorted(tags) == [256, 257, 258, 259, 262, 273, 277, 278, 279,
                            284, 317, 339]
    assert tags[259][2] == 5 and tags[262][2] == 2 and tags[317][2] == 2
    assert tags[278][2] == 8192 // (3 * 200) and tags[273][1] == 8


@pytest.mark.parametrize("ext,reason", [
    ("pgm", "Portable bitmap(.pgm) expects gray image"),
    ("pbm", "For portable bitmap(.pbm) type must be CV_8UC1")])
def test_pgm_and_pbm_write_nothing(tmp_path, capsys, ext, reason):
    img = picture("noise_37x53")
    path = str(tmp_path / f"a.{ext}")
    assert image_io.write_image(path, img) is None
    assert not os.path.exists(path)
    assert reason in capsys.readouterr().err
    assert not cv2.imwrite(str(tmp_path / f"b.{ext}"), img)
    assert not os.path.exists(str(tmp_path / f"b.{ext}"))


@pytest.mark.parametrize("name", ["a.xyz", "a.j2k", "a.avif", "noext"])
def test_an_extension_without_encoder_raises(tmp_path, name):
    with pytest.raises(ValueError, match="no encoder"):
        image_io.write_image(str(tmp_path / name), picture("flat_1x1"))
    assert not os.path.exists(str(tmp_path / name))


def test_output_path_keeps_the_name():
    from semi_detr_tpu_torch.tools.image_demo import output_path
    for name in ("b.tif", "b.JPG", "c.webp", "d.pgm", "e"):
        assert output_path(f"a/{name}", "out") == os.path.join("out", name)


DEMO_INPUTS = ("colour_420.jpg", "bmp_24.bmp", "pnm_p6_100.ppm",
               "tiff_lzw_predictor.tif", "webp_lossy.webp",
               "pnm_p2_100.pgm", "other_pfm.pfm", "ras_pal8.ras",
               "pam_rgb16.pam", "hdr_rle.hdr", "other_gif.gif",
               "j2k_irr.jp2")
SIGNATURES = {"jpg": b"\xff\xd8", "bmp": b"BM", "ppm": b"P6",
              "tif": b"II*\0", "webp": b"RIFF", "pfm": b"PF",
              "ras": b"\x59\xa6\x6a\x95", "pam": b"P7",
              "hdr": b"#?RADIANCE", "gif": b"GIF89a",
              "jp2": b"\0\0\0\x0cjP  \r\n\x87\n"}


def test_demo_keeps_each_inputs_name_and_format(tmp_path):
    """The demo on fixtures of twelve formats with a tiny seeded detector:
    each render under its input's name, in its format (the .pgm input's
    render is not written, as cv2 writes none), with the pixels the JAX
    save_result draws for the same detections (and for PFM, Sun raster,
    PAM, HDR, GIF and JPEG 2000 its bytes, but a Sun raster's last pad
    byte)."""
    import shutil

    from semi_detr_tpu.api import save_result as jax_save_result
    from semi_detr_tpu_torch.api import init_detector
    from semi_detr_tpu_torch.tools import image_demo

    cfg = tmp_path / "tiny.py"
    cfg.write_text("model = dict(num_classes=80, num_queries=20, d_model=32,"
                   " n_heads=2, num_encoder_layers=1, num_decoder_layers=1, "
                   "d_ffn=64)\n")
    predictor = init_detector(str(cfg), None, device="cpu", seed=3)
    ckpt = str(tmp_path / "det.pth")
    torch.save({"state_dict": predictor.detector.state_dict()}, ckpt)
    src = tmp_path / "in"
    src.mkdir()
    for name in DEMO_INPUTS:
        shutil.copy(os.path.join(native.FIXTURES, name), src)
    out = image_demo.main([str(src / "*"), str(cfg), "--checkpoint", ckpt,
                           "--output-dir", str(tmp_path / "out"),
                           "--score-thr", "0.0", "--device", "cpu"])
    assert [os.path.basename(p) for p in out] == sorted(DEMO_INPUTS)
    written = sorted(os.listdir(tmp_path / "out"))
    assert written == sorted(n for n in DEMO_INPUTS
                             if not n.endswith(".pgm"))
    jax_dir = tmp_path / "jax"
    for name in DEMO_INPUTS:
        img = image_io.read_image(str(src / name))
        result = predictor(img, score_thr=0.0)
        want = str(jax_dir / name)
        jax_save_result(img, result, predictor.class_names, want,
                        score_thr=0.0)
        got = str(tmp_path / "out" / name)
        if name.endswith(".pgm"):
            assert not os.path.exists(want) and not os.path.exists(got)
            continue
        with open(got, "rb") as f, open(want, "rb") as g:
            a, b = f.read(), g.read()
        ext = name.rsplit(".")[-1]
        assert a.startswith(SIGNATURES[ext]), name
        if ext in ("pfm", "pam", "hdr", "gif", "jp2"):
            assert a == b, name
        elif ext == "ras":
            assert a[:-1] == b[:-1], name
        np.testing.assert_array_equal(
            image_io.read_image(got),
            cv2.imread(want, cv2.IMREAD_COLOR)[..., ::-1], err_msg=name)
