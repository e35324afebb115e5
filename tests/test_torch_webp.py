"""WebP: the host library's decoder (`native/webp_host.cpp`) against the
JAX package's loader, which hands WebP files to `cv2.imread(path,
IMREAD_COLOR)` (libwebp inside OpenCV, then the EXIF orientation).

The committed fixtures (`webp_*`, with `formats.json`: lossless, colour
indexing, lossy, lossy with an ALPH chunk, EXIF orientations, an
animation, and 480x640 lossy and lossless pictures) decode to their stored
cv2 pixels and to the JAX loader's at max abs 0. Files that Pillow's
libwebp writes from seeded pictures, at every encoder method and a range
of qualities and sizes (1x1 up to 64x48, noise and smooth pictures), are
held to cv2.imread at max abs 0, and to the machine's libwebp itself
(`tests/webp_tool.cpp`, WebPDecodeRGB: the same pixels before cv2's
orientation). Damaged copies raise naming the file.
"""
import io
import os
import struct
import subprocess
import tempfile

import numpy as np
import pytest
from PIL import Image

from _format_checks import (check_against_cv2, check_damaged, check_fixture,
                            fixture_params, read)
from format_writers import picture
from semi_detr_tpu_torch import native


@pytest.mark.parametrize("name,entry", fixture_params(("webp_",)))
def test_fixture(name, entry):
    check_fixture(name, entry)


def _webp(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


SIZES = [(1, 1), (2, 3), (16, 16), (17, 33), (37, 53), (64, 48)]


def _pictures(h, w):
    rs = np.random.RandomState(h * 100 + w)
    noise = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    return {"smooth": picture(h, w, h + w), "noise": noise}


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("method", [0, 4, 6])
def test_lossless(h, w, method, tmp_path):
    for kind, img in _pictures(h, w).items():
        assert check_against_cv2(_webp(img, lossless=True, method=method),
                                 tmp_path, f"{kind}.webp")
    levels = (img.astype(int).sum(2) % 3 * 100).astype(np.uint8)
    assert check_against_cv2(_webp(np.repeat(levels[..., None], 3, 2),
                                   lossless=True, method=method),
                             tmp_path, "palette.webp")


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("quality", [5, 50, 90, 100])
def test_lossy(h, w, quality, tmp_path):
    for kind, img in _pictures(h, w).items():
        assert check_against_cv2(_webp(img, quality=quality), tmp_path,
                                 f"{kind}.webp")


@pytest.mark.parametrize("lossless", [False, True])
def test_alpha_is_dropped_as_it_is(lossless, tmp_path):
    rs = np.random.RandomState(3)
    rgba = np.concatenate([picture(45, 61, 3), rs.randint(
        0, 256, (45, 61, 1)).astype(np.uint8)], 2)
    assert check_against_cv2(_webp(rgba, lossless=lossless, quality=80),
                             tmp_path, "alpha.webp")


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(orientation, tmp_path):
    exif = Image.Exif()
    exif[274] = orientation
    img = picture(37, 53, orientation)
    for kw in ({"lossless": True}, {"quality": 70}):
        data = _webp(img, exif=exif.tobytes(), **kw)
        assert check_against_cv2(data, tmp_path, "o.webp")
        h, w = native.image_size(data)
        assert (h, w) == ((53, 37) if orientation >= 5 else (37, 53))


def test_animation_gives_its_first_frame(tmp_path):
    frames = [Image.fromarray(picture(37, 53, k)) for k in range(3)]
    for lossless in (True, False):
        buf = io.BytesIO()
        frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                       lossless=lossless, duration=100)
        assert check_against_cv2(buf.getvalue(), tmp_path, "anim.webp")


@pytest.fixture(scope="module")
def webp_tool():
    out = os.path.join(tempfile.mkdtemp(prefix="sdt_webp_tool_"), "webp_tool")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "webp_tool.cpp")
    subprocess.run(["g++", "-O1", "-std=c++17", src, "-o", out, "-lwebp"],
                   check=True, capture_output=True)
    return out


def test_libwebp_itself_agrees(webp_tool, tmp_path):
    """The library against the machine's libwebp (a second witness): every
    seeded lossy and lossless picture and the 480x640 fixtures."""
    cases = {f"{k}_{h}x{w}_{q}": _webp(img, quality=q or 80,
                                       lossless=q is None)
             for h, w in SIZES[2:] for k, img in _pictures(h, w).items()
             for q in (None, 30, 95)}
    for name in ("webp_lossy_480x640.webp", "webp_lossless_480x640.webp"):
        cases[name] = read(name)
    for name, data in cases.items():
        src, dst = str(tmp_path / "in.webp"), str(tmp_path / "out.rgb")
        with open(src, "wb") as f:
            f.write(data)
        subprocess.run([webp_tool, "decode", src, dst], check=True)
        with open(dst, "rb") as f:
            raw = f.read()
        w, h = struct.unpack("<ii", raw[:8])
        ref = np.frombuffer(raw[8:], np.uint8).reshape(h, w, 3)
        np.testing.assert_array_equal(native.decode_image(data, name), ref,
                                      err_msg=name)


def test_damaged_copies_raise_naming_the_file():
    lossy = read("webp_lossy.webp")
    check_damaged(lossy[:len(lossy) // 2], "webp_truncated.webp", "RIFF")
    cut = bytearray(lossy[:len(lossy) // 2])
    cut[4:8] = struct.pack("<I", len(cut) - 8)  # a consistent RIFF size
    check_damaged(bytes(cut), "webp_cut_partition.webp", "WebP")
    lossless = bytearray(read("webp_lossless.webp"))
    lossless[40:60] = b"\xff" * 20
    check_damaged(bytes(lossless), "webp_bad_codes.webp", "WebP")
    check_damaged(b"RIFF\x04\0\0\0WEBP", "webp_empty.webp", "RIFF")
