"""12-bit and lossless JPEG: what the JAX loader does with them, and the
port's host library (`native/jpeg_host.cpp`) the same.

The JAX loader's native decoder (libjpeg-turbo 2.1, 8 bits) refuses both
kinds, so they go to `cv2.imread(path, IMREAD_COLOR)` (cv2 5.0,
libjpeg-turbo 3.1). Its mapping, found here from the streams of
`format_writers.jpeg12` and `format_writers.jpeg_lossless` (numpy
encoders; neither cv2 nor Pillow writes these kinds):

* 12-bit streams, sequential (SOF1) or progressive (SOF2): cv2 returns
  nothing, so the JAX loader raises. The library raises too, naming the
  precision (an 8-bit stream from the same encoder decodes, so the
  encoder is sound).
* Lossless (SOF3): cv2 reads streams of 2-8 bits that need no colour
  conversion (libjpeg-turbo converts no colour in lossless mode): three
  components libjpeg's guess calls RGB, given as their samples shifted
  back by the point transform, and four CMYK ones, which cv2 turns to RGB
  as it turns CMYK; then the EXIF orientation. Gray, YCbCr and streams of
  more than 8 bits it refuses. The library decodes the first kinds to
  cv2's pixels at max abs 0, at every predictor (1-7), point transform and
  restart interval, and raises for the others naming why.

The committed fixtures (`jpeg_lossless_*`, `jpeg12_*`) are held the same
way, and to the JAX loader itself.
"""
import numpy as np
import pytest

from _format_checks import (check_against_cv2, check_damaged, check_fixture,
                            fixture_params, read)
from format_writers import jpeg12, jpeg_lossless, picture
from semi_detr_tpu_torch import native

H, W = 37, 53


@pytest.mark.parametrize("name,entry",
                         fixture_params(("jpeg_lossless_", "jpeg12_")))
def test_fixture(name, entry):
    check_fixture(name, entry)


@pytest.mark.parametrize("precision", [2, 5, 8])
@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("components", [3, 4])
def test_lossless_read_by_cv2(precision, predictor, components, tmp_path):
    rs = np.random.RandomState(precision * 10 + predictor)
    for point in (0, 1) if precision > 2 else (0,):
        a = rs.randint(0, 1 << precision, (H, W, components))
        data = jpeg_lossless(a, precision, predictor, point)
        assert native.jpeg_host_kind(data) == "lossless"
        assert check_against_cv2(data, tmp_path, "lossless.jpg")


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("orientation", [0, 3, 6, 8])
def test_lossless_restarts_and_orientation(rows, orientation, tmp_path):
    a = picture(H, W, rows).astype(np.int64)
    data = jpeg_lossless(a, 8, 6, restart=rows * W, orientation=orientation)
    assert check_against_cv2(data, tmp_path, "rst.jpg")


@pytest.mark.parametrize("precision,colour,components", [
    (8, "gray", 1), (8, "ycbcr", 3), (5, "gray", 1), (12, "rgb", 3),
    (12, "gray", 1), (16, "rgb", 3), (16, "rgb", 4)])
def test_lossless_cv2_refuses(precision, colour, components, tmp_path):
    a = np.random.RandomState(precision).randint(
        0, 1 << precision, (H, W, components))
    data = jpeg_lossless(a, precision, 1, colour=colour)
    assert native.jpeg_host_kind(data) is None
    assert not check_against_cv2(data, tmp_path, "refused.jpg")
    with pytest.raises(native.ImageDecodeError, match="cv2 refuses it too"):
        native.decode_image(data, "refused.jpg")


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("colour,factors", [
    ("ycbcr", ((2, 2), (1, 1), (1, 1))), ("rgb", ((1, 1),) * 3),
    ("gray", ((1, 1),))])
def test_12_bit_refused_as_cv2_refuses_it(progressive, colour, factors,
                                          tmp_path):
    nc = len(factors)
    a = picture(H, W, 7)[..., :nc].astype(np.int64)
    twelve = jpeg12(a * 16, progressive=progressive, colour=colour,
                    factors=factors)
    assert native.jpeg_host_kind(twelve) is None
    assert not check_against_cv2(twelve, tmp_path, "twelve.jpg")
    with pytest.raises(native.ImageDecodeError, match="12-bit precision"):
        native.decode_image(twelve, "twelve.jpg")
    # the same encoder at 8 bits: a sound stream, decoded as cv2 decodes it
    eight = jpeg12(a, progressive=progressive, colour=colour,
                   factors=factors, precision=8, quant=2)
    assert native.jpeg_host_kind(eight) == (
        "progressive" if progressive else "sequential")
    assert check_against_cv2(eight, tmp_path, "eight.jpg")


def test_damaged_copies_raise_naming_the_file():
    data = read("jpeg_lossless_p8.jpg")
    check_damaged(data[:len(data) // 2], "lossless_truncated.jpg",
                  "Premature end")
    sos = data.index(b"\xff\xda")
    bad = bytearray(data)
    bad[sos + 11] = 0  # Ss, the predictor, after 3 components: 0
    check_damaged(bytes(bad), "lossless_bad_predictor.jpg", "predictor 0")
    rst = read("jpeg_lossless_cmyk_restart.jpg")
    marks = [i for i in range(len(rst) - 1)
             if rst[i] == 0xFF and 0xD0 <= rst[i + 1] <= 0xD7]
    dropped = rst[:marks[2]] + rst[marks[2] + 2:]
    check_damaged(dropped, "lossless_restart_dropped.jpg", "restart marker")
