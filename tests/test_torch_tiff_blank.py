"""TIFF compressions cv2 5.0's libtiff knows but cannot decode: Pixar
(32908), NeXT (32947) and JPEG 2000 inside TIFF (34712). libtiff says
"Compression scheme N strip decoding is not implemented" and its RGBA
reader goes on with the strip's buffer all zeros, so `cv2.imread` gives
the picture of zero samples at the file's size: black for RGB and
min-is-black, white for min-is-white and CMYK, the colour map's first
entry for a palette, YCbCr (0, 0, 0) turned to RGB. The port's decoder
(`native/tiff_host.cpp`) reads each layout to cv2's picture, whatever the
strips hold, and refuses what cv2 refuses (4-bit gray, float samples,
orientation 5-8 on a picture that is not square, a strip outside the
file). The committed fixtures (`tiffb_*`): test_torch_tiff.py and phase
7a of `chip_smoke.py`.
"""
import numpy as np
import pytest

from semi_detr_tpu_torch import native
from format_writers import cv2_rgb, set_tiff_tag, write_tiff

BLANK = (32908, 32947, 34712)
H, W = 12, 20


def layouts():
    rs = np.random.RandomState(4)
    rgb = rs.randint(0, 256, (H, W, 3)).astype(np.uint8)
    gray = rgb[..., 0]
    cmap = np.tile(np.arange(256, dtype=np.uint16) * 200 + 9000, (3, 1))
    cmap[1] += 77
    return {
        "rgb": (rgb, {}),
        "rgb_strips": (rgb, dict(rows_per_strip=5)),
        "rgb_tiles": (rgb, dict(tile=(16, 16))),
        "rgb_planes": (rgb, dict(planar=2, rows_per_strip=4)),
        "rgba": (np.dstack([rgb, gray]), dict(extra=2)),
        "rgb16": (rgb.astype(np.uint16) * 257, dict(bits=16)),
        "gray": (gray, {}),
        "gray_min_is_white": (gray, dict(photometric=0)),
        "gray16": (gray.astype(np.uint16) * 257, dict(bits=16)),
        "bilevel_min_is_white": ((gray > 127).astype(np.uint8),
                                 dict(bits=1, photometric=0)),
        "palette": (gray, dict(colormap=cmap)),
        "cmyk": (np.dstack([rgb, gray]), dict(photometric=5)),
        "ycbcr_22": (rgb, dict(photometric=6, subsampling=(2, 2))),
        "big_endian_tiles": (rgb, dict(order=">", tile=(16, 32))),
        "bigtiff": (rgb, dict(bigtiff=True)),
    }


@pytest.mark.parametrize("layout", sorted(layouts()))
@pytest.mark.parametrize("compression", BLANK)
def test_zero_samples_as_cv2_reads_them(tmp_path, compression, layout):
    img, kw = layouts()[layout]
    data = write_tiff(img, compression=compression, **kw)
    want = cv2_rgb(data, str(tmp_path), "a.tif")
    assert want is not None and want.shape == (H, W, 3)
    # one colour: the picture of zero samples
    assert len(np.unique(want.reshape(-1, 3), axis=0)) == 1
    got = native.decode_image(data, "a.tif")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("compression", BLANK)
def test_strip_contents_do_not_matter(tmp_path, compression):
    """Zero byte counts and short strips read as cv2 reads them: zeros."""
    rs = np.random.RandomState(5)
    data = write_tiff(rs.randint(0, 256, (H, W, 3)).astype(np.uint8),
                      compression=compression)
    for cut in (set_tiff_tag(data, 279, 0), set_tiff_tag(data, 279, 10)):
        want = cv2_rgb(cut, str(tmp_path), "a.tif")
        np.testing.assert_array_equal(native.decode_image(cut, "a.tif"),
                                      want)
        assert not want.any()


@pytest.mark.parametrize("case", ["gray4", "float", "orientation6",
                                  "strip_outside"])
@pytest.mark.parametrize("compression", BLANK)
def test_what_cv2_refuses_stays_refused(tmp_path, compression, case):
    rs = np.random.RandomState(6)
    rgb = rs.randint(0, 256, (H, W, 3)).astype(np.uint8)
    data = {
        "gray4": lambda: write_tiff(rgb[..., 0] >> 4, bits=4,
                                    compression=compression),
        "float": lambda: write_tiff(rgb.astype(np.float32).view(np.uint32),
                                    bits=32, sample_format=3,
                                    compression=compression),
        "orientation6": lambda: write_tiff(rgb, orientation=6,
                                           compression=compression),
        "strip_outside": lambda: set_tiff_tag(
            write_tiff(rgb, compression=compression), 273, 10 ** 6),
    }[case]()
    assert cv2_rgb(data, str(tmp_path), "a.tif") is None
    with pytest.raises(native.ImageDecodeError, match="a.tif"):
        native.decode_image(data, "a.tif")
