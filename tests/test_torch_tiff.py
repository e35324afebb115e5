"""TIFF: the host library's decoder (`native/tiff_host.cpp`) against the
JAX package's loader, which hands TIFF files to `cv2.imread(path,
IMREAD_COLOR)` (libtiff's RGBA reader inside OpenCV).

The committed fixtures (`tiff_*`, with `formats.json`) decode to their
stored cv2 pixels and to the JAX loader's at max abs 0. Seeded files of
`format_writers.write_tiff` cover each compression (none, PackBits, LZW in
both code styles, Deflate, JPEG with and without JPEGTables), strips and
tiles, planar 1 and 2, both byte orders, predictor 2, 1-16 bits, every
photometric the library reads, alpha (unassociated alpha premultiplies),
16-bit colour maps, orientation 1-8 (5-8 on a square picture), and
libtiff's stride in clipped gray tiles; each is held to cv2.imread at max
abs 0. Orientation 5-8 on a picture that is not square and layouts cv2
refuses raise, as the JAX loader does; the variants once left out now
decode (CCITT, CMYK, CIELab) or raise saying cv2 refuses them too (LZMA,
ZSTD, WebP, old-style JPEG, float samples); damaged copies raise naming the
file. The rest of the variants are in test_torch_tiff_variants.py and
test_torch_tiff_tail.py.
"""
import cv2
import numpy as np
import pytest

from _format_checks import (check_against_cv2, check_against_loaders,
                            check_damaged, check_fixture, fixture_params,
                            read)
from format_writers import (_pil, picture, pil_tiff, set_tiff_tag,
                            write_tiff)
from semi_detr_tpu_torch import native

H, W = 37, 53


@pytest.mark.parametrize("name,entry", fixture_params(("tiff_",)))
def test_fixture(name, entry):
    check_fixture(name, entry)


LAYOUTS = [(c, o, pl, pr, tile, bits)
           for c in (1, 5, 8, 32773) for o in "<>" for pl in (1, 2)
           for pr in (1, 2) for tile in (None, (32, 32)) for bits in (8, 16)
           if not (c == 1 and tile and o == ">")]


@pytest.mark.parametrize("comp,order,planar,pred,tile,bits", LAYOUTS)
def test_rgb_layouts(comp, order, planar, pred, tile, bits, tmp_path):
    """RGB under every compression, byte order, planar configuration,
    predictor (ignored by libtiff under none and PackBits) and strips or
    tiles, at 8 and 16 bits (16 bits become (v + 128) / 257)."""
    rs = np.random.RandomState(bits + comp)
    img = rs.randint(0, 1 << bits, (H, W, 3))
    data = write_tiff(img, bits=bits, compression=comp, order=order,
                      planar=planar, predictor=pred, tile=tile,
                      rows_per_strip=7)
    assert check_against_cv2(data, tmp_path, "rgb.tif")


@pytest.mark.parametrize("bits", [1, 8, 16])
@pytest.mark.parametrize("photometric", [0, 1])
@pytest.mark.parametrize("tile", [None, (32, 32), (16, 48)])
def test_gray(bits, photometric, tile, tmp_path):
    """Min-is-white and min-is-black; in clipped tiles libtiff steps over
    the clipped part by its pixel count in bytes."""
    rs = np.random.RandomState(bits)
    a = rs.randint(0, 1 << bits, (H, W, 1))
    data = write_tiff(a, bits=bits, photometric=photometric, compression=5,
                      tile=tile)
    assert check_against_cv2(data, tmp_path, "gray.tif")


@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("wide", [False, True])
def test_palette(bits, wide, tmp_path):
    rs = np.random.RandomState(bits)
    a = rs.randint(0, 1 << bits, (H, W, 1))
    cmap = rs.randint(0, 65536 if wide else 256, (3, 1 << bits))
    data = write_tiff(a, bits=bits, colormap=cmap, compression=32773)
    assert check_against_cv2(data, tmp_path, "palette.tif")


@pytest.mark.parametrize("extra", [None, 0, 1, 2])
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("tile", [None, (16, 48)])
def test_extra_samples(extra, bits, tile, tmp_path):
    """A fourth RGB sample and a second gray one are dropped; an
    unassociated alpha premultiplies the colour first."""
    rs = np.random.RandomState(bits)
    rgba = rs.randint(0, 1 << bits, (H, W, 4))
    assert check_against_cv2(write_tiff(rgba, bits=bits, extra=extra,
                                        tile=tile, compression=8),
                             tmp_path, "rgba.tif")
    ga = rs.randint(0, 1 << bits, (H, W, 2))
    assert check_against_cv2(write_tiff(ga, bits=bits, extra=extra,
                                        photometric=1, tile=tile,
                                        compression=8),
                             tmp_path, "graya.tif")


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation(orientation, tmp_path):
    """1-4 as libtiff's RGBA reader turns strips and tiles (columns within
    each tile); 5-8 of a square picture as that reader flips it (as 1-4)
    and cv2 then turns it; cv2.imread fails to turn a picture of 5-8 that
    is not square."""
    img = picture(H, W, orientation)
    square = picture(40, 40, orientation)
    for tile in (None, (16, 16)):
        data = write_tiff(img, orientation=orientation, compression=5,
                          tile=tile, rows_per_strip=5)
        assert check_against_cv2(data, tmp_path, "o.tif") == (
            orientation <= 4)
        data = write_tiff(square, orientation=orientation, compression=5,
                          tile=tile, rows_per_strip=7)
        assert check_against_cv2(data, tmp_path, "square.tif")


def _jpeg(params):
    def encode(block):
        bgr = np.ascontiguousarray(block[..., ::-1] if block.shape[2] == 3
                                   else block[..., 0])
        return cv2.imencode(".jpg", bgr, params)[1].tobytes()
    return encode


Q = [cv2.IMWRITE_JPEG_QUALITY, 90]
S444 = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]
S422 = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]
JPEG_CASES = [(6, (2, 2), Q), (6, (1, 1), Q + S444), (6, (2, 1), Q + S422),
              (2, None, Q + S444)]


@pytest.mark.parametrize("photometric,subsampling,params", JPEG_CASES)
@pytest.mark.parametrize("tile", [None, (16, 32)])
@pytest.mark.parametrize("tables", [False, True])
def test_jpeg(photometric, subsampling, params, tile, tables, tmp_path):
    """JPEG strips and tiles by the host JPEG decoders: YCbCr to RGB by
    libjpeg's tables and fancy upsampling; photometric RGB unconverted."""
    img = picture(H, W, 4)
    data = write_tiff(img, compression=7, photometric=photometric,
                      subsampling=subsampling, jpeg=_jpeg(params),
                      rows_per_strip=8, tile=tile, jpeg_tables=tables)
    assert check_against_cv2(data, tmp_path, "jpeg.tif")
    gray = write_tiff(img[..., :1], compression=7, photometric=1,
                      jpeg=_jpeg(Q), rows_per_strip=16, tile=tile,
                      jpeg_tables=tables)
    assert check_against_cv2(gray, tmp_path, "jpeg_gray.tif")


def test_fill_order_and_lzw_styles(tmp_path):
    rs = np.random.RandomState(5)
    bits = rs.randint(0, 2, (H, W, 1))
    assert check_against_cv2(write_tiff(bits, bits=1, fill_order=2,
                                        photometric=1), tmp_path, "fo.tif")
    big = picture(120, 160, 5, noise=0)  # long enough to fill the table
    for old in (False, True):
        assert check_against_cv2(write_tiff(big, compression=5,
                                            old_lzw=old), tmp_path, "l.tif")


def _variant(tag, value):
    """A TIFF whose tag `tag` is `value`, with data of that kind."""
    img = picture(H, W, 6)
    bilevel = img[..., 0] > 120
    if tag == 259 and value in (3, 4):
        return pil_tiff(bilevel, "group3" if value == 3 else "group4")
    if tag == 266:  # Group 4 with FillOrder 2
        return pil_tiff(bilevel, "group4", {266: value})
    if tag == 259 and value == 50001:  # one strip holding a WebP stream
        webp = _pil(img, "WEBP", lossless=True)
        return set_tiff_tag(write_tiff(img, compression=7,
                                       jpeg=lambda block: webp), 259, 50001)
    if tag == 339:  # float32 samples
        f = (img.astype(np.float32) / 255).view(np.uint32)
        return write_tiff(f, bits=32, sample_format=value)
    if tag == 262 and value == 5:
        rs = np.random.RandomState(5)
        return write_tiff(rs.randint(0, 256, (H, W, 4)), photometric=5)
    if tag == 322:  # uncompressed tiles of 16 x 16 gray bytes: 256 each
        return write_tiff(img[..., :1], photometric=1, tile=(value, value))
    kw = {259: "compression", 262: "photometric"}
    return write_tiff(img, **{kw[tag]: value})


@pytest.mark.parametrize("tag,value,what,expect", [
    (259, 3, "CCITT Group 3", "pixels"), (259, 4, "CCITT Group 4", "pixels"),
    (259, 34925, "LZMA", "refused"), (259, 50000, "ZSTD", "refused"),
    (259, 50001, "WebP", "refused"), (259, 6, "old-style JPEG", "refused"),
    (339, 3, "float samples", "refused"), (262, 5, "CMYK", "pixels"),
    (262, 8, "CIELab", "pixels"),
    (266, 2, "CCITT Group 4 with FillOrder 2", "pixels"),
    (322, 16, "a tile under 1,024 bytes", "pixels")])
def test_not_ported_raise_naming_themselves(tag, value, what, expect,
                                            tmp_path):
    """The variants once left out: CCITT, CMYK and CIELab now decode to
    cv2's pixels; the compressions cv2's libtiff is built without (LZMA,
    ZSTD, WebP, old-style JPEG) and float samples raise saying cv2 refuses
    them too. An uncompressed tile under 1,024 bytes reads as cv2 reads
    it."""
    data = _variant(tag, value)
    read_it = check_against_loaders(data, tmp_path, "variant.tif")
    assert read_it == (expect == "pixels"), (what, read_it)
    if expect == "pixels":
        return
    with pytest.raises(native.ImageDecodeError) as err:
        native.decode_image(data, "variant.tif")
    msg = str(err.value)
    assert "variant.tif" in msg and what in msg, msg
    assert "cv2 refuses it too" in msg, msg


def test_damaged_copies_raise_naming_the_file():
    lzw = read("tiff_lzw_predictor.tif")
    check_damaged(lzw[:len(lzw) // 2], "tiff_truncated.tif", "TIFF")
    garbled = bytearray(lzw)
    garbled[8:40] = b"\xff" * 32  # codes past the table
    check_damaged(bytes(garbled), "tiff_bad_lzw.tif", "LZW")
    deflate = bytearray(read("tiff_deflate_tiles.tif"))
    deflate[10:20] = b"\0" * 10
    check_damaged(bytes(deflate), "tiff_bad_deflate.tif", "Deflate")
    jpeg = read("tiff_jpeg_ycbcr_tables.tif")
    check_damaged(jpeg[:200], "tiff_jpeg_cut.tif", "TIFF")
    check_damaged(b"II*\0\xff\xff\0\0", "tiff_bad_ifd.tif", "IFD")
