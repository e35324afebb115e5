"""The TIFF variants cv2 reads beside those of test_torch_tiff.py: the host
library's decoder (`native/tiff_host.cpp`, with `native/ccitt_host.cpp`)
against the JAX package's loader, which hands TIFF files to `cv2.imread(path,
IMREAD_COLOR)` (libtiff 4.7's RGBA reader inside OpenCV 5.0).

Seeded files cover CCITT modified Huffman, Group 3 (1-D, 2-D, fill bits)
and Group 4 (written by Pillow's libtiff, an encoder of its own, in strips
and with FillOrder 2, min-is-white and min-is-black, rows of 2,600 pixels
for the extended make-up codes), BigTIFF (both byte orders, strips and
tiles), signed 8- and 16-bit samples, CMYK (contiguous and in planes),
YCbCr outside JPEG at every subsampling libtiff's RGBA reader takes (odd
sizes, strips and tiles, ReferenceBlackWhite and YCbCrCoefficients of
their own), FillOrder 2 under every compression, and gray with extra
samples in separate planes. Each is held to cv2.imread and to the JAX
loader at max abs 0. What cv2 refuses (the compressions its libtiff is
built without: LZMA, ZSTD, WebP, old-style JPEG, PixarLog, LERC; float
samples; CMYK of five samples, 16 bits or InkSet 2; YCbCr subsampled in
planes) raises saying so, as the JAX loader raises. The committed fixtures
(`tiffv_*`) decode to their stored cv2 pixels; damaged copies raise naming
the file.
"""
import lzma

import numpy as np
import pytest

from _format_checks import (check_against_loaders, check_damaged,
                            check_fixture, fixture_params)
from format_writers import (picture, pil_tiff, set_tiff_tag, write_tiff,
                            _pil)
from semi_detr_tpu_torch import native

H, W = 29, 43


@pytest.mark.parametrize("name,entry", fixture_params(("tiffv_",)))
def test_fixture(name, entry):
    check_fixture(name, entry)


def _bilevel(h, w, seed):
    return picture(h, w, seed)[..., 0] > 120


CCITT = [(c, info) for c in ("tiff_ccitt", "group3", "group4")
         for info in ({}, {266: 2}, {278: 8})] + \
    [("group3", {292: 1}), ("group3", {292: 5}), ("group3", {292: 4}),
     ("group3", {292: 1, 278: 8, 266: 2})]


@pytest.mark.parametrize("compression,info", CCITT)
@pytest.mark.parametrize("photometric", [0, 1])
def test_ccitt(compression, info, photometric, tmp_path):
    data = pil_tiff(_bilevel(H, W, 1), compression, info)
    if photometric == 0:
        data = set_tiff_tag(data, 262, 0)
    assert check_against_loaders(data, tmp_path, "c.tif")


@pytest.mark.parametrize("compression", ["tiff_ccitt", "group4"])
def test_ccitt_long_runs(compression, tmp_path):
    """Rows of 2,600 pixels: runs of 1,792 and more take the extended
    make-up codes, and a run past 2,560 two make-up codes."""
    rs = np.random.RandomState(2)
    img = np.zeros((6, 2600), bool)
    img[1, 5:2595] = True
    img[2, :] = True
    img[3, 1800:1900] = True
    img[4] = rs.rand(2600) > 0.5
    data = pil_tiff(img, compression, {292: 1} if compression == "group3"
                    else None)
    assert check_against_loaders(data, tmp_path, "long.tif")


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("layout", ["strips", "tiles", "planar", "16bit"])
def test_bigtiff(order, layout, tmp_path):
    img = picture(H, W, 3)
    kw = {"strips": dict(compression=5, rows_per_strip=4),
          "tiles": dict(compression=8, tile=(16, 16)),
          "planar": dict(compression=32773, planar=2, rows_per_strip=7),
          "16bit": dict(compression=8, predictor=2)}[layout]
    a = img.astype(np.int64) * 257 if layout == "16bit" else img
    data = write_tiff(a, bits=16 if layout == "16bit" else 8, order=order,
                      bigtiff=True, **kw)
    assert data[2:4] in (b"+\0", b"\0+")
    assert check_against_loaders(data, tmp_path, "big.tif")


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("photometric", [1, 2])
def test_signed_samples(bits, photometric, tmp_path):
    """SampleFormat 2: libtiff's RGBA reader takes the bits as unsigned."""
    rs = np.random.RandomState(bits + photometric)
    a = rs.randint(0, 1 << bits, (H, W, 3 if photometric == 2 else 1))
    data = write_tiff(a, bits=bits, photometric=photometric,
                      sample_format=2, compression=5)
    assert check_against_loaders(data, tmp_path, "s.tif")


@pytest.mark.parametrize("planar", [1, 2])
@pytest.mark.parametrize("compression", [1, 5, 8])
@pytest.mark.parametrize("inkset", [None, 1])
def test_cmyk(planar, compression, inkset, tmp_path):
    rs = np.random.RandomState(planar * compression)
    cmyk = rs.randint(0, 256, (H, W, 4))
    data = write_tiff(cmyk, photometric=5, planar=planar, inkset=inkset,
                      compression=compression, rows_per_strip=10)
    assert check_against_loaders(data, tmp_path, "cmyk.tif")


def _ycbcr(h, w, seed):
    import cv2
    rgb = picture(h, w, seed)
    ycc = cv2.cvtColor(rgb, cv2.COLOR_RGB2YCrCb)[..., [0, 2, 1]]
    return ycc


SUBSAMPLING = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)]


@pytest.mark.parametrize("sub", SUBSAMPLING)
@pytest.mark.parametrize("tile", [None, (16, 32)])
@pytest.mark.parametrize("size", [(H, W), (32, 48)])
def test_ycbcr(sub, tile, size, tmp_path):
    ycc = _ycbcr(*size, sum(sub))
    data = write_tiff(ycc, photometric=6, subsampling=sub, tile=tile,
                      compression=5, rows_per_strip=8)
    assert check_against_loaders(data, tmp_path, "ycc.tif")


def test_ycbcr_tags_and_planes(tmp_path):
    ycc = _ycbcr(H, W, 9)
    for rbw in ((0, 255, 128, 255, 128, 255), (16, 235, 128, 240, 128, 240),
                (10, 250, 100, 220, 90, 230)):
        data = write_tiff(ycc, photometric=6, subsampling=(2, 2),
                          ref_black_white=rbw, compression=8)
        assert check_against_loaders(data, tmp_path, "rbw.tif")
    data = write_tiff(ycc, photometric=6, subsampling=(2, 1),
                      ycbcr_coefficients=(0.2126, 0.7152, 0.0722))
    assert check_against_loaders(data, tmp_path, "bt709.tif")
    data = write_tiff(ycc, photometric=6, subsampling=(1, 1), planar=2,
                      compression=32773)
    assert check_against_loaders(data, tmp_path, "planes.tif")


@pytest.mark.parametrize("compression", [1, 5, 8, 32773, 7])
def test_fill_order_2(compression, tmp_path):
    """FillOrder 2 reverses the bits of every coded byte; under JPEG cv2
    fails to read the strips (both raise)."""
    import cv2
    img = picture(H, W, 5)

    def jpeg(block):
        return cv2.imencode(".jpg", np.ascontiguousarray(block[..., ::-1]))[
            1].tobytes()
    data = write_tiff(img, compression=compression, fill_order=2,
                      jpeg=jpeg, photometric=2, rows_per_strip=16)
    assert check_against_loaders(data, tmp_path, "fo.tif") == (
        compression != 7)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("extra", [0, 1, 2])
@pytest.mark.parametrize("photometric", [0, 1])
def test_gray_extra_planes(bits, extra, photometric, tmp_path):
    """Gray with extra samples in separate planes: the first plane is the
    gray (not inverted for min-is-white, (v + 128) / 257 at 16 bits); an
    unassociated alpha as the first extra plane premultiplies it."""
    rs = np.random.RandomState(bits + extra)
    ga = rs.randint(0, 1 << bits, (H, W, 2))
    data = write_tiff(ga, bits=bits, photometric=photometric, planar=2,
                      extra=extra, compression=8)
    assert check_against_loaders(data, tmp_path, "ga.tif")
    three = rs.randint(0, 1 << bits, (H, W, 3))
    data = write_tiff(three, bits=bits, photometric=photometric, planar=2,
                      extra=extra, tile=(16, 16))
    assert check_against_loaders(data, tmp_path, "gaa.tif")


def _webp_in_tiff(img):
    """A TIFF of compression 50001 whose one strip is a lossless WebP."""
    webp = _pil(img, "WEBP", lossless=True)
    data = write_tiff(img, compression=7, jpeg=lambda block: webp)
    return set_tiff_tag(data, 259, 50001)


def _refused():
    img = picture(H, W, 6)
    rs = np.random.RandomState(7)
    return {
        "lzma": write_tiff(img, compression=34925),
        "lzma_delta": write_tiff(img, compression=34925, lzma_filters=[
            {"id": lzma.FILTER_DELTA, "dist": 3}, {"id": lzma.FILTER_LZMA2}]),
        "lzma_pillow": pil_tiff(img, "lzma"),
        "zstd": write_tiff(img, compression=50000),
        "webp": _webp_in_tiff(img),
        "old_jpeg": write_tiff(img, compression=6),
        "pixarlog": write_tiff(img, compression=32909),
        "lerc": write_tiff(img, compression=34887),
        "float32": write_tiff(rs.randint(0, 1 << 30, (H, W, 3)), bits=32,
                              sample_format=3),
        "float16": write_tiff(rs.randint(0, 1 << 14, (H, W, 1)), bits=16,
                              sample_format=3, photometric=1),
        "cmyk_extra": write_tiff(rs.randint(0, 256, (H, W, 5)),
                                 photometric=5, extra=0),
        "cmyk_16bit": write_tiff(rs.randint(0, 65536, (H, W, 4)), bits=16,
                                 photometric=5),
        "cmyk_inkset2": write_tiff(rs.randint(0, 256, (H, W, 4)),
                                   photometric=5, inkset=2),
        "ycbcr_planes_subsampled": write_tiff(
            _ycbcr(H, W, 1), photometric=6, subsampling=(2, 2), planar=2),
        "ccitt_8bit": write_tiff(img[..., :1], compression=4, photometric=0),
    }


@pytest.mark.parametrize("name", sorted(_refused()))
def test_what_cv2_refuses_raises(name, tmp_path):
    data = _refused()[name]
    assert not check_against_loaders(data, tmp_path, name + ".tif")
    with pytest.raises(native.ImageDecodeError, match="cv2 refuses it too"):
        native.decode_image(data, name)


def test_damaged_copies_raise_naming_the_file():
    import io
    from PIL import Image
    g4 = pil_tiff(_bilevel(64, 200, 3), "group4")
    strip = Image.open(io.BytesIO(g4)).tag_v2[273][0]
    bad = bytearray(g4)
    bad[strip:strip + 16] = b"\0\0\0\x01" * 4  # EOLs for 2-D codes
    check_damaged(bytes(bad), "g4_bad_codes.tif", "CCITT")
    g3 = pil_tiff(_bilevel(64, 200, 3), "group3")
    at = Image.open(io.BytesIO(g3)).tag_v2[273][0]
    zeroed = g3[:at] + bytes(200) + g3[at + 200:]
    check_damaged(zeroed, "g3_zeroed.tif", "CCITT")
    big = write_tiff(picture(H, W, 8), bigtiff=True, compression=5)
    check_damaged(big[:len(big) // 2], "big_truncated.tif", "TIFF")
    ycc = write_tiff(_ycbcr(H, W, 2), photometric=6, subsampling=(2, 2))
    check_damaged(ycc[:len(ycc) // 2], "ycc_truncated.tif", "TIFF")


def test_every_reading_path_takes_the_new_formats(tmp_path):
    """read_image, the port's CocoDataset.load_image and the C++ prefetch
    loader (eval's path) on one fixture of each format this slice reads."""
    import os
    import shutil
    from semi_detr_tpu_torch.data import image_io
    from semi_detr_tpu_torch.data.coco import CocoDataset
    names = ["gif_offset_local_transparent.gif", "ras_pal8.ras",
             "pam_rgb16.pam", "pfm_scale2_be.pfm", "hdr_rle.hdr",
             "tiffv_g3_2d.tif", "tiffv_bigtiff.tif", "tiffv_cmyk.tif",
             "tiffv_ycbcr22.tif"]
    refs = {}
    for n in names:
        shutil.copy(os.path.join(native.FIXTURES, n), tmp_path)
        refs[n] = image_io.read_image(os.path.join(
            native.FIXTURES, n.rsplit(".", 1)[0] + ".ref.png"))
        np.testing.assert_array_equal(
            image_io.read_image(str(tmp_path / n)), refs[n])
    ann = {"images": [{"id": i + 1, "file_name": n,
                       "width": int(refs[n].shape[1]),
                       "height": int(refs[n].shape[0])}
                      for i, n in enumerate(names)],
           "annotations": [], "categories": [{"id": 1, "name": "person"}]}
    ds = CocoDataset(ann, str(tmp_path), classes=("person",),
                     filter_empty_gt=False, test_mode=True)
    loader = native.PrefetchLoader(2)
    for i, n in enumerate(names):
        np.testing.assert_array_equal(ds.load_image(i), refs[n])
        loader.submit(i, str(tmp_path / n))
    got = {}
    while loader.outstanding:
        r = loader.next()
        got[names[r.index]] = r.image
    loader.close()
    for n in names:
        np.testing.assert_array_equal(got[n], refs[n])
