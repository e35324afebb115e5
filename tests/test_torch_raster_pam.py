"""Sun raster and PAM: the host library's decoders (`native/raster_host.cpp`
and the P7 reader of `native/bmp_pnm_host.cpp`) against the JAX package's
loader, which hands these files to `cv2.imread(path, IMREAD_COLOR)`
(OpenCV 5.0's SunRasterDecoder and PAMDecoder).

The committed fixtures (`ras_*`, `pam_*`, `other_ras.ras`,
`other_pam.pam`, with `formats.json`) decode to their stored cv2 pixels and
to the JAX loader's at max abs 0. Seeded files of `format_writers.write_ras`
and `write_pam` cover every depth, colour maps of any length, the old and
standard types, rows padded to 16 bits, every PAM depth and tuple type at
maxvals 1-65535; each is held to cv2.imread and to the JAX loader at max
abs 0, or raises where cv2 refuses (the byte-encoded and RGB-order raster
types, which cv2 5.0's header check refuses, and tuple types that do not fit
the depth). Where cv2 sets only part of its picture (a PAM of
GRAYSCALE_ALPHA or RGB_ALPHA: the first w / depth pixels of each row), the
port is held to that part and to the plain reading of the rest. Damaged
copies raise naming the file.
"""
import numpy as np
import pytest

from _format_checks import (check_against_loaders, check_damaged,
                            check_fixture, fixture_params)
from format_writers import cv2_rgb, picture, write_pam, write_ras
from semi_detr_tpu_torch import native

H, W = 19, 29


@pytest.mark.parametrize("name,entry", fixture_params(
    ("ras_", "pam_", "other_ras", "other_pam")))
def test_fixture(name, entry):
    check_fixture(name, entry)


def _ras_cases():
    rs = np.random.RandomState(21)
    pal = rs.randint(0, 256, (256, 3))
    idx = rs.randint(0, 256, (H, W))
    bits = rs.randint(0, 2, (H, W))
    img = picture(H, W, 2)
    cases = {}
    for rtype in (0, 1):
        for depth in (24, 32):
            cases[f"rgb{depth}_type{rtype}"] = write_ras(img, depth,
                                                         rtype=rtype)
        cases[f"pal8_type{rtype}"] = write_ras(idx, 8, pal, rtype=rtype)
        cases[f"gray8_type{rtype}"] = write_ras(idx, 8, rtype=rtype)
        cases[f"bits_type{rtype}"] = write_ras(bits, 1, rtype=rtype)
        cases[f"bits_map_type{rtype}"] = write_ras(bits, 1, pal[:2],
                                                   rtype=rtype)
    cases["short_map"] = write_ras(idx, 8, pal[:40])
    cases["bits_one_entry_map"] = write_ras(bits, 1, pal[:1])
    cases["even_width"] = write_ras(idx[:, :28], 8, pal)
    cases["wide_bits"] = write_ras(rs.randint(0, 2, (5, 37)), 1)
    return cases


RAS = _ras_cases()


@pytest.mark.parametrize("name", sorted(RAS))
def test_seeded_ras(name, tmp_path):
    assert check_against_loaders(RAS[name], tmp_path, name + ".ras")


def test_ras_map_lengths(tmp_path):
    """An equal-RGB map of any length up to 3 * 256 bytes: n = length / 3
    entries in three planes, the rest black."""
    import struct
    rs = np.random.RandomState(22)
    idx = rs.randint(0, 256, (H, W))
    for length in (3, 4, 5, 7, 30, 100, 768):
        cmap = bytes(rs.randint(0, 256, length).astype(np.uint8))
        data = struct.pack(">8I", 0x59A66A95, W, H, 8, H * (W + 1), 1, 1,
                           length) + cmap + write_ras(idx, 8)[32:]
        assert check_against_loaders(data, tmp_path, f"map{length}.ras")


def _ras_refused():
    import struct
    rs = np.random.RandomState(23)
    idx = rs.randint(0, 256, (H, W))
    img = picture(H, W, 3)
    raw = write_ras(idx, 8, rs.randint(0, 256, (256, 3)))
    map2 = bytearray(raw)
    map2[24:28] = struct.pack(">I", 2)
    depth4 = bytearray(raw)
    depth4[12:16] = struct.pack(">I", 4)
    return {"rle_type2": write_ras(idx, 8, rs.randint(0, 256, (256, 3)),
                                   rtype=2),
            "rle_type2_gray": write_ras(np.full((H, W), 9), 8, rtype=2),
            "rgb_type3": write_ras(img, 24, rtype=3),
            "rgb_type3_32": write_ras(img, 32, rtype=3),
            "map_type2": bytes(map2), "depth4": bytes(depth4),
            "map_at_24": write_ras(img, 24)[:28] + b"\0\0\0\x03" +
            b"\1\2\3" + write_ras(img, 24)[32:]}


@pytest.mark.parametrize("name,data", sorted(_ras_refused().items()))
def test_ras_what_cv2_refuses_raises(name, data, tmp_path):
    assert not check_against_loaders(data, tmp_path, name + ".ras")
    with pytest.raises(native.ImageDecodeError, match="cv2 refuses it too"):
        native.decode_image(data, name)


PAM_CASES = [(d, t, m) for d, t in ((1, None), (1, "GRAYSCALE"),
                                    (1, "BLACKANDWHITE"), (3, None),
                                    (3, "RGB"))
             for m in (1, 2, 100, 255, 256, 1000, 65535)
             if t is not None or m < 256]


@pytest.mark.parametrize("depth,tupltype,maxval", PAM_CASES)
def test_seeded_pam(depth, tupltype, maxval, tmp_path):
    rs = np.random.RandomState(maxval + depth)
    a = rs.randint(0, maxval + 1, (H, W, depth))
    data = write_pam(a, maxval, tupltype, comments=maxval == 100)
    assert check_against_loaders(data, tmp_path, "p.pam")


@pytest.mark.parametrize("depth,tupltype", [(2, "GRAYSCALE_ALPHA"),
                                            (4, "RGB_ALPHA")])
@pytest.mark.parametrize("maxval", [1, 255, 65535])
def test_pam_alpha_where_cv2_sets_pixels(depth, tupltype, maxval, tmp_path):
    """cv2 converts only the first ceil(w / depth) pixels of each row of
    these (a bound counted in samples, not pixels) and leaves the rest of
    its picture unset; the port equals it there, and gives the first
    sample (gray) or the first three (RGB) of every pixel elsewhere. A
    maxval of 1 is read as packed bits over the whole row, as cv2 does."""
    rs = np.random.RandomState(depth * maxval)
    a = rs.randint(0, maxval + 1, (H, W, depth))
    data = write_pam(a, maxval, tupltype)
    got = native.decode_image(data, "a.pam")
    ref = cv2_rgb(data, str(tmp_path), "a.pam")
    hi = a >> 8 if maxval > 255 else a
    plain = np.repeat(hi[..., :1], 3, 2) if depth == 2 else hi[..., :3]
    if maxval == 1:
        np.testing.assert_array_equal(got, ref)
        return
    n = -(-W // depth)
    np.testing.assert_array_equal(got[:, :n], ref[:, :n])
    np.testing.assert_array_equal(got, plain.astype(np.uint8))


@pytest.mark.parametrize("depth,tupltype,maxval", [
    (1, "RGB", 255), (3, "GRAYSCALE", 255), (2, None, 255), (4, None, 255),
    (1, None, 1000), (3, None, 65535), (2, "RGB_ALPHA", 255),
    (3, "FOO", 255)])
def test_pam_what_cv2_refuses_raises(depth, tupltype, maxval, tmp_path):
    a = np.zeros((H, W, depth), np.int64)
    data = write_pam(a, maxval, tupltype)
    assert not check_against_loaders(data, tmp_path, "r.pam")


def test_damaged_copies_raise_naming_the_file():
    rs = np.random.RandomState(24)
    ras = write_ras(picture(H, W, 4), 24)
    check_damaged(ras[:len(ras) - 5], "ras_truncated.ras", "Sun raster")
    check_damaged(ras[:20], "ras_header_only.ras", "Sun raster")
    pam = write_pam(rs.randint(0, 256, (H, W, 3)), 255, "RGB")
    check_damaged(pam[:len(pam) - 1], "pam_truncated.pam", "PAM")
    check_damaged(b"P7\nWIDTH 4\nHEIGHT 4\nDEPTH 3\nENDHDR\n" + bytes(48),
                  "pam_no_maxval.pam", "PAM")
    check_damaged(b"P7\nWIDTH 4\nHEIGHT 4\nBOGUSFIELD 3\n", "pam_bad.pam",
                  "PAM")


def test_raw_format_files_read_back(tmp_path):
    """`tools.raw_formats` (phase 7a's 480x640 Sun raster, PAM and PFM)
    writes files that cv2.imread, the JAX loader and the port read back to
    the picture they were written from."""
    from semi_detr_tpu_torch.tools.raw_formats import raw_format_files
    rgb = picture(H, W, 9)
    for name, (data, fmt, _) in raw_format_files(rgb).items():
        assert check_against_loaders(data, tmp_path, name)
        np.testing.assert_array_equal(native.decode_image(data, name), rgb)
