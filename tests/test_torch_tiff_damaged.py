"""Damaged TIFF strips and tiles: the host library's decoder
(`native/tiff_host.cpp`) against cv2.imread, which the JAX package's loader
hands TIFF files to.

cv2 reads a TIFF through libtiff's RGBA interface, one TIFFReadRGBAStrip or
TIFFReadRGBATile call per strip or tile, each with a fresh buffer of zeros.
Where a codec fails after that buffer is allocated (LZW with a code not yet
in the table or data that ends early, Deflate data that fails, PackBits
data cut short, an uncompressed strip short of its rows, ThunderScan rows
of the wrong length, SGILog data that runs short), the reader goes on with
what the codec wrote and cv2 returns a picture; the library gives the same
picture. Seeded damaged copies of every such compression, in strips and
tiles, planar 1 and 2, with and without predictor 2, are held to cv2's
pixels at max abs 0. Where cv2 returns None (the IFD past the end of
a copy cut short, a bad IFD, a strip outside the file), the library raises
naming the file.
"""
import struct

import numpy as np
import pytest

from _format_checks import check_against_cv2, check_damaged, read
from format_writers import _tiff_entry, cv2_rgb, picture, write_tiff

H, W = 64, 48


def _values(data: bytes, tag: int):
    """The values of a SHORT or LONG tag of a classic TIFF's first IFD,
    with the position of the first."""
    order, p, typ, count = _tiff_entry(data, tag)
    size = 2 if typ == 3 else 4
    at = p + 8 if count * size <= 4 else struct.unpack(
        order + "I", data[p + 8:p + 12])[0]
    fmt = order + ("H" if typ == 3 else "I") * count
    return list(struct.unpack(fmt, data[at:at + count * size])), at, order, typ


def segments(data: bytes):
    """(offset, byte count) of every strip or tile."""
    try:
        offs = _values(data, 273)[0]
        counts = _values(data, 279)[0]
    except KeyError:
        offs = _values(data, 324)[0]
        counts = _values(data, 325)[0]
    return list(zip(offs, counts))


def garble(data: bytes, seg: int, frac: float, n: int, seed: int) -> bytes:
    """`n` seeded bytes XOR-ed into segment `seg`, from `frac` of its
    length."""
    off, cnt = segments(data)[seg]
    rs = np.random.RandomState(seed)
    out = bytearray(data)
    start = off + int(cnt * frac)
    for i in range(start, min(start + n, off + cnt)):
        out[i] ^= int(rs.randint(1, 256))
    return bytes(out)


def cut_count(data: bytes, seg: int, keep: float) -> bytes:
    """Segment `seg`'s StripByteCounts (TileByteCounts) cut to `keep` of
    its bytes."""
    tag = 279
    try:
        _tiff_entry(data, tag)
    except KeyError:
        tag = 325
    vals, at, order, typ = _values(data, tag)
    size = 2 if typ == 3 else 4
    out = bytearray(data)
    out[at + seg * size:at + (seg + 1) * size] = struct.pack(
        order + ("H" if typ == 3 else "I"), max(1, int(vals[seg] * keep)))
    return bytes(out)


COMPRESSIONS = {"lzw": 5, "deflate": 8, "packbits": 32773}
# (compression, predictor, planar, tile, bits)
LAYOUTS = [(c, pr, pl, tile, 8)
           for c in ("lzw", "deflate", "packbits")
           for pr in ((1, 2) if c != "packbits" else (1,))
           for pl in (1, 2) for tile in (None, (32, 32))]


def _file(comp, pred, planar, tile, bits, seed=0):
    img = picture(H, W, seed)
    return write_tiff(img, bits=bits, compression=COMPRESSIONS[comp],
                      predictor=pred, planar=planar, tile=tile,
                      rows_per_strip=16)


@pytest.mark.parametrize("comp,pred,planar,tile,bits", LAYOUTS)
@pytest.mark.parametrize("where", [0.0, 0.3, 0.7])
def test_garbled_segment_reads_as_cv2(comp, pred, planar, tile, bits, where,
                                      tmp_path):
    """Bytes XOR-ed into the second segment, from its start, a third in or
    two thirds in: the codec fails part way (or decodes garbage whole) and
    the picture is cv2's."""
    data = _file(comp, pred, planar, tile, bits)
    bad = garble(data, 1, where, 40, seed=int(where * 10))
    assert check_against_cv2(bad, tmp_path, "garbled.tif")


@pytest.mark.parametrize("comp,pred,planar,tile,bits", LAYOUTS)
@pytest.mark.parametrize("keep", [0.2, 0.6])
def test_segment_cut_short_reads_as_cv2(comp, pred, planar, tile, bits, keep,
                                        tmp_path):
    """The third segment's byte count cut to a fifth or three fifths: the
    codec runs out of data and the rest of the segment is 0."""
    data = _file(comp, pred, planar, tile, bits)
    assert check_against_cv2(cut_count(data, 2, keep), tmp_path, "cut.tif")


@pytest.mark.parametrize("tile", [None, (32, 32)])
@pytest.mark.parametrize("seg,keep", [(1, 0.5), (3, 0.1), (2, 0.99)])
def test_uncompressed_segment_short_of_its_rows(tile, seg, keep, tmp_path):
    """An uncompressed strip whose count is short of its rows: libtiff
    copies none of it, and the strip reads as 0. A short tile past the
    first two (whose counts libtiff would estimate anew) fails before its
    buffer is allocated: cv2 reads no picture, and the library raises."""
    data = write_tiff(picture(H, W, 3), compression=1, tile=tile,
                      rows_per_strip=16)
    bad = cut_count(data, seg, keep)
    read_it = check_against_cv2(bad, tmp_path, "short.tif")
    assert read_it == (tile is None or seg < 2), (tile, seg)


@pytest.mark.parametrize("comp", [5, 8, 32773])
@pytest.mark.parametrize("pred", [1, 2])
def test_sixteen_bit_strips_damaged(comp, pred, tmp_path):
    """16-bit strips garbled and cut short: the failed strip keeps its
    bytes in file order, neither swapped nor summed."""
    rs = np.random.RandomState(comp + pred)
    img = rs.randint(0, 65536, (H, W, 3))
    data = write_tiff(img, bits=16, compression=comp, predictor=pred,
                      rows_per_strip=16, order=">")
    assert check_against_cv2(garble(data, 1, 0.3, 40, 1), tmp_path, "g.tif")
    assert check_against_cv2(cut_count(data, 2, 0.3), tmp_path, "c.tif")


@pytest.mark.parametrize("old", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_lzw_code_styles_garbled(old, seed, tmp_path):
    """Both LZW code styles, seeded damage anywhere in a strip of the
    whole picture."""
    img = picture(H, W, seed)
    data = write_tiff(img, compression=5, old_lzw=old)
    rs = np.random.RandomState(seed)
    bad = garble(data, 0, float(rs.uniform(0.05, 0.9)), 8, seed)
    assert check_against_cv2(bad, tmp_path, "lzw.tif")


@pytest.mark.parametrize("name", ["tiffx_thunderscan.tif",
                                  "tiffx_sgilog_logl.tif",
                                  "tiffx_sgilog_luv24_tiles.tif"])
@pytest.mark.parametrize("damage", ["garble", "cut"])
def test_thunderscan_and_sgilog_damaged(name, damage, tmp_path):
    """ThunderScan rows of too few or too many pixels (the rest of the row
    cleared) and SGILog data that runs short (the rows before it kept),
    as cv2 reads them."""
    data = read(name)
    bad = (garble(data, 1, 0.3, 20, 1) if damage == "garble"
           else cut_count(data, 1, 0.4))
    assert check_against_cv2(bad, tmp_path, "d.tif")


def test_damaged_copies_cv2_refuses_still_raise(tmp_path):
    """Copies cv2 refuses (None) raise naming the file: the IFD past the
    end of a copy cut in half, a bad IFD, a JPEG-in-TIFF cut at 200 bytes,
    a strip outside the file."""
    lzw = read("tiff_lzw_predictor.tif")
    jpeg = read("tiff_jpeg_ycbcr_tables.tif")
    for data, name in ((lzw[:len(lzw) // 2], "tiff_truncated.tif"),
                       (jpeg[:200], "tiff_jpeg_cut.tif"),
                       (b"II*\0\xff\xff\0\0", "tiff_bad_ifd.tif")):
        assert cv2_rgb(data, str(tmp_path), name) is None, name
        check_damaged(data, name, "TIFF")
    data = _file("lzw", 1, 1, None, 8)
    vals, at, order, typ = _values(data, 273)
    out = bytearray(data)
    out[at + 4:at + 8] = struct.pack(order + "I", len(data) + 100)
    assert cv2_rgb(bytes(out), str(tmp_path), "outside.tif") is None
    check_damaged(bytes(out), "outside.tif", "outside the file")
