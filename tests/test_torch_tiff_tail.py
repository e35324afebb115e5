"""The TIFF variants cv2 reads that test_torch_tiff.py and
test_torch_tiff_variants.py leave out: the host library's decoder
(`native/tiff_host.cpp`, with `native/sgilog_host.cpp`) against the JAX
package's loader, which hands TIFF files to `cv2.imread(path,
IMREAD_COLOR)` (libtiff 4.7's RGBA reader inside OpenCV 5.0).

Seeded files cover orientation 5-8 on square pictures (strips, tiles that
do not divide the width, planar 2, 16-bit gray, palette), StripByteCounts
as libtiff estimates them anew (a missing tag, a single strip's count of 0,
short or past the file, uncompressed counts whose first two differ) and as
it leaves them (the port raises on the damage it then meets), CMYK inside
JPEG (Pillow's libtiff; Adobe-marked streams in strips, tiles and planes), a
predictor on subsampled YCbCr (2x2, 2x1, 4x2, 4x4; odd sizes, strips and
tiles, LZW and Deflate; libtiff leaves the rows it cannot divide
undifferenced), CIELab at 8 and 16 bits with and without a WhitePoint,
SGILog (LogL, LogLuv 32 and 24, written by libtiff's own encoder through
`tools.sgilog_table.write_sgilog`) and ThunderScan (the writers'
`thunderscan` encoder: runs, 2- and 3-bit deltas, raw pixels). Each is held
to cv2.imread and to the JAX loader at max abs 0. What cv2 refuses of them
(predictor 3 on integer samples, photometric 4, 9, 10, 32803 and 34892,
LogL or LogLuv without SGILog and SGILog under other photometrics, a
non-square orientation 5-8, ...) raises saying "cv2 refuses it too". The
committed fixtures (`tiffx_*`) decode to their stored cv2 pixels; damaged
copies raise naming the file.
"""
import io

import cv2
import numpy as np
import pytest

from _format_checks import (check_against_cv2, check_against_loaders,
                            check_damaged, check_fixture, fixture_params,
                            read)
from format_writers import (cielab, cv2_rgb, drop_tiff_tag, picture,
                            set_tiff_tag, set_tiff_values, sgilog_tiff,
                            sgilog_words, tiff_values,
                            write_tiff)
from semi_detr_tpu_torch import native

H, W = 29, 43


@pytest.mark.parametrize("name,entry", fixture_params(("tiffx_",)))
def test_fixture(name, entry):
    check_fixture(name, entry)


ORIENT_LAYOUTS = {
    "strips": dict(compression=5, rows_per_strip=7),
    "tiles": dict(compression=8, tile=(16, 16)),
    "planar2": dict(planar=2, tile=(16, 32)),
    "gray16": dict(bits=16, photometric=1, rows_per_strip=9),
    "palette": dict(bits=8, compression=32773),
}


@pytest.mark.parametrize("layout", sorted(ORIENT_LAYOUTS))
@pytest.mark.parametrize("orientation", [5, 6, 7, 8])
def test_orientation_square(orientation, layout, tmp_path):
    """A square picture of orientation 5-8: flipped as 1-4 by the RGBA
    reader (columns within each tile), then turned by cv2 (5 and 7
    transposed, 6 and 8 about the other diagonal)."""
    img = picture(40, 40, orientation).astype(np.int64)
    kw = dict(ORIENT_LAYOUTS[layout])
    if layout == "gray16":
        img = img[..., :1] * 257
    if layout == "palette":
        img = img[..., :1]
        kw["colormap"] = np.random.RandomState(1).randint(0, 256, (3, 256))
    data = write_tiff(img, orientation=orientation, **kw)
    assert check_against_loaders(data, tmp_path, "o.tif")


@pytest.mark.parametrize("orientation", [5, 6, 7, 8])
def test_orientation_not_square_refused(orientation, tmp_path):
    data = write_tiff(picture(40, 48, 1), orientation=orientation)
    assert not check_against_loaders(data, tmp_path, "oblong.tif")
    with pytest.raises(native.ImageDecodeError) as err:
        native.decode_image(data, "oblong.tif")
    msg = str(err.value)
    assert "oblong.tif" in msg and "not square" in msg, msg
    assert "cv2 refuses it too" in msg, msg


def _counts(comp, layout, fault):
    """A TIFF whose StripByteCounts (or TileByteCounts) are `fault`."""
    img = picture(H, W, 8)
    kw = {"one strip": {}, "strips": dict(rows_per_strip=8),
          "tiles": dict(tile=(16, 16)), "planes": dict(planar=2)}[layout]
    data = write_tiff(img, compression=comp, **kw)
    tag = 325 if layout == "tiles" else 279
    counts = tiff_values(data, tag)
    if fault == "missing":
        return drop_tiff_tag(data, tag)
    new = {"zero": [0] + counts[1:], "short": [100] + counts[1:],
           "long": [counts[0] + 10 ** 6] + counts[1:],
           "one byte short": [c - 1 for c in counts]}[fault]
    return set_tiff_values(data, tag, new)


# (compression, layout, fault): libtiff estimates the counts anew and reads
# the picture whole
COUNTS_REPAIRED = [
    (1, "one strip", "zero"), (1, "one strip", "short"),
    (1, "one strip", "long"), (1, "one strip", "one byte short"),
    (1, "one strip", "missing"), (1, "tiles", "short"),
    (1, "tiles", "long"), (1, "planes", "missing"), (5, "one strip", "zero"),
    (5, "one strip", "missing"), (8, "one strip", "zero"),
    (8, "one strip", "missing"), (32773, "one strip", "zero"),
    (32773, "one strip", "missing")]
# libtiff leaves them, and then fails on a strip: cv2 refuses the file
# (the port raises) or reads it with strips blank or cut short (the port
# reads the same picture)
COUNTS_LEFT = [
    (1, "strips", "zero"), (1, "strips", "short"), (1, "strips", "long"),
    (1, "strips", "one byte short"), (1, "strips", "missing"),
    (1, "tiles", "zero"), (5, "one strip", "short"),
    (5, "strips", "zero"), (5, "one strip", "long"), (8, "tiles", "short"),
    (8, "tiles", "missing"), (32773, "strips", "one byte short"),
    (5, "planes", "missing")]


@pytest.mark.parametrize("comp,layout,fault", COUNTS_REPAIRED)
def test_strip_byte_counts_estimated(comp, layout, fault, tmp_path):
    data = _counts(comp, layout, fault)
    assert check_against_loaders(data, tmp_path, "counts.tif")
    intact = cv2_rgb(write_tiff(picture(H, W, 8), compression=comp),
                     str(tmp_path), "intact.tif")
    assert np.array_equal(native.decode_image(data, "counts.tif"), intact)


@pytest.mark.parametrize("comp,layout,fault", COUNTS_LEFT)
def test_strip_byte_counts_left_raise(comp, layout, fault, tmp_path):
    data = _counts(comp, layout, fault)
    intact = cv2_rgb(write_tiff(picture(H, W, 8), compression=comp),
                     str(tmp_path), "intact.tif")
    got = cv2_rgb(data, str(tmp_path), "counts.tif")
    assert got is None or not np.array_equal(got, intact)
    if got is None:
        check_damaged(data, "counts.tif", "damaged data")
    else:
        assert check_against_cv2(data, tmp_path, "counts.tif")


def _pil_cmyk_tiff(cmyk):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(cmyk.astype(np.uint8), "CMYK").save(
        buf, "TIFF", compression="jpeg")
    return buf.getvalue()


def _adobe_cmyk(block):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(block.astype(np.uint8)),
                    "CMYK").save(buf, "JPEG", quality=85)
    return buf.getvalue()


def _gray_jpeg(block):
    return cv2.imencode(".jpg", np.ascontiguousarray(
        block[..., 0].astype(np.uint8)), [cv2.IMWRITE_JPEG_QUALITY, 85])[
            1].tobytes()


@pytest.mark.parametrize("layout", ["pillow", "strips", "tiles", "tables",
                                    "planar2"])
def test_cmyk_jpeg(layout, tmp_path):
    """CMYK inside JPEG: libjpeg gives the four components as they are
    (tif_jpeg.c asks for no colour conversion, whatever the Adobe marker
    says), then the RGBA reader's CMYK map."""
    rs = np.random.RandomState(4)
    cmyk = np.concatenate([picture(H, W, 4), rs.randint(0, 256, (H, W, 1))],
                          2)
    if layout == "pillow":
        data = _pil_cmyk_tiff(cmyk)
    else:
        kw = {"strips": dict(rows_per_strip=8), "tiles": dict(tile=(16, 32)),
              "tables": dict(rows_per_strip=16, jpeg_tables=True),
              "planar2": dict(planar=2, rows_per_strip=8)}[layout]
        data = write_tiff(cmyk, photometric=5, compression=7,
                          jpeg=_gray_jpeg if layout == "planar2"
                          else _adobe_cmyk, **kw)
    assert check_against_loaders(data, tmp_path, "cmyk.tif")


YCC_CASES = [(sub, hw, tile, comp)
             for sub in ((2, 2), (2, 1), (4, 2), (4, 4))
             for hw, tile in (((29, 43), None), ((32, 48), None),
                              ((31, 36), (16, 16)), ((29, 43), (16, 48)))
             for comp in (5, 8)]


@pytest.mark.parametrize("sub,hw,tile,comp", YCC_CASES)
def test_ycbcr_predictor(sub, hw, tile, comp, tmp_path):
    """Predictor 2 on YCbCr data units: libtiff sums the decoded bytes in
    rows of its scanline size (strips) or of 3 * tile width (tiles) with a
    stride of 3; where those rows do not divide the bytes, or a row is not
    whole pixels (4x2 and 2x1 tiles, odd widths), it sums nothing."""
    img = picture(*hw, sub[0] + 3 * sub[1])
    ycc = cv2.cvtColor(img, cv2.COLOR_RGB2YCrCb)[..., [0, 2, 1]]
    data = write_tiff(ycc, photometric=6, subsampling=sub, compression=comp,
                      predictor=2, tile=tile, rows_per_strip=8)
    assert check_against_loaders(data, tmp_path, "ycc.tif")


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("layout", ["strips", "tiles", "lzw", "whitepoint"])
def test_cielab(bits, layout, tmp_path):
    """CIELab as initCIELabConversion converts it: TIFFCIELab16ToXYZ and
    TIFFXYZToRGB on libtiff's sRGB display, the reference white from the
    WhitePoint (D50 where there is none)."""
    rs = np.random.RandomState(bits)
    lab = (rs.randint(0, 1 << bits, (H, W, 3)) if layout == "strips"
           else cielab(picture(H, W, bits), bits))
    kw = {"strips": dict(rows_per_strip=8), "tiles": dict(tile=(16, 32)),
          "lzw": dict(compression=5, predictor=2),
          "whitepoint": dict(white_point=((3457, 10000), (3585, 10000)),
                             compression=8)}[layout]
    data = write_tiff(lab, bits=bits, photometric=8, **kw)
    assert check_against_loaders(data, tmp_path, "lab.tif")


SGILOG = {"logl": (34676, 32844), "luv32": (34676, 32845),
          "luv24": (34677, 32845)}


@pytest.mark.parametrize("layout", ["strips", "tiles", "big-endian"])
@pytest.mark.parametrize("kind", sorted(SGILOG))
def test_sgilog(kind, layout, tmp_path):
    """SGILog as tif_luv.c decodes it to 8 bits for the RGBA reader, files
    of libtiff's own encoder."""
    comp, photometric = SGILOG[kind]
    kw = {"strips": dict(rows_per_strip=8), "tiles": dict(tile=(16, 32)),
          "big-endian": dict(order=">")}[layout]
    data = sgilog_tiff(sgilog_words(kind, H, W, len(layout)), comp,
                       photometric, **kw)
    assert check_against_loaders(data, tmp_path, "sgilog.tif")


@pytest.mark.parametrize("kind", sorted(SGILOG))
@pytest.mark.parametrize("bits,sample_format", [(8, 1), (16, 1), (4, 2),
                                                (32, 2), (16, 3), (16, 5)])
def test_sgilog_file_tags(kind, bits, sample_format, tmp_path):
    """The file's own BitsPerSample and SampleFormat of an SGILog file:
    the RGBA reader's checks (1-16 bits, no float samples), OpenCV's gray
    ones for LogL (1, 8 or 16 bits, unsigned or signed)."""
    comp, photometric = SGILOG[kind]
    data = sgilog_tiff(sgilog_words(kind, 9, 11, 3), comp, photometric)
    n = 1 if kind == "logl" else 3
    data = set_tiff_values(set_tiff_values(data, 258, [bits] * n), 339,
                           [sample_format] * n)
    if not check_against_loaders(data, tmp_path, "tags.tif"):
        with pytest.raises(native.ImageDecodeError,
                           match="cv2 refuses it too"):
            native.decode_image(data, "tags.tif")


@pytest.mark.slow
def test_sgilog_uv_table_regenerates(tmp_path):
    """tools.sgilog_table recovers every index of the uv grid from the
    libtiff library's decode, checks each against it bit for bit, and
    writes the committed header byte for byte."""
    from semi_detr_tpu_torch.tools import sgilog_table
    out = sgilog_table.main(["--out", str(tmp_path / "t.h")])
    with open(out, "rb") as f, open(sgilog_table.OUT, "rb") as g:
        assert f.read() == g.read()


def test_sgilog_uv_grid_every_row(tmp_path):
    """One LogLuv 24 pixel in each row of the uv grid (its first and last
    square), past the grid and at zero luminance, against cv2."""
    import os
    import re
    with open(os.path.join(os.path.dirname(native.__file__),
                           "sgilog_tables.h")) as f:
        rows = re.findall(r"\{([0-9.]+)f, (\d+), (\d+)\}", f.read())
    assert len(rows) == 163
    codes = [int(c) for _, n, c in rows] + \
        [int(c) + int(n) - 1 for _, n, c in rows] + [16289, 16383, 0]
    codes += [0] * (-len(codes) % 16)
    words = (np.uint32(780) << 14) | np.array(codes, np.uint32)
    words[-1] &= 0x3fff  # Le 0
    data = sgilog_tiff(words.reshape(-1, 16), 34677, 32845)
    assert check_against_loaders(data, tmp_path, "uv.tif")


@pytest.mark.parametrize("shape", [(29, 43), (7, 64), (5, 1), (9, 130)])
@pytest.mark.parametrize("run_to_end", [False, True])
def test_thunderscan(shape, run_to_end, tmp_path, monkeypatch):
    """ThunderScan 4-bit palette strips: runs (one reaching a row's end
    where run_to_end), 2- and 3-bit deltas with skip codes, raw pixels."""
    import functools
    import format_writers
    monkeypatch.setattr(format_writers, "thunderscan", functools.partial(
        format_writers.thunderscan, run_to_end=run_to_end))
    rs = np.random.RandomState(shape[1])
    idx = rs.randint(0, 16, shape)
    half = shape[1] // 2
    idx[:, :half] = np.clip(np.cumsum(rs.randint(-1, 2, (shape[0], half)),
                                      1) + 7, 0, 15)
    if shape[1] > 6:
        idx[::2, 3:] = idx[::2, 3:4]
    data = write_tiff(idx, bits=4, colormap=rs.randint(0, 65536, (3, 16)),
                      compression=32809, rows_per_strip=3)
    assert check_against_loaders(data, tmp_path, "thunder.tif")


@pytest.mark.parametrize("what", ["tiles", "gray", "8-bit"])
def test_thunderscan_other_layouts(what, tmp_path):
    """ThunderScan tiles read as the picture of zero samples (tif_thunder.c
    decodes strips only); 4-bit gray and 8-bit samples raise saying cv2
    refuses them too."""
    idx = picture(H, W, 3)[..., :1] // 16
    kw = {"tiles": dict(colormap=np.tile(np.arange(16) * 4000 + 9, (3, 1)),
                        tile=(16, 16)),
          "gray": dict(photometric=1), "8-bit": dict(photometric=1)}[what]
    data = write_tiff(idx, bits=4, compression=32809, **kw)
    if what == "8-bit":
        data = set_tiff_tag(data, 258, 8)
    read_it = check_against_loaders(data, tmp_path, "thunder.tif")
    assert read_it == (what == "tiles")
    if what == "tiles":
        got = native.decode_image(data, "thunder.tif")
        assert len(np.unique(got.reshape(-1, 3), axis=0)) == 1
    else:
        with pytest.raises(native.ImageDecodeError,
                           match="cv2 refuses it too"):
            native.decode_image(data, "thunder.tif")


def _refused(what):
    img = picture(H, W, 5)
    if what.startswith("photometric "):
        return write_tiff(img, photometric=int(what.split()[1]))
    return {
        "Predictor 3": lambda: write_tiff(img, compression=5, predictor=3),
        "Predictor 4": lambda: set_tiff_tag(
            write_tiff(img, compression=8, predictor=2), 317, 4),
        "predictor 2 on 4-bit": lambda: write_tiff(
            img[..., :1] // 16, bits=4, compression=5, predictor=2,
            colormap=np.tile(np.arange(16) * 4000, (3, 1))),
        "SGILog under photometric 2": lambda: set_tiff_tag(
            write_tiff(img), 259, 34676),
        "LogLuv 24 under LogL": lambda: set_tiff_tag(sgilog_tiff(
            sgilog_words("logl", 9, 11, 1), 34676, 32844), 259, 34677),
        "LogLuv in planes": lambda: set_tiff_tag(sgilog_tiff(
            sgilog_words("luv24", 9, 11, 1), 34677, 32845), 284, 2),
        "no PhotometricInterpretation": lambda: drop_tiff_tag(
            write_tiff(img), 262),
        "bit depths": lambda: set_tiff_values(write_tiff(img), 258,
                                              [8, 8, 16]),
        "CIELab in separate planes": lambda: write_tiff(
            cielab(img), photometric=8, planar=2),
        "CIELab of 4 samples": lambda: write_tiff(
            np.concatenate([cielab(img), img[..., :1]], 2), photometric=8),
        "WhitePoint y of 0": lambda: write_tiff(
            cielab(img), photometric=8,
            white_point=((1, 3), (0, 5))),
    }[what]()


REFUSED = {
    "Predictor 3": "floating-point predictor (Predictor 3)",
    "Predictor 4": "Predictor 4",
    "predictor 2 on 4-bit": "predictor 2 on 4-bit samples",
    "photometric 4": "transparency mask (photometric 4)",
    "photometric 9": "ICC CIELab (photometric 9)",
    "photometric 10": "ITU CIELab (photometric 10)",
    "photometric 32803": "colour filter array (photometric 32803)",
    "photometric 34892": "linear raw (photometric 34892)",
    "photometric 32844": "LogL (photometric 32844) of other than SGILog",
    "photometric 32845": "LogLuv (photometric 32845) of other than SGILog",
    "photometric 11": "photometric 11",
    "SGILog under photometric 2": "SGILog compression under photometric 2",
    "LogLuv 24 under LogL": "LogL (photometric 32844) of other than SGILog",
    "LogLuv in planes": "LogLuv in separate planes",
    "no PhotometricInterpretation": "no PhotometricInterpretation",
    "bit depths": "samples of different bit depths",
    "CIELab in separate planes": "CIELab in separate planes",
    "CIELab of 4 samples": "CIELab of 4 samples per pixel",
    "WhitePoint y of 0": "WhitePoint y of 0",
}


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_refused_say_so(what, tmp_path):
    """What cv2 refuses (and so the JAX loader) raises naming itself and
    "cv2 refuses it too"; no TIFF says "not ported"."""
    data = _refused(what)
    assert not check_against_loaders(data, tmp_path, "refused.tif")
    with pytest.raises(native.ImageDecodeError) as err:
        native.decode_image(data, "refused.tif")
    msg = str(err.value)
    assert "refused.tif" in msg and REFUSED[what] in msg, msg
    assert "cv2 refuses it too" in msg and "not ported" not in msg, msg


def test_damaged_copies_raise_naming_the_file(tmp_path):
    """Copies cv2 refuses raise naming the file; SGILog strips whose data
    runs dry and ThunderScan runs past the row, which cv2 reads to a
    picture (libtiff's RGBA reader goes on with what the codec wrote),
    read to cv2's picture."""
    for name in ("tiffx_sgilog_luv32.tif", "tiffx_sgilog_logl.tif",
                 "tiffx_sgilog_luv24_tiles.tif"):
        data = read(name)
        tag = 325 if "tiles" in name else 279
        n = len(tiff_values(data, tag))
        assert check_against_cv2(set_tiff_values(data, tag, [40] * n),
                                 tmp_path, name.replace(".tif", "_cut.tif"))
    thunder = bytearray(read("tiffx_thunderscan.tif"))
    at = tiff_values(bytes(thunder), 273)[0]
    thunder[at:at + 4] = b"\x3f\x3f\x3f\x3f"  # runs past the row
    assert check_against_cv2(bytes(thunder), tmp_path,
                             "tiffx_thunder_runs.tif")
    cmyk = read("tiffx_cmyk_jpeg.tif")
    check_damaged(cmyk[:len(cmyk) // 2], "tiffx_cmyk_cut.tif", "TIFF")
    lab = read("tiffx_cielab16_tiles.tif")
    check_damaged(lab[:len(lab) // 2], "tiffx_cielab_cut.tif", "TIFF")
    ycc = read("tiffx_ycbcr44_predictor.tif")
    check_damaged(set_tiff_values(ycc, 325, [0] * len(tiff_values(ycc, 325))),
                  "tiffx_ycc_no_bytes.tif", "no bytes")
