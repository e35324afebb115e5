"""Write `native/sgilog_tables.h`, the (u', v') grid of SGILog's 24-bit
LogLuv encoding, from a libtiff shared library.

A LogLuv 24 pixel carries 10 bits of log luminance and a 14-bit index
into a grid of squares over the CIE (u', v') diagram: 163 rows of
`UV_SQSIZ` squares from `UV_VSTART` up, row `vi` holding `nus` squares from
`ustart` on and its first index being `ncum`. libtiff keeps the grid as a
table (`uv_row` in `uvcode.h`) that no header it installs carries. This
tool writes a file of every index (`SGILOGDATAFMT_RAW`, one row of 16,384
pixels at a luminance near 1), reads it back through the library as float
XYZ, and recovers each index's (u', v') = (4X, 9Y) / (X + 15Y + 3Z):
`vi` from v', `ncum` and `nus` from where each row starts and ends, and
`ustart` (six decimals, as uvcode.h prints it) from the first square's
centre. It then decodes every index again from the recovered grid, in
libtiff's own double steps (`uv_decode`, `LogLuv24toXYZ`), and fails
unless each float X, Y and Z equals the library's bit for bit.

It runs only where a libtiff shared library is (`libtiff.so.6`, or
`--libtiff`); no module of the port imports it. Its writer is also the
SGILog fixture writer of the tests (`write_sgilog`):

    python -m semi_detr_tpu_torch.tools.sgilog_table [--out PATH]
"""
from __future__ import annotations

import argparse
import ctypes
import math
import os
import tempfile

import numpy as np

UV_SQSIZ = float(np.float32(0.0035))
UV_VSTART = float(np.float32(0.01694))
UV_NVS, UV_NDIVS = 163, 16289
U_NEU, V_NEU = 0.210526316, 0.473684211
# TIFF tags and values of tiff.h
SGILOGDATAFMT = 65560
FMT_FLOAT, FMT_16BIT, FMT_RAW = 0, 1, 2
LOGL, LOGLUV = 32844, 32845
SGILOG, SGILOG24 = 34676, 34677

_HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(os.path.dirname(_HERE), "native", "sgilog_tables.h")


def libtiff(path: str = "libtiff.so.6"):
    lib = ctypes.CDLL(path)
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFSetField.restype = ctypes.c_int
    for f in ("TIFFWriteEncodedStrip", "TIFFWriteEncodedTile",
              "TIFFReadEncodedStrip"):
        getattr(lib, f).argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                    ctypes.c_void_p, ctypes.c_ssize_t]
        getattr(lib, f).restype = ctypes.c_ssize_t
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    return lib


def _set(lib, tif, tag, value):
    if lib.TIFFSetField(ctypes.c_void_p(tif), ctypes.c_uint32(tag),
                        ctypes.c_int(value)) != 1:
        raise RuntimeError(f"TIFFSetField({tag}, {value}) failed")


def write_sgilog(path: str, words, compression: int, photometric: int,
                 rows_per_strip: int = None, tile=None, order: str = "<",
                 lib=None):
    """(h, w) raw SGILog words (uint32 LogLuv 32 or 24, or int16 LogL) into
    a TIFF written by libtiff's SGILog encoder (its run-length coding for
    34676, packed bytes for 34677), in strips of rows_per_strip rows or in
    tiles of (tile_h, tile_w), in either byte order (the words coded are
    the same). LogLuv is written as one raw sample and its
    SamplesPerPixel set to 3 afterwards, as a LogLuv file of float XYZ
    carries it (libtiff reads the raw words either way)."""
    lib = lib or libtiff()
    words = np.asarray(words)
    h, w = words.shape
    luv = photometric == LOGLUV
    tif = lib.TIFFOpen(path.encode(), b"w" + (b"b" if order == ">" else b"l"))
    if not tif:
        raise OSError(path)
    for tag, v in ((256, w), (257, h), (259, compression), (262, photometric),
                   (284, 1), (SGILOGDATAFMT, FMT_RAW if luv else FMT_16BIT),
                   (277, 1)):
        _set(lib, tif, tag, v)
    data = words.astype(np.uint32 if luv else np.int16)
    if order == ">":  # libtiff swaps the words to the file's order first
        data = data.byteswap()
    if tile:
        _set(lib, tif, 322, tile[1])
        _set(lib, tif, 323, tile[0])
        th, tw = tile
        padded = np.zeros((-(-h // th) * th, -(-w // tw) * tw), data.dtype)
        padded[:h, :w] = data
        blocks = [np.ascontiguousarray(padded[y:y + th, x:x + tw])
                  for y in range(0, h, th) for x in range(0, w, tw)]
        put = lib.TIFFWriteEncodedTile
    else:
        rps = rows_per_strip or h
        _set(lib, tif, 278, rps)
        blocks = [np.ascontiguousarray(data[y:y + rps])
                  for y in range(0, h, rps)]
        put = lib.TIFFWriteEncodedStrip
    for i, b in enumerate(blocks):
        if put(tif, i, b.ctypes.data, b.nbytes) < 0:
            lib.TIFFClose(tif)
            raise RuntimeError("libtiff's SGILog encoder failed")
    lib.TIFFClose(tif)
    if luv:
        _set_spp3(path)


def _set_spp3(path: str):
    """SamplesPerPixel (277) of the file's first IFD set to 3 in place."""
    with open(path, "r+b") as f:
        data = bytearray(f.read())
        order = "<" if data[:2] == b"II" else ">"
        ifd = int.from_bytes(data[4:8], "little" if order == "<" else "big")
        n = int.from_bytes(data[ifd:ifd + 2], "little" if order == "<"
                           else "big")
        for e in range(n):
            p = ifd + 2 + 12 * e
            if int.from_bytes(data[p:p + 2], "little" if order == "<"
                              else "big") == 277:
                data[p + 8:p + 10] = (3).to_bytes(
                    2, "little" if order == "<" else "big")
        f.seek(0)
        f.write(data)


def read_xyz(path: str, n: int, lib=None) -> np.ndarray:
    """The first strip of a LogLuv file of n pixels, read through libtiff
    as float XYZ: (n, 3) float32."""
    lib = lib or libtiff()
    tif = lib.TIFFOpen(path.encode(), b"r")
    _set(lib, tif, SGILOGDATAFMT, FMT_FLOAT)
    out = np.zeros((n, 3), np.float32)
    got = lib.TIFFReadEncodedStrip(tif, 0, out.ctypes.data, out.nbytes)
    lib.TIFFClose(tif)
    if got != out.nbytes:
        raise RuntimeError(f"read {got} of {out.nbytes} bytes")
    return out


def decode24(c: int, rows, le: int = 768):
    """libtiff's LogLuv24toXYZ of the word (le << 14) | c through the grid
    `rows` ((ustart, nus, ncum) per row), in its double steps."""
    L = math.exp(math.log(2) / 64.0 * (le + 0.5) - math.log(2) * 12.0)
    if 0 <= c < UV_NDIVS:
        lower, upper = 0, UV_NVS
        while upper - lower > 1:
            vi = (lower + upper) >> 1
            ui = c - rows[vi][2]
            if ui > 0:
                lower = vi
            elif ui < 0:
                upper = vi
            else:
                lower = vi
                break
        vi = lower
        ui = c - rows[vi][2]
        u = float(np.float32(rows[vi][0])) + (ui + 0.5) * UV_SQSIZ
        v = UV_VSTART + (vi + 0.5) * UV_SQSIZ
    else:
        u, v = U_NEU, V_NEU
    s = 1.0 / (6.0 * u - 16.0 * v + 12.0)
    x, y = 9.0 * u * s, 4.0 * v * s
    return (np.float32(x / y * L), np.float32(L),
            np.float32((1.0 - x - y) / y * L))


def tabulate(lib=None):
    """[(ustart, nus, ncum)] of the 163 rows, recovered and checked."""
    lib = lib or libtiff()
    codes = np.arange(16384, dtype=np.uint32)
    words = (np.uint32(768) << 14) | codes
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "uv.tif")
        write_sgilog(path, words[None], SGILOG24, LOGLUV, lib=lib)
        xyz = read_xyz(path, len(codes), lib).astype(np.float64)
    den = xyz[:, 0] + 15 * xyz[:, 1] + 3 * xyz[:, 2]
    u, v = 4 * xyz[:, 0] / den, 9 * xyz[:, 1] / den
    vi = np.rint((v[:UV_NDIVS] - UV_VSTART) / UV_SQSIZ - 0.5).astype(int)
    if vi.min() != 0 or vi.max() != UV_NVS - 1 or np.any(np.diff(vi) < 0):
        raise RuntimeError("the rows of the grid are not in order")
    rows = []
    for r in range(UV_NVS):
        at = np.flatnonzero(vi == r)
        ustart = round(u[at[0]] - 0.5 * UV_SQSIZ, 6)
        rows.append((ustart, len(at), int(at[0])))
    for c in range(16384):
        want = xyz[c].astype(np.float32)
        if np.float32(decode24(c, rows)).tobytes() != want.tobytes():
            raise RuntimeError(f"index {c}: {decode24(c, rows)} != "
                               f"libtiff's {want}")
    return rows


def header(rows) -> str:
    lines = [
        "// The (u', v') grid of SGILog's 24-bit LogLuv encoding (libtiff's",
        "// uv_row of uvcode.h): per row of UV_SQSIZ squares from UV_VSTART "
        "up,",
        "// its first u', its number of squares and the index of its first "
        "one.",
        "// Written by semi_detr_tpu_torch/tools/sgilog_table.py from a "
        "libtiff",
        "// library's decode of every index, and checked against it bit for "
        "bit.",
        "#pragma once",
        "",
        "namespace sdt {",
        "namespace sgilog {",
        "",
        "struct UvRow {",
        "  float ustart;",
        "  short nus, ncum;",
        "};",
        "",
        "inline constexpr float kUvSqsiz = 0.003500f;",
        "inline constexpr float kUvVstart = 0.016940f;",
        f"inline constexpr int kUvNvs = {UV_NVS};",
        f"inline constexpr int kUvNdivs = {UV_NDIVS};",
        "",
        "inline constexpr UvRow kUvRow[kUvNvs] = {"]
    for ustart, nus, ncum in rows:
        lines.append(f"    {{{ustart:.6f}f, {nus}, {ncum}}},")
    lines += ["};", "", "}  // namespace sgilog", "}  // namespace sdt", ""]
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--libtiff", default="libtiff.so.6")
    args = ap.parse_args(argv)
    text = header(tabulate(libtiff(args.libtiff)))
    with open(args.out, "w") as f:
        f.write(text)
    return args.out


if __name__ == "__main__":
    print(main())
