"""Write `native/av1_tables.h`, the constant tables of the port's AV1
decoder (`native/av1_*.cpp`), from the libaom 3.14.1 that cv2 carries
(`opencv_python.libs/libaom-*.so.3.14.1`, the decoder behind cv2's AVIF
reader).

AV1's default CDFs are part of the standard, and libaom keeps them as
inverted 15-bit CDFs: a CDF of n symbols is n - 1 strictly decreasing
values in (0, 32768), a 0 (32768 inverted) and a counter slot (0), padded
with zeros to its array's row. No installed header carries them, so the
tool finds them by that structure, in two places:

* The coefficient CDFs of all four quantizer contexts are whole objects in
  the library's .rodata: the maximal aligned runs of records of each shape
  (txb skip, EOB extra, DC sign, EOB of 16, base of the EOB, and one run
  of base and base range back to back, split where the base table's
  period of 42 contexts ends). Each must be found exactly once.
* The mode CDFs are not whole there: the compiler copies them into the
  frame context with constant loads, in chunks it merges and reorders.
  So the tool runs the library's decoder (through ctypes) on a one-frame
  AV1 stream that cv2 writes, and reads the frame context the decoder
  built in the process's memory: the copies that begin with the txb skip
  table of quantizer context 0 and hold the key frame y mode table found
  in .rodata. There the CDFs lie in the order of libaom's FRAME_CONTEXT
  (`LAYOUT`); every record must parse, every copy must be the same.

The other tables come from .rodata by their structure: the 4x4 zig-zag
scan (libaom keeps coefficients transposed; the tool writes the
specification's order), the smooth-prediction weights (runs of 4, 8, 16,
32 and 64 from 255 down), the directional derivatives (90 entries, the
non-zero ones falling from 1023 to 3), the filter-intra taps (5 x 8 rows of
seven taps summing to 16) and the palette colour context (-1 at the hashes
that cannot occur). Each must be found once, or in copies that agree.

A lossy frame's tables too: the DC and AC quantizer lookups at 8, 10 and
12 bits (256 non-decreasing int16 from 4, told apart by their first
steps), the inverse quantizer matrices (15 levels x 2 planes x 3344
bytes, the square ones symmetric; written by row), the default scans of
every size below 64 (generated by the specification's rule and each found
in libaom by column) with the row and column scans, the cosine and ADST4
sine tables of a cos_bit of 12, and Sgr_Params (16 records of radii and
scales). The EOB CDFs of 32-1024 come from .rodata like the other
coefficient CDFs; the transform size, delta q, transform type (intra and
inter), transform split and restoration CDFs from the frame context. The
specification's fixed tables (context offsets, CDEF's, the restoration
ranges) are written as the specification gives them.

It runs only where cv2 is; no module of the port imports it (the port's
import guard names it):

    python -m semi_detr_tpu_torch.tools.av1_table [--so PATH] [--out PATH]
"""
from __future__ import annotations

import argparse
import ctypes
import glob
import os
import re
import struct

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(os.path.dirname(_HERE), "native", "av1_tables.h")

# libaom's FRAME_CONTEXT up to cfl_alpha_cdf: (name written or None,
# records, symbols per record (an int, or a list), row length). A record
# of 0 symbols is an unused row of zeros.
_MV = [4] + 2 * ([11, 4, 4, 4] + [2] * 14)
LAYOUT = [
    ("kDefaultTxbSkipCdf0", 65, 2, 3), ("kDefaultEobExtraCdf0", 90, 2, 3),
    ("kDefaultDcSignCdf0", 6, 2, 3), ("kDefaultEobPt16Cdf0", 4, 5, 6),
    ("kDefaultEobPt32Cdf0", 4, 6, 7), ("kDefaultEobPt64Cdf0", 4, 7, 8),
    ("kDefaultEobPt128Cdf0", 4, 8, 9), ("kDefaultEobPt256Cdf0", 4, 9, 10),
    ("kDefaultEobPt512Cdf0", 4, 10, 11), ("kDefaultEobPt1024Cdf0", 4, 11, 12),
    ("kDefaultCoeffBaseEobCdf0", 40, 3, 4), ("kDefaultCoeffBaseCdf0", 420, 4, 5),
    ("kDefaultCoeffBrCdf0", 210, 4, 5),
    (None, 17, 2, 3),     # newmv, zeromv, refmv, drl
    (None, 8, 8, 9),      # inter compound mode
    (None, 22, 2, 3),     # compound type
    (None, 22, 16, 17),   # wedge index
    (None, 26, 2, 3),     # interintra, wedge interintra
    (None, 4, 4, 5),      # interintra mode
    (None, 22, 3, 4),     # motion mode
    (None, 22, 2, 3),     # obmc
    ("kDefaultPaletteYSizeCdf", 7, 7, 8), ("kDefaultPaletteUvSizeCdf", 7, 7, 8),
    ("kDefaultPaletteYColorCdf", 35, [n for n in range(2, 9) for _ in range(5)], 9),
    ("kDefaultPaletteUvColorCdf", 35, [n for n in range(2, 9) for _ in range(5)], 9),
    ("kDefaultPaletteYModeCdf", 21, 2, 3), ("kDefaultPaletteUvModeCdf", 2, 2, 3),
    (None, 5 + 18 + 5 + 9 + 9 + 6, 2, 3),  # inter references
    ("kDefaultTxfmSplitCdf", 21, 2, 3),     # txfm_partition (var-tx)
    (None, 6 + 6 + 3, 2, 3),  # compound index and group, skip mode
    ("kDefaultSkipCdf", 3, 2, 3),
    (None, 4, 2, 3),      # intra / inter
    (None, len(_MV), _MV, None),          # nmvc
    ("kDefaultMvCdf", len(_MV), _MV, None),  # ndvc, the intra block copy's
    ("kDefaultIntrabcCdf", 1, 2, 3),
    (None, 3, 2, 3), (None, 3, 8, 9),     # segmentation
    ("kDefaultFilterIntraCdf", 22, 2, 3), ("kDefaultFilterIntraModeCdf", 1, 5, 6),
    ("kDefaultSwitchableRestoreCdf", 1, 3, 4),
    ("kDefaultWienerRestoreCdf", 1, 2, 3), ("kDefaultSgrprojRestoreCdf", 1, 2, 3),
    (None, 4, 13, 14),                    # y mode of inter frames
    ("kDefaultUvModeCflNotAllowedCdf", 13, 13, 15),
    ("kDefaultUvModeCflAllowedCdf", 13, 14, 15),
    ("kDefaultPartitionCdf", 20, [4] * 4 + [10] * 12 + [8] * 4, 11),
    (None, 16, 3, 4),     # switchable interp
    ("kDefaultKfYModeCdf", 25, 13, 14), ("kDefaultAngleDeltaCdf", 8, 7, 8),
    ("kDefaultTxSizeCdf", 12, [2] * 3 + [3] * 9, 4),
    ("kDefaultDeltaQCdf", 1, 4, 5), (None, 5, 4, 5),  # delta lf (multi, one)
    # the intra transform types: set 0 (DCT only) unused, TX_SET_INTRA_1
    # and TX_SET_INTRA_2, by the square transform size and the intra mode
    ("kDefaultIntraExtTxCdf", 156, [0] * 52 + [7] * 52 + [5] * 52, 17),
    # the inter transform types (an intra block copy's): set 0 unused,
    # TX_SET_INTER_1 (16 types), _2 (12), _3 (2), by square size
    ("kDefaultInterExtTxCdf", 16, [0] * 4 + [16] * 4 + [12] * 4 + [2] * 4, 17),
    ("kDefaultCflSignCdf", 1, 8, 9), ("kDefaultCflAlphaCdf", 6, 16, 17),
]
# the shapes the header gives each table (before the row length)
SHAPES = {
    "kDefaultKfYModeCdf": [5, 5], "kDefaultUvModeCflNotAllowedCdf": [13],
    "kDefaultUvModeCflAllowedCdf": [13], "kDefaultPartitionCdf": [20],
    "kDefaultAngleDeltaCdf": [8], "kDefaultSkipCdf": [3],
    "kDefaultIntrabcCdf": [], "kDefaultFilterIntraCdf": [22],
    "kDefaultFilterIntraModeCdf": [], "kDefaultCflSignCdf": [],
    "kDefaultCflAlphaCdf": [6], "kDefaultPaletteYModeCdf": [7, 3],
    "kDefaultPaletteUvModeCdf": [2], "kDefaultPaletteYSizeCdf": [7],
    "kDefaultPaletteUvSizeCdf": [7], "kDefaultPaletteYColorCdf": [7, 5],
    "kDefaultPaletteUvColorCdf": [7, 5],
    "kDefaultSwitchableRestoreCdf": [], "kDefaultWienerRestoreCdf": [],
    "kDefaultSgrprojRestoreCdf": [], "kDefaultTxSizeCdf": [4, 3],
    "kDefaultDeltaQCdf": [], "kDefaultIntraExtTxCdf": [3, 4, 13],
    "kDefaultTxfmSplitCdf": [21], "kDefaultInterExtTxCdf": [4, 4],
}
# the coefficient CDFs of the four quantizer contexts: (name, records of
# one context, symbols, row length, shape of one context)
COEFF = [
    ("kDefaultTxbSkipCdf", 65, 2, 3, [5, 13]),
    ("kDefaultEobExtraCdf", 90, 2, 3, [5, 2, 9]),
    ("kDefaultDcSignCdf", 6, 2, 3, [2, 3]),
    ("kDefaultEobPt16Cdf", 4, 5, 6, [2, 2]),
    ("kDefaultEobPt32Cdf", 4, 6, 7, [2, 2]),
    ("kDefaultEobPt64Cdf", 4, 7, 8, [2, 2]),
    ("kDefaultEobPt128Cdf", 4, 8, 9, [2, 2]),
    ("kDefaultEobPt256Cdf", 4, 9, 10, [2, 2]),
    ("kDefaultEobPt512Cdf", 4, 10, 11, [2, 2]),
    ("kDefaultEobPt1024Cdf", 4, 11, 12, [2, 2]),
    ("kDefaultCoeffBaseEobCdf", 40, 3, 4, [5, 2, 4]),
]
BASE, BR = ("kDefaultCoeffBaseCdf", 420, [5, 2, 42]), ("kDefaultCoeffBrCdf", 210, [5, 2, 21])


def libaom_path() -> str:
    import cv2
    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)),
                        "opencv_python.libs")
    found = glob.glob(os.path.join(libs, "libaom-*.so.3.14.1"))
    if len(found) != 1:
        raise SystemExit(f"no single libaom 3.14.1 beside cv2: {found}")
    return found[0]


def rodata(data: bytes):
    """(file offset, bytes) of the ELF's .rodata section."""
    shoff, = struct.unpack_from("<Q", data, 0x28)
    shentsize, shnum, shstrndx = struct.unpack_from("<HHH", data, 0x3A)
    sec = [struct.unpack_from("<IIQQQQ", data, shoff + i * shentsize)
           for i in range(shnum)]
    names = sec[shstrndx][4]
    for name, _, _, _, off, size in sec:
        end = data.index(b"\0", names + name)
        if data[names + name:end] == b".rodata":
            return off, data[off:off + size]
    raise SystemExit("no .rodata in the library")


def record_ok(u: np.ndarray, i: int, n: int, row: int) -> bool:
    """A CDF of n symbols at u[i], its row of `row` entries (n = 0: a row
    of zeros)."""
    if i + row > len(u):
        return False
    if n == 0:
        return not u[i:i + row].any()
    v = u[i:i + n - 1].astype(np.int64)
    if len(v) and (v[0] >= 32768 or v[-1] <= 0 or np.any(np.diff(v) >= 0)):
        return False
    return not u[i + n - 1:i + row].any()


def _valid(u: np.ndarray, n: int, row: int) -> np.ndarray:
    """record_ok at every index of u, at once."""
    m = len(u) - row
    w = u.astype(np.int64)
    ok = np.ones(m, bool)
    for k in range(n - 1):
        ok &= (w[k:k + m] > 0) & (w[k:k + m] < 32768)
        if k:
            ok &= w[k:k + m] < w[k - 1:k - 1 + m]
    for k in range(n - 1, row):
        ok &= w[k:k + m] == 0
    return np.concatenate([ok, np.zeros(row, bool)])


def runs(u: np.ndarray, n: int, row: int, count: int, align: int = 16):
    """Starts (uint16 index) of maximal aligned runs of exactly `count`
    records of n symbols: the record after the run does not parse, and no
    aligned start before it reaches it by whole records."""
    ok = _valid(u, n, row)
    out = []
    for i in np.nonzero(ok)[0]:
        if i % align or i + (count + 1) * row > len(u):
            continue
        if not ok[i + row * np.arange(count)].all() or ok[i + count * row]:
            continue
        j, extends = i, False
        while j - row >= 0 and ok[j - row]:
            j -= row
            if j % align == 0:
                extends = True
                break
        if not extends:
            out.append(int(i))
    return out


def records(u: np.ndarray, i: int, ns, row: int):
    """The value rows of consecutive records from u[i]; raises unless each
    parses."""
    rows = []
    for n in ns:
        r = row or n + 1
        if not record_ok(u, i, n, r):
            raise SystemExit(f"no CDF of {n} symbols at {i}: {u[i:i + r]}")
        rows.append(u[i:i + r].copy())
        i += r
    return rows, i


def find_coefficients(ro: bytes):
    u = np.frombuffer(ro[:len(ro) & ~1], "<u2")
    tables = {}
    for name, count, n, row, shape in COEFF:
        at = runs(u, n, row, 4 * count)
        if len(at) != 1:
            raise SystemExit(f"{name}: {len(at)} runs of {4 * count} CDFs "
                             f"of {n} symbols, not one")
        tables[name] = (u[at[0]:at[0] + 4 * count * row], [4] + shape + [row])
    total = 4 * (BASE[1] + BR[1])
    at = runs(u, 4, 5, total)
    if len(at) != 1:
        raise SystemExit(f"coefficient base and range: {len(at)} runs")
    both = u[at[0]:at[0] + total * 5].reshape(total, 5)
    base, br = both[:4 * BASE[1]], both[4 * BASE[1]:]
    # the base table's contexts 11-20 are unused at 4x4 (the uniform CDF)
    # in every (quantizer, transform size 4x4, plane) block of 42: the split
    uniform = np.array([24576, 16384, 8192, 0, 0])
    for q in range(4):
        for p in range(2):
            blk = base[(q * 10 + p) * 42:(q * 10 + p + 1) * 42]
            if not (blk[11:21] == uniform).all():
                raise SystemExit("coefficient base table: contexts 11-20 "
                                 "of 4x4 are not the uniform CDF")
    tables[BASE[0]] = (base.ravel(), [4] + BASE[2] + [5])
    tables[BR[0]] = (br.ravel(), [4] + BR[2] + [5])
    return tables, u[at[0]:at[0] + 5]


def frame_context_images(so: str, kf_y: bytes, txb0: bytes):
    """The frame contexts libaom's decoder builds for a key frame: the
    heap of this process after one decode, at each copy of the qctx-0 txb
    skip table followed within the context by the kf y table."""
    import cv2

    def heap_maps():
        # the decoder's contexts are on the heap: [heap] or anonymous maps
        with open("/proc/self/maps") as f:
            lines = f.read().splitlines()
        out = set()
        for line in lines:
            m = re.match(r"([0-9a-f]+)-([0-9a-f]+) rw\S* \S+ \S+ \S+\s*(\S*)$", line)
            if m and m[3] in ("", "[heap]"):
                out.add((int(m[1], 16), int(m[2], 16), m[3]))
        return out

    before = heap_maps()
    lib = ctypes.CDLL(so)
    lib.aom_codec_av1_dx.restype = ctypes.c_void_p
    ctx = ctypes.create_string_buffer(1024)
    abi = next((v for v in range(64) if lib.aom_codec_dec_init_ver(
        ctx, ctypes.c_void_p(lib.aom_codec_av1_dx()), None, ctypes.c_long(0),
        ctypes.c_int(v)) == 0), None)
    if abi is None:
        raise SystemExit("libaom's decoder does not start")
    img = np.random.default_rng(0).integers(0, 256, (64, 64, 3), np.uint8)
    ok, buf = cv2.imencode(".avif", img, [cv2.IMWRITE_AVIF_QUALITY, 100])
    data, off = buf.tobytes(), 0
    while data[off + 4:off + 8] != b"mdat":
        off += struct.unpack_from(">I", data, off)[0]
    av1 = data[off + 8:off + struct.unpack_from(">I", data, off)[0]]
    if lib.aom_codec_decode(ctx, av1, ctypes.c_size_t(len(av1)), None):
        raise SystemExit("libaom does not decode cv2's AVIF")
    images = []
    # the heap and what the decoder mapped: the anonymous maps already there
    # before it started are other libraries' reservations
    for a0, a1, name in sorted(m for m in heap_maps() if m not in before or m[2]):
        mem = ctypes.string_at(a0, a1 - a0)
        i = mem.find(txb0)
        while i >= 0:
            j = mem.find(kf_y, i)
            if 0 < j - i < 40000:
                images.append(np.frombuffer(mem[i:i + 24000], "<u2").copy())
            i = mem.find(txb0, i + 1)
    lib.aom_codec_destroy(ctx)
    if not images:
        raise SystemExit("no frame context found in the decoder's memory")
    return images


def parse_context(u: np.ndarray):
    tables, i = {}, 0
    for name, count, ns, row in LAYOUT:
        ns = ns if isinstance(ns, list) else [ns] * count
        rows, i = records(u, i, ns, row)
        if name:
            tables[name] = rows
    return tables, i


def find_once(ro: bytes, pattern: bytes, what: str) -> int:
    at = [m.start() for m in re.finditer(re.escape(pattern), ro)]
    if len(at) != 1:
        raise SystemExit(f"{what}: found {len(at)} times, not once")
    return at[0]


def other_tables(ro: bytes):
    out = {}
    # the 4x4 zig-zag: odd anti-diagonals run down-left, even ones up-right
    spec = []
    for d in range(7):
        cells = [(r, d - r) for r in range(4) if 0 <= d - r < 4]
        spec += [r * 4 + c for r, c in (cells if d % 2 else cells[::-1])]
    libaom = np.array([(p & 3) * 4 + (p >> 2) for p in spec], "<i2")
    find_once(ro, libaom.tobytes(), "the 4x4 default scan")
    out["kDefaultScan4x4"] = ("uint16_t", [16], spec)
    # smooth weights: the runs of 4, 8, 16, 32, 64 from 255, non-increasing
    found = set()
    for m in re.finditer(re.escape(bytes([255])), ro):
        blk = np.frombuffer(ro[m.start():m.start() + 124], np.uint8)
        if len(blk) < 124:
            continue
        ok, at = True, 0
        for n in (4, 8, 16, 32, 64):
            r = blk[at:at + n].astype(int)
            ok = ok and r[0] == 255 and (np.diff(r) <= 0).all() and r[-1] > 0
            at += n
        if ok:
            found.add(blk.tobytes())
    if len(found) != 1:
        raise SystemExit(f"smooth weights: {len(found)} different tables")
    out["kSmoothWeights"] = ("uint8_t", [124], list(found.pop()))
    # directional derivatives: 90 uint16, the non-zero ones falling from
    # 1023 (at angle 3) to 3 (at 87)
    u = np.frombuffer(ro[:len(ro) & ~1], "<u2")
    cands = []
    for i in np.nonzero(u == 1023)[0]:
        w = u[i - 3:i + 87].astype(int)
        nz = w[w > 0]
        if len(w) == 90 and nz[0] == 1023 and nz[-1] == 3 and \
                (np.diff(nz) < 0).all() and w[87] == 3 and not w[:3].any():
            cands.append(w)
    if len(cands) != 1:
        raise SystemExit(f"directional derivatives: {len(cands)} found")
    out["kDrIntraDerivative"] = ("uint16_t", [90], list(cands[0]))
    # filter-intra taps: int8 [5][8][8], seven taps to a row summing to 16
    a = np.frombuffer(ro, np.int8)
    taps = []
    for i in range(len(a) - 320):
        if a[i] >= 0 or a[i + 7] != 0:
            continue
        blk = a[i:i + 320].reshape(40, 8).astype(int)
        if (blk[:, 7] == 0).all() and (blk[:, :7].sum(1) == 16).all():
            taps.append(blk.reshape(5, 8, 8)[:, :, :7])
    if len(taps) != 1:
        raise SystemExit(f"filter-intra taps: {len(taps)} found")
    out["kFilterIntraTaps"] = ("int8_t", [5, 8, 7], list(taps[0].ravel()))
    # palette colour context: int32 [9], -1 at the hashes the three ranked
    # neighbour scores cannot give, the contexts 0-4 elsewhere
    # left +2, above-left +1, above +2: the three best scores of one, two
    # or three colours hash (1, 2, 2) to 2, 5, 6, 7 or 8
    hashes = {2, 5, 6, 7, 8}
    cands = []
    for m in re.finditer(re.escape(struct.pack("<i", -1)), ro):
        v = np.frombuffer(ro[m.start():m.start() + 36], "<i4")
        if len(v) == 9 and all((v[h] == -1) == (h not in hashes) for h in range(9)) \
                and sorted(v[v >= 0]) == [0, 1, 2, 3, 4]:
            cands.append(list(v))
    if len(cands) != 1:
        raise SystemExit(f"palette colour context: {len(cands)} found")
    out["kPaletteColorContext"] = ("int8_t", [9], cands[0])
    out.update(lossy_tables(ro))
    return out


# the transform sizes below 64 in libaom's TX_SIZES_ALL order (the order of
# its quantizer matrices), as (width, height)
QM_SIZES = [(4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16),
            (16, 8), (16, 32), (32, 16), (4, 16), (16, 4), (8, 32), (32, 8)]


def spec_scan(w: int, h: int):
    """The specification's default scan of a w x h block (positions
    r * w + c): anti-diagonals, each from its top row down for a block
    taller than wide, from its bottom row up for one wider than tall; a
    square's zig-zags (odd diagonals down, even ones up)."""
    out = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(h) if 0 <= d - r < w]
        if w > h or (w == h and d % 2 == 0):
            cells = cells[::-1]
        out += [r * w + c for r, c in cells]
    return out


def lossy_tables(ro: bytes):
    """The tables a lossy frame reads: the quantizer lookups, the quantizer
    matrices, the scans of every transform size, the cosine and sine
    tables of the inverse transforms."""
    out = {}
    s16 = np.frombuffer(ro[:len(ro) & ~1], "<i2")
    # Dc_Qlookup and Ac_Qlookup at 8, 10 and 12 bits: 256 non-decreasing
    # int16 from 4, found by the first steps libaom's tables take (at 8,
    # 10 and 12 bits: 4 then 8, 8 / 9, 10 / 12, 18 for DC and 8, 9 / 9, 11 /
    # 13, 19 for AC) and their structure
    for kind, heads in (("Dc", ((8, 8), (9, 10), (12, 18))),
                        ("Ac", ((8, 9), (9, 11), (13, 19)))):
        rows = []
        for v, v2 in heads:
            at = [i for i in np.nonzero(s16[:-256] == 4)[0]
                  if s16[i + 1] == v and s16[i + 2] == v2
                  and (np.diff(s16[i:i + 256]) >= 0).all()
                  and s16[i + 255] > 1000]
            if len(at) != 1:
                raise SystemExit(f"{kind}_Qlookup from (4, {v}, {v2}): "
                                 f"{len(at)} found")
            rows.append(s16[at[0]:at[0] + 256].astype(int))
        out[f"k{kind}Qlookup"] = ("int16_t", [3, 256], np.concatenate(rows))
    # the inverse quantizer matrices: 15 levels x 2 (luma, chroma) x 3344
    # bytes of weights, the square ones (4x4, 8x8, 16x16) symmetric;
    # libaom keeps a rectangle's by column, the tool writes it by row
    b = np.frombuffer(ro, np.uint8)
    total = 15 * 2 * 3344

    def symmetric(a, n):
        m = b[a:a + n * n].reshape(n, n).astype(int)
        return m.min() >= 16 and (m == m.T).all()

    found = []
    for a in np.nonzero(b[:len(b) - total] >= 16)[0]:
        if all(symmetric(a + k * 3344, 4) and symmetric(a + k * 3344 + 16, 8)
               and symmetric(a + k * 3344 + 80, 16) for k in range(30)):
            found.append(a)
            if len(found) > 1:
                break
    qm = b[found[0]:found[0] + total].reshape(30, 3344).astype(int)
    spec = np.zeros_like(qm)
    at = 0
    for w, h in QM_SIZES:
        m = qm[:, at:at + w * h].reshape(30, w, h)  # [col][row]
        spec[:, at:at + w * h] = m.transpose(0, 2, 1).reshape(30, -1)
        at += w * h
    out["kQuantizerMatrix"] = ("uint8_t", [15, 2, 3344], spec.ravel())
    # the scans: each default scan is in libaom (by column); the row and
    # column scans of the sizes a one-dimensional transform takes
    for w, h in QM_SIZES:
        sc = spec_scan(w, h)
        lib = np.array([(p % w) * h + p // w for p in sc], "<i2").tobytes()
        if lib not in ro:
            raise SystemExit(f"the default scan of {w}x{h} is not libaom's")
        if (w, h) != (4, 4):
            out[f"kDefaultScan{w}x{h}"] = ("uint16_t", [w * h], sc)
        if w <= 16 and h <= 16:
            out[f"kMrowScan{w}x{h}"] = ("uint16_t", [w * h], list(range(w * h)))
            out[f"kMcolScan{w}x{h}"] = ("uint16_t", [w * h],
                                       [r * w + c for c in range(w) for r in range(h)])
    # cos128 (4096 cos(i pi / 128)) and the ADST4 sines, as libaom keeps
    # them for a cos_bit of 12
    cos = [round(4096 * np.cos(i * np.pi / 128)) for i in range(64)]
    find_once(ro, np.array(cos, "<i4").tobytes(), "the cosine table")
    out["kCos128"] = ("int16_t", [65], cos + [0])
    sin = [round(4096 * 2 * np.sqrt(2) / 3 * np.sin(k * np.pi / 9)) for k in range(5)]
    find_once(ro, np.array(sin, "<i4").tobytes(), "the ADST4 sines")
    out["kSinpi"] = ("int16_t", [5], sin)
    # Sgr_Params: libaom's 16 {r0, r1, s0, s1} (int32), the radii 2 / 0
    # and 1 / 0 (not both 0), a scale of -1 exactly where its radius is 0;
    # written as the specification's {r0, s0, r1, s1}
    s32 = np.frombuffer(ro[:len(ro) & ~3], "<i4")
    found = []
    for a in np.nonzero(s32[:-64] == 2)[0]:
        v = s32[a:a + 64].reshape(16, 4)
        if not (np.isin(v[:, 0], (0, 2)).all() and np.isin(v[:, 1], (0, 1)).all()):
            continue
        if ((v[:, 0] == 0) & (v[:, 1] == 0)).any():
            continue
        if ((v[:, 2] == -1) == (v[:, 0] == 0)).all() and \
                ((v[:, 3] == -1) == (v[:, 1] == 0)).all() and \
                (v[:, 2:][v[:, :2] > 0] > 0).all():
            found.append(v)
    if len(found) != 1:
        raise SystemExit(f"self-guided parameters: {len(found)} found")
    v = found[0]
    out["kSgrParams"] = ("int16_t", [16, 4],
                         np.stack([v[:, 0], v[:, 2], v[:, 1], v[:, 3]], 1).ravel())
    return out


def header(tables, others, src: str) -> str:
    lines = [
        "// The constant tables of the AV1 decoder (av1_*.cpp): libaom",
        "// 3.14.1's default CDFs, inverted (32768 - the CDF) with each",
        "// record's counter slot, and the specification's scans, smooth",
        "// weights, directional derivatives, filter-intra taps, palette",
        "// colour context, quantizer lookups and matrices, cosines and",
        "// self-guided parameters. Written by",
        "// semi_detr_tpu_torch/tools/av1_table.py",
        f"// from cv2's {src}.",
        "#pragma once", "", "#include <cstdint>", "",
        "namespace sdt {", "namespace av1 {", ""]
    for name, (ty, shape, values) in list(tables.items()) + list(others.items()):
        dims = "".join(f"[{d}]" for d in shape)
        lines.append(f"inline constexpr {ty} {name}{dims} = {{")
        vals = [str(int(v)) for v in values]
        for k in range(0, len(vals), 12):
            lines.append("    " + ", ".join(vals[k:k + 12]) + ",")
        lines.append("};")
    lines += SPEC_TABLES + ["", "}  // namespace av1", "}  // namespace sdt", ""]
    return "\n".join(lines)


# the specification's fixed tables the decoder reads beside libaom's
SPEC_TABLES = """\
// From the AV1 specification: Palette_Color_Hash_Multipliers;
// Coeff_Base_Ctx_Offset by the transform's shape (square, wider than tall,
// taller than wide), Coeff_Base_Pos_Ctx_Offset, Sig_Ref_Diff_Offset and
// Mag_Ref_Offset_With_Tx_Class by transform class (two-dimensional,
// horizontal, vertical); Max_Tx_Depth by block size; Transform_Row_Shift
// by transform size; CDEF's Div_Table, Cdef_Pri_Taps, Cdef_Sec_Taps and
// Cdef_Directions; the Wiener taps' and self-guided weights' ranges
inline constexpr uint8_t kPaletteColorHashMultipliers[3] = {1, 2, 2};
inline constexpr uint8_t kCoeffBaseCtxOffset[3][5][5] = {
    {{0, 1, 6, 6, 21}, {1, 6, 6, 21, 21}, {6, 6, 21, 21, 21},
     {6, 21, 21, 21, 21}, {21, 21, 21, 21, 21}},
    {{0, 16, 6, 6, 21}, {16, 16, 6, 21, 21}, {16, 16, 21, 21, 21},
     {16, 16, 21, 21, 21}, {16, 16, 21, 21, 21}},
    {{0, 11, 11, 11, 11}, {11, 11, 11, 11, 11}, {6, 6, 21, 21, 21},
     {6, 21, 21, 21, 21}, {21, 21, 21, 21, 21}}};
inline constexpr uint8_t kCoeffBasePosCtxOffset[3] = {26, 31, 36};
inline constexpr int8_t kSigRefDiffOffset[3][5][2] = {
    {{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
    {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
    {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
inline constexpr int8_t kMagRefOffset[3][3][2] = {
    {{0, 1}, {1, 0}, {1, 1}}, {{0, 1}, {1, 0}, {0, 2}}, {{0, 1}, {1, 0}, {2, 0}}};
inline constexpr uint8_t kMaxTxDepth[22] = {0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4,
                                            4, 4, 4, 4, 4, 2, 2, 3, 3, 4, 4};
inline constexpr uint8_t kTransformRowShift[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1,
                                                   1, 1, 1, 1, 1, 2, 2, 2, 2};
inline constexpr int16_t kCdefDivTable[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
inline constexpr uint8_t kCdefPriTaps[2][2] = {{4, 2}, {3, 3}};
inline constexpr uint8_t kCdefSecTaps[2][2] = {{2, 1}, {2, 1}};
inline constexpr int8_t kCdefDirections[8][2][2] = {
    {{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}}, {{0, 1}, {1, 2}},
    {{1, 1}, {2, 2}},   {{1, 0}, {2, 1}},  {{1, 0}, {2, 0}}, {{1, 0}, {2, -1}}};
inline constexpr int8_t kWienerTapsMin[3] = {-5, -23, -17};
inline constexpr int8_t kWienerTapsMax[3] = {10, 8, 46};
inline constexpr int8_t kWienerTapsK[3] = {1, 2, 3};
inline constexpr int8_t kWienerTapsMid[3] = {3, -7, 15};
inline constexpr int8_t kSgrprojXqdMin[2] = {-96, -32};
inline constexpr int8_t kSgrprojXqdMax[2] = {31, 95};
inline constexpr int8_t kSgrprojXqdMid[2] = {-32, 31};""".split("\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--so", default=None, help="cv2's libaom (found beside cv2)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    so = args.so or libaom_path()
    with open(so, "rb") as f:
        data = f.read()
    _, ro = rodata(data)
    coeff, _ = find_coefficients(ro)
    u = np.frombuffer(ro[:len(ro) & ~1], "<u2")
    kf = runs(u, 13, 14, 25)
    if len(kf) != 1:
        raise SystemExit(f"key frame y mode table: {len(kf)} runs")
    kf_y = u[kf[0]:kf[0] + 350].tobytes()
    txb0 = coeff["kDefaultTxbSkipCdf"][0][:195].tobytes()
    images = frame_context_images(so, kf_y, txb0)
    # the tile's own copy adapts as it decodes (its counters count): only
    # the untouched contexts parse
    parsed = []
    for img in images:
        try:
            parsed.append(parse_context(img))
        except SystemExit:
            continue
    if not parsed:
        raise SystemExit("no frame context of default CDFs parses")
    first, end = parsed[0]
    for other, _ in parsed[1:]:
        if any(not np.array_equal(np.concatenate(first[k]), np.concatenate(other[k]))
               for k in first):
            raise SystemExit("the decoder's frame contexts differ")
    # the context's coefficient tables are those of quantizer context 0
    for name in [c[0] for c in COEFF] + [BASE[0], BR[0]]:
        ctx0 = np.concatenate(first[name + "0"])
        if not np.array_equal(ctx0, coeff[name][0][:len(ctx0)]):
            raise SystemExit(f"{name}: .rodata and the frame context differ")
    tables = {}
    for name, (flat, shape) in coeff.items():
        tables[name] = ("uint16_t", shape, flat)
    for name, shape in SHAPES.items():
        rows = first[name]
        tables[name] = ("uint16_t", shape + [len(rows[-1])], np.concatenate(rows))
    mv = np.concatenate(first["kDefaultMvCdf"])
    tables["kDefaultMvCdf"] = ("uint16_t", [len(mv)], mv)
    text = header(tables, other_tables(ro), os.path.basename(so))
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out}: {len(tables)} CDF tables, frame context of "
          f"{end} entries in {len(parsed)} of {len(images)} copies")
    return len(parsed)


if __name__ == "__main__":
    main()
