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
    (None, 4, 6, 7), (None, 4, 7, 8), (None, 4, 8, 9), (None, 4, 9, 10),
    (None, 4, 10, 11), (None, 4, 11, 12),
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
    (None, 5 + 18 + 5 + 9 + 9 + 6 + 21 + 6 + 6 + 3, 2, 3),  # inter refs ..
    ("kDefaultSkipCdf", 3, 2, 3),
    (None, 4, 2, 3),      # intra / inter
    (None, len(_MV), _MV, None),          # nmvc
    ("kDefaultMvCdf", len(_MV), _MV, None),  # ndvc, the intra block copy's
    ("kDefaultIntrabcCdf", 1, 2, 3),
    (None, 3, 2, 3), (None, 3, 8, 9),     # segmentation
    ("kDefaultFilterIntraCdf", 22, 2, 3), ("kDefaultFilterIntraModeCdf", 1, 5, 6),
    (None, 1, 3, 4), (None, 2, 2, 3),     # loop restoration
    (None, 4, 13, 14),                    # y mode of inter frames
    ("kDefaultUvModeCflNotAllowedCdf", 13, 13, 15),
    ("kDefaultUvModeCflAllowedCdf", 13, 14, 15),
    ("kDefaultPartitionCdf", 20, [4] * 4 + [10] * 12 + [8] * 4, 11),
    (None, 16, 3, 4),     # switchable interp
    ("kDefaultKfYModeCdf", 25, 13, 14), ("kDefaultAngleDeltaCdf", 8, 7, 8),
    (None, 12, [2] * 3 + [3] * 9, 4),     # tx size
    (None, 6, 4, 5),      # delta q, delta lf
    (None, 156, [0] * 52 + [7] * 52 + [5] * 52, 17),  # intra ext tx
    (None, 16, [0] * 4 + [16] * 4 + [12] * 4 + [2] * 4, 17),  # inter ext tx
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
}
# the coefficient CDFs of the four quantizer contexts: (name, records of
# one context, symbols, row length, shape of one context)
COEFF = [
    ("kDefaultTxbSkipCdf", 65, 2, 3, [5, 13]),
    ("kDefaultEobExtraCdf", 90, 2, 3, [5, 2, 9]),
    ("kDefaultDcSignCdf", 6, 2, 3, [2, 3]),
    ("kDefaultEobPt16Cdf", 4, 5, 6, [2, 2]),
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
    out["kDefaultScan4x4"] = ("uint8_t", [16], spec)
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
    return out


def header(tables, others, src: str) -> str:
    lines = [
        "// The constant tables of the AV1 decoder (av1_*.cpp): libaom",
        "// 3.14.1's default CDFs, inverted (32768 - the CDF) with each",
        "// record's counter slot, and the specification's scan, smooth",
        "// weights, directional derivatives, filter-intra taps and palette",
        "// colour context. Written by semi_detr_tpu_torch/tools/av1_table.py",
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
    lines += ["// Palette_Color_Hash_Multipliers and Coeff_Base_Ctx_Offset at 4x4",
              "inline constexpr uint8_t kPaletteColorHashMultipliers[3] = {1, 2, 2};",
              "inline constexpr uint8_t kCoeffBaseCtxOffset4x4[4][4] = {",
              "    {0, 1, 6, 6}, {1, 6, 6, 21}, {6, 6, 21, 21}, {6, 21, 21, 21}};",
              "", "}  // namespace av1", "}  // namespace sdt", ""]
    return "\n".join(lines)


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
    for name in ("kDefaultTxbSkipCdf", "kDefaultEobExtraCdf", "kDefaultDcSignCdf",
                 "kDefaultEobPt16Cdf", "kDefaultCoeffBaseEobCdf",
                 "kDefaultCoeffBaseCdf", "kDefaultCoeffBrCdf"):
        ctx0 = np.concatenate(first[name + "0"])
        if not np.array_equal(ctx0, coeff[name][0][:len(ctx0)]):
            raise SystemExit(f"{name}: .rodata and the frame context differ")
    tables = {}
    for name, (flat, shape) in coeff.items():
        tables[name] = ("uint16_t", shape, flat)
    for name, shape in SHAPES.items():
        rows = first[name]
        tables[name] = ("uint16_t", shape + [len(rows[0])], np.concatenate(rows))
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
