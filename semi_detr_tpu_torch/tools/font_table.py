"""Write the fonts of `utils/text.py` from the fonts inside cv2.

cv2 5.0 draws `cv2.putText(..., FONT_HERSHEY_SIMPLEX, ...)` with Rubik, a
TrueType variable font (one axis, `wght`, 300-900), and draws a character
Rubik lacks from WenQuanYi Micro Hei, a static TrueType font. Its binary
carries both as gzip members (`Rubik.ttf`, `WenQuanYiMicroHei.ttf`). This
tool takes them out of the installed `cv2` module's shared library and
writes:

* `rubik_wght400.json`: every code point of Rubik's cmap, instanced at
  the weight thickness 1 draws (`text.WGHT`) as cv2's renderer instances
  it. Its variation code works in fixed point: the `wght` location
  normalised, mapped by `avar` and rounded to F2Dot14 (400 -> 3072); a
  tuple's scalar in 16.16 (`0x10000 * coord / peak`, each axis divided in
  integers toward zero); each delta added as `(delta * scalar) >> 8` and
  the sum as `>> 8` (a floor to whole font units). Points a tuple leaves
  out are inferred in integers (`/` toward zero) from the touched points
  on either side; where a contour's first point is untouched, the points
  after its last touched point copy that point's delta (the wrap-around
  segment is not interpolated there; cv2 does so, and the tests hold every
  glyph to its pixels). A glyph's advance is its `hmtx` advance plus the
  floored deltas of its two horizontal phantom points (`HVAR` is not
  read). A simple glyph's points are written as steps from the point
  before (the first from the origin); a composite glyph as its components
  (glyph names) and their offsets after the variation: Rubik's are all
  unscaled;
* `WenQuanYiMicroHei.ttf.gz`: the gzip member itself, byte for byte
  (`utils/truetype.py` parses it at run time);
* the licence notices from each font's own `name` table (IDs 0, 13 and
  14): Rubik under the SIL Open Font License 1.1, WenQuanYi Micro Hei under
  the Apache License 2.0, whose text goes beside it (`--apache-license`,
  Debian's copy by default).

No kerning is written: cv2 applies none (`AV` and `To` draw at the plain
advances).

It runs only where cv2 and fontTools are installed (both are imported in
`main`); no module of the port imports it. What it writes is committed,
and the tests run it again and compare the bytes.

    python -m semi_detr_tpu_torch.tools.font_table [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import zlib

MEMBER = b"Rubik.ttf"
FALLBACK_MEMBER = b"WenQuanYiMicroHei.ttf"
TABLE_NAME = "rubik_wght400.json"
NOTICE_NAME = "Rubik-OFL.txt"
FALLBACK_NAME = "WenQuanYiMicroHei.ttf.gz"
FALLBACK_NOTICE = "WenQuanYiMicroHei-NOTICE.txt"
APACHE_NAME = "Apache-2.0.txt"
APACHE_DEFAULT = "/usr/share/common-licenses/Apache-2.0"
SEP = (",", ":")
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "utils", "fonts")


def gzip_member_bytes(blob: bytes, name: bytes) -> bytes:
    """The bytes of the gzip member of `blob` whose header names `name`
    (FNAME flag, RFC 1952): header, deflate stream and trailer."""
    for m in re.finditer(rb"\x1f\x8b\x08", blob):
        off, flags = m.start(), blob[m.start() + 3]
        if not flags & 0x08:
            continue
        p = off + 10
        if flags & 0x04:
            p += 2 + int.from_bytes(blob[p:p + 2], "little")
        end = blob.find(b"\0", p)
        if end < 0 or blob[p:end] != name:
            continue
        if flags & 0x10:
            end = blob.find(b"\0", end + 1)
        if flags & 0x02:
            end += 2
        start = end + 1
        d = zlib.decompressobj(-zlib.MAX_WBITS)
        d.decompress(blob[start:])
        if not d.eof:
            raise ValueError(f"gzip member {name!r} is cut short")
        stop = len(blob) - len(d.unused_data) + 8
        return blob[off:stop]
    raise ValueError(f"no gzip member named {name!r}")


def gzip_member(blob: bytes, name: bytes) -> bytes:
    """The inflated data of the gzip member of `blob` named `name`."""
    member = gzip_member_bytes(blob, name)
    data = zlib.decompress(member, 16 + zlib.MAX_WBITS)
    return data


def cv2_library() -> str:
    """The path of the installed cv2 module's shared library."""
    import cv2
    d = os.path.dirname(cv2.__file__)
    libs = [f for f in sorted(os.listdir(d))
            if f.startswith("cv2") and f.endswith(".so")]
    if not libs:
        raise FileNotFoundError(f"no cv2*.so in {d}")
    return os.path.join(d, libs[0])


def normalized_wght(font, wght: float) -> float:
    """`wght` in the font's normalised space, as the variation applies it:
    the axis range, then `avar`, then F2Dot14."""
    from fontTools.misc.fixedTools import floatToFixedToFloat
    from fontTools.varLib.models import normalizeValue, piecewiseLinearMap
    axis, = [a for a in font["fvar"].axes if a.axisTag == "wght"]
    v = normalizeValue(wght, (axis.minValue, axis.defaultValue,
                              axis.maxValue))
    if "avar" in font:
        v = piecewiseLinearMap(v, font["avar"].segments["wght"])
    return floatToFixedToFloat(v, 14)


# ---------------------------------------------------------------------------
# cv2's variation arithmetic
# ---------------------------------------------------------------------------

def _div0(a: int, b: int) -> int:
    """C's integer division, toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def tuple_scalar(axes: dict, location: dict) -> int:
    """A tuple's scalar at `location` (F2Dot14 integers), 16.16."""
    s = 0x10000
    for tag, (start, peak, end) in axes.items():
        p, c = round(peak * 16384), location.get(tag, 0)
        lo, hi = round(start * 16384), round(end * 16384)
        if p == 0 or c == p:
            continue
        if c == 0:
            return 0
        if lo == min(p, 0) and hi == max(p, 0):
            if (c > 0 and c > p) or (c < 0 and c < p):
                return 0
            s = _div0(s * c, p)
        else:
            if c > hi or c < lo:
                return 0
            s = _div0(s * (c - lo), p - lo) if p > c else \
                _div0(s * (hi - c), hi - p)
    return s


def _infer(x, x1, x2, d1, d2):
    if x1 == x2:
        return d1 if d1 == d2 else 0
    if x1 > x2:
        x1, x2, d1, d2 = x2, x1, d2, d1
    if x <= x1:
        return d1
    if x >= x2:
        return d2
    return _div0(d1 * (x2 - x1) + (x - x1) * (d2 - d1), x2 - x1)


def infer_deltas(coords, deltas, ends):
    """The deltas of the points a tuple leaves out (None), contour by
    contour, as cv2 infers them."""
    d = list(deltas)
    touched = [v is not None for v in d]
    s = 0
    for e in ends:
        if e < s:
            s = e + 1
            continue
        if touched[s]:
            prev = anchor = s
            j = s + 1
        else:
            last = next((r for r in range(e, s, -1) if touched[r]), None)
            if last is None:
                d[s:e + 1] = [(0, 0)] * (e + 1 - s)
                s = e + 1
                continue
            prev = anchor = last
            j = s
        nxt = -1
        while j <= e:
            if touched[j]:
                if nxt == j:
                    nxt = -1
                prev = j
            else:
                if nxt < 0:
                    nxt = next((r for r in range(j + 1, e + 1)
                                if touched[r]), anchor)
                (x, y), (x1, y1), (x2, y2) = coords[j], coords[prev], \
                    coords[nxt]
                d[j] = (_infer(x, x1, x2, d[prev][0], d[nxt][0]),
                        _infer(y, y1, y2, d[prev][1], d[nxt][1]))
            j += 1
        s = e + 1
    return [v if v is not None else (0, 0) for v in d]


def varied_coords(font, name: str, location: dict):
    """(integer points with the 4 phantom points last, the glyph) of glyph
    `name` at `location` (F2Dot14 integers), as cv2 varies them."""
    glyf = font["glyf"]
    hmtx = font["hmtx"].metrics
    vmtx = font["vmtx"].metrics if "vmtx" in font else None
    coords, control = glyf._getCoordinatesAndControls(name, hmtx, vmtx)
    glyph = glyf[name]
    coords = [(int(x), int(y)) for x, y in coords]
    n = len(coords) - 4
    ends = list(glyph.endPtsOfContours) if glyph.numberOfContours > 0 \
        else list(range(n))
    acc = [[0, 0] for _ in coords]
    for var in font["gvar"].variations.get(name, []):
        scalar = tuple_scalar(var.axes, location)
        if not scalar:
            continue
        deltas = list(var.coordinates)
        if None in deltas:
            deltas = infer_deltas(coords, deltas, ends)
        for a, (dx, dy) in zip(acc, deltas):
            a[0] += (dx * scalar) >> 8
            a[1] += (dy * scalar) >> 8
    return [(x + (ax >> 8), y + (ay >> 8))
            for (x, y), (ax, ay) in zip(coords, acc)], glyph


def glyph_entry(font, name: str, location: dict) -> dict:
    coords, glyph = varied_coords(font, name, location)
    pts, phantom = coords[:-4], coords[-4:]
    entry = {"advance": phantom[1][0] - phantom[0][0]}
    if glyph.numberOfContours > 0:
        # the first point, then each point's step from the one before
        entry["steps"] = [v for (x, y), (px, py) in zip(pts, [(0, 0)] + pts)
                          for v in (x - px, y - py)]
        entry["on"] = "".join(str(f & 1) for f in glyph.flags)
        entry["ends"] = list(glyph.endPtsOfContours)
    elif glyph.numberOfContours < 0:
        comps = []
        for c, (dx, dy) in zip(glyph.components, pts):
            if hasattr(c, "transform") or hasattr(c, "firstPt"):
                raise ValueError(f"component of {name!r} is scaled or "
                                 "placed by points")
            if font["glyf"][c.glyphName].numberOfContours < 0:
                raise ValueError(f"component of {name!r} is a composite")
            comps.append([c.glyphName, dx, dy])
        entry["components"] = comps
    return entry


def name_record(font, name_id: int) -> str:
    rec = font["name"].getName(name_id, 3, 1, 0x409) or \
        font["name"].getName(name_id, 1, 0, 0)
    return rec.toUnicode() if rec is not None else ""


def write_table(out_dir: str, library: str,
                apache: str = APACHE_DEFAULT) -> tuple:
    """Write the Rubik table, WenQuanYi's gzip member and the licence
    notices into `out_dir`. Returns their paths."""
    import io

    from fontTools.ttLib import TTFont

    from ..utils import text

    with open(library, "rb") as f:
        blob = f.read()
    ttf = gzip_member(blob, MEMBER)
    font = TTFont(io.BytesIO(ttf))
    norm = normalized_wght(font, text.WGHT)
    location = {"wght": round(norm * 16384)}
    cmap = {chr(c): n for c, n in sorted(font.getBestCmap().items())}
    names = sorted(set(cmap.values()))
    glyphs = {n: glyph_entry(font, n, location) for n in names}
    for entry in list(glyphs.values()):
        for comp, _, _ in entry.get("components", ()):
            if comp not in glyphs:
                glyphs[comp] = glyph_entry(font, comp, location)
    head = {"source": f"{MEMBER.decode()}, a gzip member of cv2 5.0's "
                      "shared library",
            "family": name_record(font, 1),
            "version": name_record(font, 5),
            "ttf_bytes": len(ttf),
            "wght": text.WGHT, "wght_normalized": norm,
            "units_per_em": font["head"].unitsPerEm,
            "ascender": font["hhea"].ascent,
            "descender": font["hhea"].descent,
            "coordinates": "font units after the variation, in cv2's "
                           "fixed point"}
    lines = ["{", f'"font": {json.dumps(head, sort_keys=True)},',
             f'"cmap": {json.dumps(cmap, sort_keys=True, separators=SEP)},',
             '"glyphs": {']
    order = sorted(glyphs)
    for i, name in enumerate(order):
        sep = "," if i < len(order) - 1 else ""
        entry = json.dumps(glyphs[name], sort_keys=True, separators=SEP)
        lines.append(f"{json.dumps(name)}: {entry}{sep}")
    lines += ["}", "}", ""]
    os.makedirs(out_dir, exist_ok=True)
    table = os.path.join(out_dir, TABLE_NAME)
    with open(table, "w", encoding="ascii", newline="\n") as f:
        f.write("\n".join(lines))
    notice = os.path.join(out_dir, NOTICE_NAME)
    with open(notice, "w", encoding="utf-8", newline="\n") as f:
        f.write(f"{TABLE_NAME} holds outlines and advances of the font "
                f"{name_record(font, 4)} ({name_record(font, 5)}),\n"
                "instanced and quantised as that file's header says.\n\n"
                f"{name_record(font, 0)}\n\n{name_record(font, 13)}\n"
                f"{name_record(font, 14)}\n")
    member = gzip_member_bytes(blob, FALLBACK_MEMBER)
    fallback = os.path.join(out_dir, FALLBACK_NAME)
    with open(fallback, "wb") as f:
        f.write(member)
    wqy = TTFont(io.BytesIO(zlib.decompress(member, 16 + zlib.MAX_WBITS)))
    wqy_notice = os.path.join(out_dir, FALLBACK_NOTICE)
    with open(wqy_notice, "w", encoding="utf-8", newline="\n") as f:
        f.write(f"{FALLBACK_NAME} is the gzip member "
                f"{FALLBACK_MEMBER.decode()} of cv2 5.0's shared library,\n"
                f"byte for byte: the font {name_record(wqy, 4)} "
                f"({name_record(wqy, 5)}).\n\n"
                f"{name_record(wqy, 0)}\n\n{name_record(wqy, 13)}\n"
                f"{name_record(wqy, 14)}\n(the text: {APACHE_NAME})\n")
    licence = os.path.join(out_dir, APACHE_NAME)
    shutil.copyfile(apache, licence)
    return table, notice, fallback, wqy_notice, licence


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=DEFAULT_OUT,
                   help="directory of the fonts and the licence notices")
    p.add_argument("--library", default=None,
                   help="cv2's shared library (default: the installed one)")
    p.add_argument("--apache-license", default=APACHE_DEFAULT,
                   help="the text of the Apache License 2.0")
    args = p.parse_args(argv)
    paths = write_table(args.out, args.library or cv2_library(),
                        args.apache_license)
    for path in paths:
        print(path)
    return paths


if __name__ == "__main__":
    main()
