"""Write the glyph table of `utils/text.py` from the font inside cv2.

cv2 5.0 draws `cv2.putText(..., FONT_HERSHEY_SIMPLEX, ...)` with Rubik, a
TrueType variable font (one axis, `wght`, 300-900) that its binary carries
as a gzip member named `Rubik.ttf`. This tool takes that member out of the
installed `cv2` module's shared library, instances the font at the weight
that thickness 1 draws (`text.WGHT`), and writes, for the printable ASCII
range, what the renderer needs:

* each glyph's points after the variation, as cv2's renderer holds them:
  the `wght` location normalised, mapped by the font's `avar` and rounded
  to F2Dot14 (400 -> 0.1875), the `gvar` deltas applied with IUP, each
  coordinate then floored to a whole font unit; the on-curve flags and the
  contour ends, in the order of the `glyf` table;
* each glyph's advance in font units (the phantom points after the
  variation; the `HVAR` value is the same), not rounded;
* the font's units per em, ascender and descender, and where it came from.

No kerning is written: cv2 applies none (`AV` and `To` draw at the plain
advances). Beside the table goes the licence notice from the font's own
`name` table (IDs 0, 13 and 14: SIL Open Font License 1.1).

It runs only where cv2 and fontTools are installed (both are imported in
`main`); no module of the port imports it. The table it writes is
committed, and the tests run it again and compare the bytes.

    python -m semi_detr_tpu_torch.tools.font_table [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import zlib

MEMBER = b"Rubik.ttf"
TABLE_NAME = "rubik_wght400.json"
NOTICE_NAME = "Rubik-OFL.txt"
FIRST, LAST = 32, 126
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "utils", "fonts")


def gzip_member(blob: bytes, name: bytes) -> bytes:
    """The inflated data of the gzip member of `blob` whose header names
    `name` (FNAME flag, RFC 1952)."""
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
        d = zlib.decompressobj(-zlib.MAX_WBITS)
        data = d.decompress(blob[end + 1:])
        if not d.eof:
            raise ValueError(f"gzip member {name!r} is cut short")
        return data
    raise ValueError(f"no gzip member named {name!r}")


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


def varied_points(font, name: str, location: dict):
    """(points with the 4 phantom points last, the glyph) of glyph `name`
    at the normalised `location`: the `gvar` deltas, IUP-filled where a
    variation leaves points out, added to the default outline."""
    from fontTools.ttLib.tables._g_l_y_f import GlyphCoordinates
    from fontTools.varLib.iup import iup_delta
    from fontTools.varLib.models import supportScalar
    glyf = font["glyf"]
    hmtx = font["hmtx"].metrics
    vmtx = font["vmtx"].metrics if "vmtx" in font else None
    coords, control = glyf._getCoordinatesAndControls(name, hmtx, vmtx)
    ends = control[1] if control[0] >= 1 else list(range(len(control[1])))
    orig = GlyphCoordinates(coords)
    for var in font["gvar"].variations.get(name, []):
        scalar = supportScalar(location, var.axes)
        if not scalar:
            continue
        delta = var.coordinates
        if None in delta:
            delta = iup_delta(delta, orig, ends)
        coords += GlyphCoordinates(delta) * scalar
    return coords, glyf[name]


def glyph_entry(font, ch: str, location: dict) -> dict:
    name = font.getBestCmap()[ord(ch)]
    coords, glyph = varied_points(font, name, location)
    pts, phantom = list(coords[:-4]), list(coords[-4:])
    entry = {"advance": phantom[1][0] - phantom[0][0]}
    if glyph.numberOfContours > 0:
        entry["points"] = [v for x, y in pts
                           for v in (math.floor(x), math.floor(y))]
        entry["on"] = "".join(str(f & 1) for f in glyph.flags)
        entry["ends"] = list(glyph.endPtsOfContours)
    elif glyph.numberOfContours < 0:
        raise ValueError(f"glyph {name!r} is a composite; the table holds "
                         "simple glyphs only")
    return entry


def name_record(font, name_id: int) -> str:
    rec = font["name"].getName(name_id, 3, 1, 0x409) or \
        font["name"].getName(name_id, 1, 0, 0)
    return rec.toUnicode() if rec is not None else ""


def write_table(out_dir: str, library: str) -> tuple:
    """Write the table and the licence notice into `out_dir`. Returns their
    paths."""
    import io

    from fontTools.ttLib import TTFont

    from ..utils import text

    with open(library, "rb") as f:
        ttf = gzip_member(f.read(), MEMBER)
    font = TTFont(io.BytesIO(ttf))
    norm = normalized_wght(font, text.WGHT)
    location = {"wght": norm}
    glyphs = {chr(o): glyph_entry(font, chr(o), location)
              for o in range(FIRST, LAST + 1)}
    head = {"source": f"{MEMBER.decode()}, a gzip member of cv2 5.0's "
                      "shared library",
            "family": name_record(font, 1),
            "version": name_record(font, 5),
            "ttf_bytes": len(ttf),
            "wght": text.WGHT, "wght_normalized": norm,
            "units_per_em": font["head"].unitsPerEm,
            "ascender": font["hhea"].ascent,
            "descender": font["hhea"].descent,
            "coordinates": "floored font units after the variation"}
    lines = ["{", f'"font": {json.dumps(head, sort_keys=True)},',
             '"glyphs": {']
    for i, (ch, entry) in enumerate(glyphs.items()):
        sep = "," if i < len(glyphs) - 1 else ""
        lines.append(f"{json.dumps(ch)}: "
                     f"{json.dumps(entry, sort_keys=True)}{sep}")
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
    return table, notice


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=DEFAULT_OUT,
                   help="directory of the table and the licence notice")
    p.add_argument("--library", default=None,
                   help="cv2's shared library (default: the installed one)")
    args = p.parse_args(argv)
    paths = write_table(args.out, args.library or cv2_library())
    for path in paths:
        print(path)
    return paths


if __name__ == "__main__":
    main()
