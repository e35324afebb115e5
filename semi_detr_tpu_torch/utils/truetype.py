"""A TrueType reader for a static font, as stb_truetype reads one.

`utils/text.py` draws a character that Rubik lacks from cv2's fallback
font, WenQuanYi Micro Hei, which the port carries as cv2's own gzip
member (`fonts/WenQuanYiMicroHei.ttf.gz`). This module parses that file at
run time: `head`, `hhea`, `maxp`, `hmtx`, `loca` (both formats), `cmap`
(formats 4 and 12; the subtable stb_truetype picks: the last encoding
record that is Unicode, or Microsoft Unicode BMP / full) and `glyf`.

A glyph's outline is built as `stbtt_GetGlyphShape` builds it, so the
rasteriser of `utils/text.py` sees stb's vertices:

* a simple glyph walks its points once, starting a contour where the
  point index reaches the next contour end plus one (a contour that starts
  off the curve starts at the midpoint `(a + b) >> 1` of its first two
  points, or at the second point when that one is on the curve; two
  off-curve points in a row put an on-curve point at their midpoint);
* a composite glyph appends each component's vertices transformed as stb
  transforms them: the 2.14 matrix entries are `v / 16384.0f`, the offsets
  the word or byte arguments (ARGS_ARE_XY_VALUES; point matching is not
  supported, as in stb), and every coordinate becomes
  `(int16)(m * (a * x + c * y + e))`, with `m` (`n` for y) the float32
  length `sqrt(a * a + b * b)` of the matrix column: stb scales a scaled
  component twice, and the tests hold that to cv2's pixels;
* hinting (`fpgm`, `prep`, glyph instructions) is not run.

Only what the renders need is read, and a truncated or damaged file raises
`GlyphTableError`, naming the file.
"""
from __future__ import annotations

import gzip
import math
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

# a vertex of stb's shape: ("m" | "l" | "q", x, y, cx, cy)
Vertex = Tuple[str, int, int, int, int]

_F = np.float32
_MAX_DEPTH = 8


class GlyphTableError(RuntimeError):
    """A glyph table or font file is missing or damaged."""


def _int16(v: int) -> int:
    v &= 0xFFFF
    return v - 0x10000 if v & 0x8000 else v


def _c_int16(v) -> int:
    """C's `(short)(float)`: toward zero, then the low 16 bits."""
    return _int16(int(v))


class Font:
    """A static TrueType font: metrics, cmap and stb's glyph shapes."""

    def __init__(self, data: bytes, name: str = "<font>"):
        self.name = name
        self.data = data
        try:
            self._parse()
        except (struct.error, IndexError, ValueError, KeyError) as e:
            raise GlyphTableError(f"font {name} is damaged: {e}") from e

    # ------------------------------------------------------------- tables

    def _u16(self, off: int) -> int:
        return struct.unpack_from(">H", self.data, off)[0]

    def _i16(self, off: int) -> int:
        return struct.unpack_from(">h", self.data, off)[0]

    def _u32(self, off: int) -> int:
        return struct.unpack_from(">I", self.data, off)[0]

    def _parse(self):
        d = self.data
        if len(d) < 12 or d[:4] not in (b"\x00\x01\x00\x00", b"true"):
            raise ValueError("not a TrueType font")
        tables: Dict[bytes, Tuple[int, int]] = {}
        for i in range(self._u16(4)):
            rec = 12 + 16 * i
            tag = bytes(d[rec:rec + 4])
            off, length = self._u32(rec + 8), self._u32(rec + 12)
            if off + length > len(d):
                raise ValueError(f"table {tag!r} runs past the end")
            tables[tag] = (off, length)
        for tag in (b"head", b"hhea", b"maxp", b"hmtx", b"loca", b"cmap",
                    b"glyf"):
            if tag not in tables:
                raise ValueError(f"no {tag.decode()} table")
        head = tables[b"head"][0]
        self.units_per_em = self._u16(head + 18)
        self.loca_format = self._i16(head + 50)
        hhea = tables[b"hhea"][0]
        self.ascent = self._i16(hhea + 4)
        self.descent = self._i16(hhea + 6)
        self.n_hmetrics = self._u16(hhea + 34)
        self.num_glyphs = self._u16(tables[b"maxp"][0] + 4)
        self.hmtx = tables[b"hmtx"][0]
        self.glyf, glyf_len = tables[b"glyf"]
        loca, loca_len = tables[b"loca"]
        n = self.num_glyphs + 1
        if self.loca_format == 0:
            if loca_len < 2 * n:
                raise ValueError("loca is cut short")
            self.loca = [2 * v for v in struct.unpack_from(
                f">{n}H", d, loca)]
        else:
            if loca_len < 4 * n:
                raise ValueError("loca is cut short")
            self.loca = list(struct.unpack_from(f">{n}I", d, loca))
        if self.loca[-1] > glyf_len:
            raise ValueError("glyf is cut short")
        if self.n_hmetrics == 0 or \
                tables[b"hmtx"][1] < 4 * self.n_hmetrics:
            raise ValueError("hmtx is cut short")
        self.cmap = self._parse_cmap(tables[b"cmap"][0])

    def _parse_cmap(self, cmap: int) -> Dict[int, int]:
        """{code point: glyph index != 0} of the subtable stb picks."""
        index_map = None
        for i in range(self._u16(cmap + 2)):
            rec = cmap + 4 + 8 * i
            platform, encoding = self._u16(rec), self._u16(rec + 2)
            if platform == 0 or (platform == 3 and encoding in (1, 10)):
                index_map = cmap + self._u32(rec + 4)
        if index_map is None:
            raise ValueError("no Unicode cmap")
        fmt = self._u16(index_map)
        out: Dict[int, int] = {}
        if fmt == 4:
            segs = self._u16(index_map + 6) >> 1
            ends = index_map + 14
            starts = ends + 2 * segs + 2
            deltas = starts + 2 * segs
            ranges = deltas + 2 * segs
            for k in range(segs):
                end, start = self._u16(ends + 2 * k), self._u16(starts + 2 * k)
                delta = self._i16(deltas + 2 * k)
                ro = self._u16(ranges + 2 * k)
                for c in range(start, end + 1):
                    if ro == 0:
                        g = (c + delta) & 0xFFFF
                    else:
                        g = self._u16(ranges + 2 * k + ro + 2 * (c - start))
                    if g:
                        out[c] = g
        elif fmt in (12, 13):
            for k in range(self._u32(index_map + 12)):
                rec = index_map + 16 + 12 * k
                start, end, g0 = (self._u32(rec), self._u32(rec + 4),
                                  self._u32(rec + 8))
                if end - start > 0x10FFFF:
                    raise ValueError("cmap group out of range")
                for c in range(start, end + 1):
                    g = g0 + c - start if fmt == 12 else g0
                    if g:
                        out[c] = g
        else:
            raise ValueError(f"cmap format {fmt} is not read")
        if out and max(out.values()) >= self.num_glyphs:
            raise ValueError("cmap names a glyph past maxp's count")
        return out

    # ------------------------------------------------------------- glyphs

    def glyph_index(self, code: int) -> int:
        """The glyph of a code point, 0 where the font has none."""
        return self.cmap.get(code, 0)

    def advance(self, glyph: int) -> int:
        """The advance width in font units (hmtx)."""
        k = min(glyph, self.n_hmetrics - 1)
        return self._u16(self.hmtx + 4 * k)

    def _glyph_offset(self, glyph: int) -> Optional[int]:
        if not 0 <= glyph < self.num_glyphs:
            raise ValueError(f"glyph {glyph} out of range")
        a, b = self.loca[glyph], self.loca[glyph + 1]
        if b < a:
            raise ValueError(f"loca of glyph {glyph} runs backwards")
        return None if a == b else self.glyf + a

    def box(self, glyph: int) -> Optional[Tuple[int, int, int, int]]:
        """stbtt_GetGlyphBox: (x0, y0, x1, y1) from the glyph header, or
        None for a glyph without data."""
        g = self._glyph_offset(glyph)
        if g is None:
            return None
        return (self._i16(g + 2), self._i16(g + 4), self._i16(g + 6),
                self._i16(g + 8))

    def shape(self, glyph: int) -> List[Vertex]:
        """stbtt_GetGlyphShape: the glyph's vertices."""
        try:
            return self._shape(glyph, 0)
        except (struct.error, IndexError, ValueError) as e:
            raise GlyphTableError(
                f"font {self.name}: glyph {glyph} is damaged: {e}") from e

    def _shape(self, glyph: int, depth: int) -> List[Vertex]:
        g = self._glyph_offset(glyph)
        if g is None:
            return []
        contours = self._i16(g)
        if contours > 0:
            return self._simple(g, contours)
        if contours == 0:
            return []
        if depth >= _MAX_DEPTH:
            raise ValueError("components nest too deep")
        return self._composite(g + 10, depth)

    def _simple(self, g: int, contours: int) -> List[Vertex]:
        d = self.data
        ends = struct.unpack_from(f">{contours}H", d, g + 10)
        n = ends[-1] + 1
        p = g + 10 + 2 * contours
        p += 2 + self._u16(p)                       # instructions
        flags = []
        while len(flags) < n:
            f = d[p]
            p += 1
            repeat = 0
            if f & 8:
                repeat = d[p]
                p += 1
            flags += [f] * (1 + repeat)
        flags = flags[:n]
        xs = []
        x = 0
        for f in flags:
            if f & 2:
                dx = d[p]
                p += 1
                x += dx if f & 16 else -dx
            elif not f & 16:
                x += self._i16(p)
                p += 2
            xs.append(_int16(x))
        ys = []
        y = 0
        for f in flags:
            if f & 4:
                dy = d[p]
                p += 1
                y += dy if f & 32 else -dy
            elif not f & 32:
                y += self._i16(p)
                p += 2
            ys.append(_int16(y))
        if p > len(d):
            raise ValueError("glyph data runs past the end")
        return points_shape(list(zip(xs, ys)), [bool(f & 1) for f in flags],
                            list(ends))

    def _composite(self, p: int, depth: int) -> List[Vertex]:
        d = self.data
        out: List[Vertex] = []
        more = True
        while more:
            flags, gidx = self._u16(p), self._u16(p + 2)
            p += 4
            if not flags & 2:
                raise ValueError("component placed by matching points, "
                                 "which stb does not read")
            if flags & 1:
                e, f = _F(self._i16(p)), _F(self._i16(p + 2))
                p += 4
            else:
                e, f = _F(_int8(d[p])), _F(_int8(d[p + 1]))
                p += 2
            a, b, c, dd = _F(1), _F(0), _F(0), _F(1)
            if flags & 8:
                a = dd = _F(self._i16(p)) / _F(16384)
                p += 2
            elif flags & 64:
                a = _F(self._i16(p)) / _F(16384)
                dd = _F(self._i16(p + 2)) / _F(16384)
                p += 4
            elif flags & 128:
                a, b, c, dd = (_F(self._i16(p + 2 * k)) / _F(16384)
                               for k in range(4))
                p += 8
            m = _F(math.sqrt(float(a * a + b * b)))
            n = _F(math.sqrt(float(c * c + dd * dd)))
            for kind, x, y, cx, cy in self._shape(gidx, depth + 1):
                fx, fy, fcx, fcy = _F(x), _F(y), _F(cx), _F(cy)
                out.append((kind,
                            _c_int16(m * (a * fx + c * fy + e)),
                            _c_int16(n * (b * fx + dd * fy + f)),
                            _c_int16(m * (a * fcx + c * fcy + e)),
                            _c_int16(n * (b * fcx + dd * fcy + f))))
            more = bool(flags & 32)
        return out


def _int8(v: int) -> int:
    return v - 256 if v & 0x80 else v


def points_shape(pts, on, ends) -> List[Vertex]:
    """stb_truetype's vertices of a simple glyph from its integer points,
    on-curve flags and contour ends, walked as `stbtt__GetGlyphShapeTT`
    walks them."""
    n = len(pts)
    out: List[Vertex] = []
    sx = sy = cx = cy = scx = scy = 0
    was_off = start_off = False
    next_move = 0
    j = 0
    i = 0

    def close():
        if start_off:
            if was_off:
                out.append(("q", (cx + scx) >> 1, (cy + scy) >> 1, cx, cy))
            out.append(("q", sx, sy, scx, scy))
        else:
            out.append(("q", sx, sy, cx, cy) if was_off
                       else ("l", sx, sy, 0, 0))

    while i < n:
        x, y = pts[i]
        if next_move == i:
            if i != 0:
                close()
            start_off = not on[i]
            if start_off:
                scx, scy = x, y
                # stb reads point i + 1 even past a one-point contour
                nx, ny = pts[i + 1] if i + 1 < n else (0, 0)
                if i + 1 < n and not on[i + 1]:
                    sx, sy = (x + nx) >> 1, (y + ny) >> 1
                else:
                    sx, sy = nx, ny
                    i += 1
            else:
                sx, sy = x, y
            out.append(("m", sx, sy, 0, 0))
            was_off = False
            next_move = 1 + ends[j] if j < len(ends) else -1
            j += 1
        elif not on[i]:
            if was_off:
                out.append(("q", (cx + x) >> 1, (cy + y) >> 1, cx, cy))
            cx, cy, was_off = x, y, True
        else:
            out.append(("q", x, y, cx, cy) if was_off
                       else ("l", x, y, 0, 0))
            was_off = False
        i += 1
    if n:
        close()
    return out


def load_gzip(path: str) -> Font:
    """The font in the gzip file `path`, parsed."""
    try:
        with gzip.open(path, "rb") as f:
            data = f.read()
    except (OSError, EOFError, zlib.error) as e:
        raise GlyphTableError(f"font {path}: {e}") from e
    return Font(data, path)
