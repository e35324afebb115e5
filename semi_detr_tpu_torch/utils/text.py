"""The label text of the renders: `cv2.putText(img, text, org,
FONT_HERSHEY_SIMPLEX, 0.5, colour, 1)` as cv2 5.0 draws it, for any `str`,
in numpy.

Counterpart of the `cv2.putText` calls of `semi_detr_tpu/api.py`
(`save_result`) and `semi_detr_tpu/utils/logging.py`
(`log_image_with_boxes`). cv2 5.0 draws no Hershey strokes there: it maps
the call onto its TrueType renderer (stb_truetype, extended for variable
fonts) and the fonts its binary carries. The port carries them too
(`fonts/`, written from cv2's binary by `tools/font_table.py`; licence
notices beside them), so the card's machine, which has no cv2, draws the
same pixels: Rubik as a table of outlines (`rubik_wght400.json`), and the
fallback font WenQuanYi Micro Hei as cv2's own gzip member
(`WenQuanYiMicroHei.ttf.gz`), parsed by `utils/truetype.py` on the first
character Rubik lacks (ASCII labels never load it).

How cv2 draws the call, found by probing cv2 5.0.0 on the CPU and reading
its renderer's arithmetic (every rule below reproduces cv2's pixels bit
for bit: every code point of Rubik alone, every code point of WenQuanYi
Micro Hei alone, the box, and 200 seeded labels mixing them with line
breaks, clipped at every edge):

* `cv2.putText(img, s, org, FONT_HERSHEY_SIMPLEX, 0.5, c, 1)` equals the
  TrueType call `cv2.putText(img, s, org, c, FontFace("sans"), 14, 400)`
  to the pixel: fontScale 0.5 is PIXEL_SIZE = 14 pixels, thickness 1 is
  WGHT = 400 (thickness 2 and 3 draw weight 600).
* Each character takes one route: Rubik at wght 400 where Rubik's cmap
  has it; else WenQuanYi Micro Hei where its cmap has it (the format 12
  subtable, 34,600 code points, 6 of them past the BMP); else the box,
  which is Rubik's `?` (an emoji, U+16A0, `\\t`, `\\r` and every C0 and C1
  control draw it). Rubik comes first: of its 885 code points WenQuanYi
  maps 569 too.
* The scale of a font is PIXEL_SIZE / its hhea ascender, in float32:
  14 / 935 for Rubik, 14 / 1918 for WenQuanYi Micro Hei (14 / 2048 and
  14 / (ascender - descender) miss). Rubik's outline is the font at wght
  400 in cv2's fixed-point variation arithmetic (`tools/font_table.py`
  says how); WenQuanYi's is its `glyf` outline as stb_truetype builds it,
  composite glyphs included, with no hinting.
* A glyph is rasterised by stb_truetype's v2 rasteriser in float32 (the
  curves flattened to FLATNESS pixels, coverage `int(|area| * 255 +
  0.5)`), into a bitmap that cv2 pads on every side by
  `max(ceil(w / 10), ceil(h / 10)) + 10` pixels, w and h the glyph box's
  size in pixels (the padding moves the edges' float32 rounding: without
  it 27 of 1,500 WenQuanYi glyphs miss by a level or two), and placed at
  whole pixels from `org`, the baseline's left end.
* The pen advances glyph by glyph by the advance in 26.6 fixed point,
  `rint(advance * scale * 64) >> 6` (`advance` in whole font units; Rubik's
  after the variation), with no kerning (`AV`, `To`). Characters that draw
  nothing (U+0020, U+00A0, U+3000, U+FEFF, U+200B) advance all the same.
* Each glyph is blended over the image in turn, every channel alike:
  `(dst * (255 - a) + c * a + 127) // 255` (overlapping glyphs blend
  twice).
* `\\n` starts a new line LINE_STEP pixels lower, its pen back at
  `org[0]`; a `\\n` before the first other character is ignored. `\\0` ends
  the text. There is no bidi (Hebrew draws in code-point order) and no
  composition (a combining mark is a glyph of its own).
* The text clips at every edge and never wraps.

A lone surrogate is refused with a ValueError that names it: cv2 crashes
the process there (SIGSEGV), so this is a refusal, not parity. A missing
or damaged font raises `GlyphTableError`. Nothing is substituted.
"""
from __future__ import annotations

import functools
import itertools
import json
import math
import os
from typing import List, Optional, Tuple

import numpy as np

from . import truetype
from .truetype import GlyphTableError

FONT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fonts")
TABLE = os.path.join(FONT_DIR, "rubik_wght400.json")
FALLBACK = os.path.join(FONT_DIR, "WenQuanYiMicroHei.ttf.gz")
# what fontScale 0.5 and thickness 1 of FONT_HERSHEY_SIMPLEX are in cv2 5.0
PIXEL_SIZE, WGHT = 14, 400
# stb_truetype's curve tolerance, in pixels
FLATNESS = 0.35
# the pixels between two lines' baselines at PIXEL_SIZE
LINE_STEP = 18
# what a character neither font maps draws
BOX = "?"
ROUTES = ("rubik", "fallback", "box")

_F = np.float32
_ZERO, _HALF, _ONE, _TWO, _FOUR = _F(0), _F(0.5), _F(1), _F(2), _F(4)
_F255, _F64 = _F(255), _F(64)


@functools.lru_cache(maxsize=None)
def table() -> dict:
    """Rubik's glyph table, checked: {"font": header, "cmap": {char: glyph
    name}, "glyphs": {glyph name: {"advance", and "steps" (each point's
    step from the one before), "on", "ends", or "components" ([glyph name,
    dx, dy], ...)}}}."""
    try:
        with open(TABLE, encoding="ascii") as f:
            t = json.load(f)
    except (OSError, ValueError) as e:
        raise GlyphTableError(f"glyph table {TABLE}: {e}") from e
    try:
        head, cmap, glyphs = t["font"], t["cmap"], t["glyphs"]
        if head["wght"] != WGHT or head["ascender"] <= 0:
            raise ValueError(f"header {head}")
        for ch, name in cmap.items():
            if len(ch) != 1 or name not in glyphs:
                raise ValueError(f"cmap entry {ch!r}")
        if BOX not in cmap:
            raise ValueError(f"no {BOX!r}")
        for name, g in glyphs.items():
            if not isinstance(g["advance"], int):
                raise ValueError(f"advance of {name!r}")
            if "steps" in g:
                n = len(g["steps"]) // 2
                if (len(g["steps"]) != 2 * n or len(g["on"]) != n
                        or not g["ends"] or g["ends"][-1] != n - 1
                        or set(g["on"]) - {"0", "1"}):
                    raise ValueError(f"outline of {name!r}")
            for comp, _, _ in g.get("components", ()):
                if "steps" not in glyphs.get(comp, {}):
                    raise ValueError(f"component {comp!r} of {name!r}")
    except (KeyError, TypeError, ValueError) as e:
        raise GlyphTableError(f"glyph table {TABLE} is damaged: {e}") from e
    return t


@functools.lru_cache(maxsize=None)
def fallback() -> truetype.Font:
    """WenQuanYi Micro Hei, inflated and parsed on first use."""
    return truetype.load_gzip(FALLBACK)


def _scale(ascender: int) -> np.float32:
    return _F(PIXEL_SIZE) / _F(ascender)


def route(ch: str) -> str:
    """Which font draws `ch`: "rubik", "fallback" or "box"."""
    if ch in table()["cmap"]:
        return "rubik"
    if fallback().glyph_index(ord(ch)):
        return "fallback"
    return "box"


def _rubik_outline(name: str):
    """(vertices, box) of a Rubik glyph: components laid out at their
    offsets; the box over its points."""
    g = table()["glyphs"][name]
    parts = [(g, 0, 0)] if "steps" in g else [
        (table()["glyphs"][c], dx, dy) for c, dx, dy in
        g.get("components", ())]
    verts: List[truetype.Vertex] = []
    xs: List[int] = []
    ys: List[int] = []
    for part, dx, dy in parts:
        steps = part["steps"]
        px = list(itertools.accumulate(steps[0::2], initial=dx))[1:]
        py = list(itertools.accumulate(steps[1::2], initial=dy))[1:]
        verts += truetype.points_shape(list(zip(px, py)),
                                       [c == "1" for c in part["on"]],
                                       part["ends"])
        xs += px
        ys += py
    box = (min(xs), min(ys), max(xs), max(ys)) if xs else None
    return verts, box


# ---------------------------------------------------------------------------
# vertices -> coverage: stb_truetype's FlattenCurves and v2 rasteriser, in
# float32, into cv2's padded bitmap
# ---------------------------------------------------------------------------

def _tesselate(pts, x0, y0, x1, y1, x2, y2, flat2, n):
    mx = (x0 + _TWO * x1 + x2) / _FOUR
    my = (y0 + _TWO * y1 + y2) / _FOUR
    dx = (x0 + x2) / _TWO - mx
    dy = (y0 + y2) / _TWO - my
    if n > 16:
        return
    if dx * dx + dy * dy > flat2:
        _tesselate(pts, x0, y0, (x0 + x1) / _TWO, (y0 + y1) / _TWO, mx, my,
                   flat2, n + 1)
        _tesselate(pts, mx, my, (x1 + x2) / _TWO, (y1 + y2) / _TWO, x2, y2,
                   flat2, n + 1)
    else:
        pts.append((x2, y2))


def flatten(verts, flatness) -> List[list]:
    """stbtt_FlattenCurves: polylines (float32 font units) of the vertices;
    `flatness` in font units."""
    flat2 = flatness * flatness
    polys: List[list] = []
    x = y = _ZERO
    for kind, vx, vy, cx, cy in verts:
        vx, vy = _F(vx), _F(vy)
        if kind == "m":
            polys.append([(vx, vy)])
        elif kind == "l":
            polys[-1].append((vx, vy))
        else:
            _tesselate(polys[-1], x, y, _F(cx), _F(cy), vx, vy, flat2, 0)
        x, y = vx, vy
    return polys


class _Edge:
    __slots__ = ("fx", "fdx", "fdy", "direction", "sy", "ey")


def _clipped(scan, x, e, x0, y0, x1, y1):
    """stbtt__handle_clipped_edge: the part of the edge (x0, y0)-(x1, y1)
    within e's span, into pixel x of `scan`."""
    if y0 == y1 or y0 > e.ey or y1 < e.sy:
        return
    if y0 < e.sy:
        x0 += (x1 - x0) * (e.sy - y0) / (y1 - y0)
        y0 = e.sy
    if y1 > e.ey:
        x1 += (x1 - x0) * (e.ey - y1) / (y1 - y0)
        y1 = e.ey
    fx = _F(x)
    if x0 <= fx and x1 <= fx:
        scan[x] += e.direction * (y1 - y0)
    elif x0 >= fx + _ONE and x1 >= fx + _ONE:
        pass
    else:
        scan[x] += e.direction * (y1 - y0) * (
            _ONE - ((x0 - fx) + (x1 - fx)) / _TWO)


def _fill_row(scan, fill, length, active, y_top):
    """stbtt__fill_active_edges_new: signed area of every active edge in
    the row [y_top, y_top + 1) into `scan`, and what lies right of each
    into `fill` (`fill[x + 1]`: from pixel x + 1 on)."""
    y_bottom = y_top + _ONE
    flen = _F(length)
    for e in active:
        x0 = e.fx
        if e.fdx == _ZERO:
            if x0 < flen:
                if x0 >= _ZERO:
                    _clipped(scan, int(x0), e, x0, y_top, x0, y_bottom)
                    _clipped(fill, int(x0) + 1, e, x0, y_top, x0, y_bottom)
                else:
                    _clipped(fill, 0, e, x0, y_top, x0, y_bottom)
            continue
        dx, dy = e.fdx, e.fdy
        xb = x0 + dx
        if e.sy > y_top:
            x_top, sy0 = x0 + dx * (e.sy - y_top), e.sy
        else:
            x_top, sy0 = x0, y_top
        if e.ey < y_bottom:
            x_bottom, sy1 = x0 + dx * (e.ey - y_top), e.ey
        else:
            x_bottom, sy1 = xb, y_bottom
        if _ZERO <= x_top < flen and _ZERO <= x_bottom < flen:
            if int(x_top) == int(x_bottom):
                x = int(x_top)
                height = (sy1 - sy0) * e.direction
                fx1 = _F(x) + _ONE
                scan[x] += ((fx1 - x_top) + (fx1 - x_bottom)) / _TWO * height
                fill[x + 1] += height
                continue
            if x_top > x_bottom:
                sy0, sy1 = y_bottom - (sy1 - y_top), y_bottom - (sy0 - y_top)
                x_bottom, x_top = x_top, x_bottom
                dx, dy = -dx, -dy
                x0, xb = xb, x0
            x1, x2 = int(x_top), int(x_bottom)
            y_crossing = y_top + dy * (_F(x1 + 1) - x0)
            y_final = y_top + dy * (_F(x2) - x0)
            if y_crossing > y_bottom:
                y_crossing = y_bottom
            sign = e.direction
            area = sign * (y_crossing - sy0)
            scan[x1] += area * (_F(x1 + 1) - x_top) / _TWO
            if y_final > y_bottom:
                y_final = y_bottom
                if x2 != x1 + 1:
                    dy = (y_final - y_crossing) / _F(x2 - (x1 + 1))
            step = sign * dy
            for x in range(x1 + 1, x2):
                scan[x] += area + step / _TWO
                area += step
            fx2 = _F(x2)
            scan[x2] += area + sign * (((fx2 + _ONE - fx2)
                                        + (fx2 + _ONE - x_bottom)) / _TWO
                                       * (sy1 - y_final))
            fill[x2 + 1] += sign * (sy1 - sy0)
            continue
        # the edge leaves the box: stb's brute force over every pixel
        for x in range(length):
            xa, xc = _F(x), _F(x + 1)
            y1 = (xa - x0) / dx + y_top
            y2 = (xc - x0) / dx + y_top
            if x0 < xa and xb > xc:
                parts = ((x0, y_top, xa, y1), (xa, y1, xc, y2),
                         (xc, y2, xb, y_bottom))
            elif xb < xa and x0 > xc:
                parts = ((x0, y_top, xc, y2), (xc, y2, xa, y1),
                         (xa, y1, xb, y_bottom))
            elif x0 < xa < xb or xb < xa < x0:
                parts = ((x0, y_top, xa, y1), (xa, y1, xb, y_bottom))
            elif x0 < xc < xb or xb < xc < x0:
                parts = ((x0, y_top, xc, y2), (xc, y2, xb, y_bottom))
            else:
                parts = ((x0, y_top, xb, y_bottom),)
            for p in parts:
                _clipped(scan, x, e, *p)


def _sort_edges(p):
    """stbtt__sort_edges: a median-of-three quicksort down to 12, then an
    insertion sort, on the edges' top y (p[k][1]); not stable, as stb's."""
    def quick(lo, n):
        while n > 12:
            m = n >> 1
            c01 = p[lo][1] < p[lo + m][1]
            c12 = p[lo + m][1] < p[lo + n - 1][1]
            if c01 != c12:
                c = p[lo][1] < p[lo + n - 1][1]
                z = lo if c == c12 else lo + n - 1
                p[z], p[lo + m] = p[lo + m], p[z]
            p[lo], p[lo + m] = p[lo + m], p[lo]
            i, j = 1, n - 1
            while True:
                while p[lo + i][1] < p[lo][1]:
                    i += 1
                while p[lo][1] < p[lo + j][1]:
                    j -= 1
                if i >= j:
                    break
                p[lo + i], p[lo + j] = p[lo + j], p[lo + i]
                i += 1
                j -= 1
            if j < n - i:
                quick(lo, j)
                lo, n = lo + i, n - i
            else:
                quick(lo + i, n - i)
                n = j

    quick(0, len(p))
    for i in range(1, len(p)):
        t = p[i]
        j = i
        while j > 0 and t[1] < p[j - 1][1]:
            p[j] = p[j - 1]
            j -= 1
        p[j] = t


def rasterize(polys, s, off_x, off_y, w, h, shift_x, shift_y) -> np.ndarray:
    """stbtt__rasterize (v2, inverted y): the (h, w) uint8 coverage of the
    polylines (float32 font units, y up) scaled by `s` and shifted, in the
    pixel box whose top-left is (off_x, off_y)."""
    edges = []
    ys = -s
    for pts in polys:
        j = len(pts) - 1
        for k in range(len(pts)):
            pj, pk = pts[j], pts[k]
            j = k
            if pj[1] == pk[1]:
                continue
            a, b, inv = (pj, pk, True) if pj[1] > pk[1] else (pk, pj, False)
            edges.append((a[0] * s + shift_x, a[1] * ys + shift_y,
                          b[0] * s + shift_x, b[1] * ys + shift_y, inv))
    _sort_edges(edges)
    out = np.zeros((h, w), np.uint8)
    active: List[_Edge] = []
    ei = 0
    fo_x = _F(off_x)
    for j in range(h):
        top = _F(off_y + j)
        bottom = _F(off_y + j + 1)
        active = [z for z in active if z.ey > top]
        while ei < len(edges) and edges[ei][1] <= bottom:
            x0, y0, x1, y1, inv = edges[ei]
            ei += 1
            if y0 == y1:
                continue
            z = _Edge()
            dxdy = (x1 - x0) / (y1 - y0)
            z.fdx = dxdy
            z.fdy = _ONE / dxdy if dxdy != _ZERO else _ZERO
            z.fx = (x0 + dxdy * (top - y0)) - fo_x
            z.direction = _ONE if inv else -_ONE
            z.sy, z.ey = y0, y1
            if j == 0 and off_y != 0 and z.ey < top:
                z.ey = top
            active.insert(0, z)
        if active:
            scan = np.zeros(w + 1, np.float32)
            fill = np.zeros(w + 2, np.float32)
            _fill_row(scan, fill, w, active, top)
            acc = np.add.accumulate(fill[:w], dtype=np.float32)
            k = np.abs(scan[:w] + acc) * _F255 + _HALF
            out[j] = np.minimum(k.astype(np.int64), 255)
        for z in active:
            z.fx += z.fdx
    return out


def _bitmap(verts, box, s):
    """cv2's glyph bitmap: the box in pixels padded on every side, the
    vertices rasterised into it, and the ink's tight box. Returns
    (coverage or None, left, top) relative to the pen on the baseline."""
    if not verts or box is None:
        return None, 0, 0
    x0, y0, x1, y1 = box
    ix0, iy0 = math.floor(_F(x0) * s), math.floor(-_F(y1) * s)
    ix1, iy1 = math.ceil(_F(x1) * s), math.ceil(-_F(y0) * s)
    w, h = ix1 - ix0, iy1 - iy0
    pad = max((w + 9) // 10, (h + 9) // 10) + 10
    cov = rasterize(flatten(verts, _F(FLATNESS) / s), s, ix0, iy0,
                    w + 2 * pad, h + 2 * pad, _F(pad), _F(pad))
    rows, cols = np.nonzero(cov.any(1))[0], np.nonzero(cov.any(0))[0]
    if not len(rows):
        return None, 0, 0
    r0, c0 = int(rows[0]), int(cols[0])
    cov = np.ascontiguousarray(cov[r0:int(rows[-1]) + 1, c0:int(cols[-1]) + 1])
    return cov, ix0 - pad + c0, iy0 - pad + r0


def _advance(units: int, s) -> int:
    """The pen's step in pixels: 26.6 fixed point, rounded, floored."""
    return int(np.rint(_F(units) * s * _F64)) >> 6


# ---------------------------------------------------------------------------
# glyphs and labels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def glyph(ch: str) -> Tuple[Optional[np.ndarray], int, int, int]:
    """(coverage (h, w) uint8 or None for a blank glyph, the box's left
    and top relative to the pen on the baseline, the advance in pixels) of
    one character, from the font its route names."""
    way = route(ch)
    if way == "box" and ch != BOX:
        return glyph(BOX)
    if way == "fallback":
        font = fallback()
        gid = font.glyph_index(ord(ch))
        s = _scale(font.ascent)
        cov, left, top = _bitmap(font.shape(gid), font.box(gid), s)
        advance = _advance(font.advance(gid), s)
    else:
        t = table()
        name = t["cmap"][ch]
        s = _scale(t["font"]["ascender"])
        verts, box = _rubik_outline(name)
        cov, left, top = _bitmap(verts, box, s)
        advance = _advance(t["glyphs"][name]["advance"], s)
    if cov is not None:
        cov.setflags(write=False)
    return cov, left, top, advance


def check_text(text: str) -> None:
    """Refuse a lone surrogate (a ValueError naming it and its place): cv2
    crashes the process on one, so it is not drawn."""
    for i, ch in enumerate(text):
        if "\ud800" <= ch <= "\udfff":
            raise ValueError(
                f"character {i} of the label, U+{ord(ch):04X}, is a lone "
                "surrogate, which is not text: cv2 5.0's putText crashes "
                "the process on it, so the port refuses to draw it")


def _layout(text: str, org: Tuple[int, int]):
    """(character, pen x, baseline y) of every glyph the text draws."""
    check_text(text)
    x0, y = int(org[0]), int(org[1])
    pen = x0
    started = False
    for ch in text:
        if ch == "\0":
            return
        if ch == "\n":
            if started:
                pen, y = x0, y + LINE_STEP
            continue
        started = True
        yield ch, pen, y
        pen += glyph(ch)[3]


def put_text(img: np.ndarray, text: str, org: Tuple[int, int],
             color) -> np.ndarray:
    """Draw `text` into the (H, W, C) uint8 `img` in place, its first
    baseline starting at `org` = (x, y), as `cv2.putText(img, text, org,
    FONT_HERSHEY_SIMPLEX, 0.5, color, 1)` draws it in cv2 5.0. Returns
    `img`."""
    h, w = img.shape[:2]
    c = np.asarray(color, np.int32)[:img.shape[2]]
    for ch, pen, y in list(_layout(text, org)):
        cov, gx, gy, _ = glyph(ch)
        if cov is None:
            continue
        x0, y0 = pen + gx, y + gy
        gh, gw = cov.shape
        xa, xb = max(x0, 0), min(x0 + gw, w)
        ya, yb = max(y0, 0), min(y0 + gh, h)
        if xa < xb and ya < yb:
            a = cov[ya - y0:yb - y0, xa - x0:xb - x0].astype(
                np.int32)[..., None]
            dst = img[ya:yb, xa:xb].astype(np.int32)
            img[ya:yb, xa:xb] = (dst * (255 - a) + c * a + 127) // 255
    return img


def text_box(text: str, org: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """(x0, y0, x1, y1), end exclusive: the pixels `put_text` may touch for
    `text` at `org`, before clipping to the image."""
    x0 = y0 = 1 << 30
    x1 = y1 = -(1 << 30)
    for ch, pen, y in _layout(text, org):
        cov, gx, gy, _ = glyph(ch)
        if cov is not None:
            x0, y0 = min(x0, pen + gx), min(y0, y + gy)
            x1 = max(x1, pen + gx + cov.shape[1])
            y1 = max(y1, y + gy + cov.shape[0])
    if x0 < x1:
        return x0, y0, x1, y1
    return int(org[0]), int(org[1]), int(org[0]), int(org[1])
