"""The label text of the renders: `cv2.putText(img, text, org,
FONT_HERSHEY_SIMPLEX, 0.5, colour, 1)` as cv2 5.0 draws it, in numpy.

Counterpart of the `cv2.putText` calls of `semi_detr_tpu/api.py`
(`save_result`) and `semi_detr_tpu/utils/logging.py`
(`log_image_with_boxes`). cv2 5.0 draws no Hershey strokes there: it maps
the call onto its TrueType renderer (the stb_truetype rasteriser, with
variable fonts) and the font Rubik that its binary carries. The glyph data
is committed (`fonts/rubik_wght400.json`, written from cv2's binary by
`tools/font_table.py`; licence notice beside it), so the card's machine,
which has no cv2, draws the same pixels.

How cv2 draws the call, found by probing cv2 5.0.0 on the CPU (every
constant below reproduces cv2's pixels bit for bit on all 94 printable
glyphs alone, and on 200 seeded labels of 1-24 printable characters of
random colour on random backgrounds, clipped at every edge of images
5-100 pixels wide):

* `cv2.putText(img, s, org, FONT_HERSHEY_SIMPLEX, 0.5, c, 1)` equals the
  TrueType call `cv2.putText(img, s, org, c, FontFace("sans"), 14, 400)`
  to the pixel: fontScale 0.5 is PIXEL_SIZE = 14 pixels, thickness 1 is
  WGHT = 400 (thickness 2 and 3 draw weight 600).
* The scale is PIXEL_SIZE / ascender (935 font units): 14 / 1000 and
  14 / (ascender - descender) miss; the fit over glyph A's coverage put
  the least error there, and with the points below every glyph is exact.
* The outline is the font at wght 400 with the location rounded to
  F2Dot14 (0.1875 after `avar`; the unrounded 0.18748 misses 260 levels
  over 57 glyphs) and each coordinate floored to a whole font unit (stb
  keeps points as int16; rounding misses 4,036 levels, truncation 392,
  flooring 0). The curves are stb's: implied on-curve points at
  `(a + b) >> 1` of the integer points, flattened by midpoint subdivision
  to FLATNESS pixels, the coverage the exact area of stb's v2 rasteriser
  with `int(|area| * 255 + 0.5)`.
* `org` is the baseline's left end; the glyph's bitmap box is placed at
  whole pixels (no sub-pixel shift: a label moved by whole pixels is the
  same picture moved).
* The pen advances by each glyph's advance in pixels floored, glyph by
  glyph (`iiiii` lands at 0, 3, 6, 9, 12; the float sum would give 10 at
  the third); no kerning (`AV`, `To`).
* Each glyph is blended over the image in turn, every channel alike:
  `(dst * (255 - a) + c * a + 127) // 255` (66,600 samples on random
  backgrounds and colours, all exact; overlapping glyphs blend twice).
* The text clips at every edge and never wraps.

The arithmetic here is float64 where stb's is float32; at this size every
glyph's coverage still equals cv2's (the tests hold all of them).

A character outside the table (cv2 draws a CJK one from its fallback font,
WenQuanYi Micro Hei) raises `NotPortedCharacter`; a missing or damaged
table raises `GlyphTableError`. Nothing is substituted.
"""
from __future__ import annotations

import functools
import json
import math
import os
from typing import Optional, Tuple

import numpy as np

FONT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fonts")
TABLE = os.path.join(FONT_DIR, "rubik_wght400.json")
# what fontScale 0.5 and thickness 1 of FONT_HERSHEY_SIMPLEX are in cv2 5.0
PIXEL_SIZE, WGHT = 14, 400
# stb_truetype's curve tolerance, in pixels
FLATNESS = 0.35


class GlyphTableError(RuntimeError):
    """The committed glyph table is missing or damaged."""


class NotPortedCharacter(ValueError):
    """A character the glyph table does not hold."""


@functools.lru_cache(maxsize=None)
def table() -> dict:
    """The glyph table, checked: {"font": header, "glyphs": {char:
    entry}}."""
    try:
        with open(TABLE, encoding="ascii") as f:
            t = json.load(f)
    except (OSError, ValueError) as e:
        raise GlyphTableError(f"glyph table {TABLE}: {e}") from e
    try:
        head, glyphs = t["font"], t["glyphs"]
        if head["wght"] != WGHT or head["ascender"] <= 0:
            raise ValueError(f"header {head}")
        for ch, g in glyphs.items():
            if not isinstance(g["advance"], (int, float)):
                raise ValueError(f"advance of {ch!r}")
            if "points" in g:
                n = len(g["points"]) // 2
                if (len(g["points"]) != 2 * n or len(g["on"]) != n
                        or not g["ends"] or g["ends"][-1] != n - 1
                        or set(g["on"]) - {"0", "1"}):
                    raise ValueError(f"outline of {ch!r}")
    except (KeyError, TypeError, ValueError) as e:
        raise GlyphTableError(f"glyph table {TABLE} is damaged: {e}") from e
    return t


def scale() -> float:
    """Pixels per font unit."""
    return PIXEL_SIZE / table()["font"]["ascender"]


# ---------------------------------------------------------------------------
# outline -> coverage: stb_truetype's GetGlyphShape, FlattenCurves and v2
# rasteriser
# ---------------------------------------------------------------------------

def shape(points, on, ends):
    """The contours stb_truetype builds from a glyph's integer points:
    per contour a list of ("m" | "l" | "q", x, y, cx, cy), implied on-curve
    points at `(a + b) >> 1`, each contour closed back to its start."""
    out = []
    start = 0
    for end in ends:
        pts = points[start:end + 1]
        flags = on[start:end + 1]
        start = end + 1
        verts = []
        i = 0
        if flags[0]:
            sx, sy = pts[0]
            scx = scy = None
        else:
            scx, scy = pts[0]
            if len(pts) > 1 and not flags[1]:
                sx, sy = (scx + pts[1][0]) >> 1, (scy + pts[1][1]) >> 1
            else:
                sx, sy = pts[1]
                i = 1
        verts.append(("m", sx, sy, 0, 0))
        was_off, cx, cy = False, 0, 0
        for k in range(i + 1, len(pts)):
            x, y = pts[k]
            if not flags[k]:
                if was_off:
                    verts.append(("q", (cx + x) >> 1, (cy + y) >> 1, cx, cy))
                cx, cy, was_off = x, y, True
            else:
                verts.append(("q", x, y, cx, cy) if was_off
                             else ("l", x, y, 0, 0))
                was_off = False
        if scx is not None:
            if was_off:
                verts.append(("q", (cx + scx) >> 1, (cy + scy) >> 1, cx, cy))
            verts.append(("q", sx, sy, scx, scy))
        else:
            verts.append(("q", sx, sy, cx, cy) if was_off
                         else ("l", sx, sy, 0, 0))
        out.append(verts)
    return out


def _subdivide(pts, x0, y0, x1, y1, x2, y2, flat2, n):
    mx = (x0 + 2 * x1 + x2) / 4
    my = (y0 + 2 * y1 + y2) / 4
    dx = (x0 + x2) / 2 - mx
    dy = (y0 + y2) / 2 - my
    if n > 16:
        return
    if dx * dx + dy * dy > flat2:
        _subdivide(pts, x0, y0, (x0 + x1) / 2, (y0 + y1) / 2, mx, my, flat2,
                   n + 1)
        _subdivide(pts, mx, my, (x1 + x2) / 2, (y1 + y2) / 2, x2, y2, flat2,
                   n + 1)
    else:
        pts.append((x2, y2))


def flatten(contours, flatness):
    """Polylines in font units; `flatness` in font units."""
    flat2 = flatness * flatness
    polys = []
    for verts in contours:
        pts = []
        x = y = 0
        for kind, vx, vy, cx, cy in verts:
            if kind == "m":
                pts = [(vx, vy)]
            elif kind == "l":
                pts.append((vx, vy))
            else:
                _subdivide(pts, x, y, cx, cy, vx, vy, flat2, 0)
            x, y = vx, vy
        polys.append(pts)
    return polys


class _Edge:
    __slots__ = ("fx", "fdx", "fdy", "direction", "sy", "ey")


def _clipped(scan, x, e, x0, y0, x1, y1):
    """stbtt__handle_clipped_edge: the part of the edge (x0, y0)-(x1, y1)
    within e's span, into pixel x."""
    if y0 == y1 or y0 > e.ey or y1 < e.sy:
        return
    if y0 < e.sy:
        x0 += (x1 - x0) * (e.sy - y0) / (y1 - y0)
        y0 = e.sy
    if y1 > e.ey:
        x1 += (x1 - x0) * (e.ey - y1) / (y1 - y0)
        y1 = e.ey
    if x0 <= x and x1 <= x:
        scan[x] += e.direction * (y1 - y0)
    elif x0 >= x + 1 and x1 >= x + 1:
        pass
    else:
        scan[x] += e.direction * (y1 - y0) * (1 - ((x0 - x) + (x1 - x)) / 2)


def _fill_row(scan, fill, length, active, y_top):
    """stbtt__fill_active_edges_new: signed area of every active edge in
    the row [y_top, y_top + 1) into `scan`, and what lies right of each
    into `fill` (`fill[x + 1]`: from pixel x + 1 on)."""
    y_bottom = y_top + 1
    for e in active:
        if e.fdx == 0:
            x0 = e.fx
            if x0 < length:
                if x0 >= 0:
                    _clipped(scan, int(x0), e, x0, y_top, x0, y_bottom)
                    _clipped(fill, int(x0) + 1, e, x0, y_top, x0, y_bottom)
                else:
                    _clipped(fill, 0, e, x0, y_top, x0, y_bottom)
            continue
        x0, dx, dy = e.fx, e.fdx, e.fdy
        xb = x0 + dx
        if e.sy > y_top:
            x_top, sy0 = x0 + dx * (e.sy - y_top), e.sy
        else:
            x_top, sy0 = x0, y_top
        if e.ey < y_bottom:
            x_bottom, sy1 = x0 + dx * (e.ey - y_top), e.ey
        else:
            x_bottom, sy1 = xb, y_bottom
        if 0 <= x_top < length and 0 <= x_bottom < length:
            if int(x_top) == int(x_bottom):
                x = int(x_top)
                height = (sy1 - sy0) * e.direction
                scan[x] += ((x + 1.0 - x_top) + (x + 1.0 - x_bottom)) / 2 \
                    * height
                fill[x + 1] += height
                continue
            if x_top > x_bottom:
                sy0, sy1 = y_bottom - (sy1 - y_top), y_bottom - (sy0 - y_top)
                x_bottom, x_top = x_top, x_bottom
                dx, dy = -dx, -dy
                x0, xb = xb, x0
            x1, x2 = int(x_top), int(x_bottom)
            y_crossing = min(y_top + dy * (x1 + 1 - x0), y_bottom)
            y_final = y_top + dy * (x2 - x0)
            sign = e.direction
            area = sign * (y_crossing - sy0)
            scan[x1] += area * (x1 + 1 - x_top) / 2
            if y_final > y_bottom:
                denom = x2 - (x1 + 1)
                y_final = y_bottom
                if denom != 0:
                    dy = (y_final - y_crossing) / denom
            step = sign * dy
            for x in range(x1 + 1, x2):
                scan[x] += area + step / 2
                area += step
            scan[x2] += area + sign * ((1.0 + (x2 + 1.0 - x_bottom)) / 2
                                       * (sy1 - y_final))
            fill[x2 + 1] += sign * (sy1 - sy0)
            continue
        # the edge leaves the box: stb's brute force over every pixel
        for x in range(length):
            y0 = y_top
            xa, xc = float(x), float(x + 1)
            y1 = (x - x0) / dx + y_top
            y2 = (x + 1 - x0) / dx + y_top
            if x0 < xa and xb > xc:
                parts = ((x0, y0, xa, y1), (xa, y1, xc, y2),
                         (xc, y2, xb, y_bottom))
            elif xb < xa and x0 > xc:
                parts = ((x0, y0, xc, y2), (xc, y2, xa, y1),
                         (xa, y1, xb, y_bottom))
            elif x0 < xa < xb or xb < xa < x0:
                parts = ((x0, y0, xa, y1), (xa, y1, xb, y_bottom))
            elif x0 < xc < xb or xb < xc < x0:
                parts = ((x0, y0, xc, y2), (xc, y2, xb, y_bottom))
            else:
                parts = ((x0, y0, xb, y_bottom),)
            for p in parts:
                _clipped(scan, x, e, *p)


def rasterize(polys, s, off_x, off_y, w, h) -> np.ndarray:
    """stbtt__rasterize (v2, invert): the (h, w) uint8 coverage of the
    polylines (font units, y up) scaled by `s`, y flipped, in the pixel box
    whose top-left is (off_x, off_y)."""
    edges = []
    for pts in polys:
        j = len(pts) - 1
        for k in range(len(pts)):
            pj, pk = pts[j], pts[k]
            j = k
            if pj[1] == pk[1]:
                continue
            a, b, inv = (pj, pk, True) if pj[1] > pk[1] else (pk, pj, False)
            edges.append((-a[1] * s, a[0] * s, b[0] * s, -b[1] * s, inv))
    edges.sort(key=lambda e: e[0])
    out = np.zeros((h, w), np.uint8)
    active = []
    ei = 0
    for j in range(h):
        top = float(off_y + j)
        scan = [0.0] * (w + 1)
        fill = [0.0] * (w + 2)
        active = [z for z in active if z.ey > top]
        while ei < len(edges) and edges[ei][0] <= top + 1:
            y0, x0, x1, y1, inv = edges[ei]
            ei += 1
            if y0 == y1:
                continue
            z = _Edge()
            dxdy = (x1 - x0) / (y1 - y0)
            z.fdx = dxdy
            z.fdy = 1.0 / dxdy if dxdy != 0 else 0.0
            z.fx = x0 + dxdy * (top - y0) - off_x
            z.direction = 1.0 if inv else -1.0
            z.sy, z.ey = y0, y1
            if j == 0 and off_y != 0 and z.ey < top:
                z.ey = top
            active.insert(0, z)
        _fill_row(scan, fill, w, active, top)
        acc = 0.0
        for i in range(w):
            acc += fill[i]
            out[j, i] = min(int(abs(scan[i] + acc) * 255 + 0.5), 255)
        for z in active:
            z.fx += z.fdx
    return out


# ---------------------------------------------------------------------------
# glyphs and labels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def glyph(ch: str) -> Tuple[Optional[np.ndarray], int, int, int]:
    """(coverage (h, w) uint8 or None for a blank glyph, the box's left
    and top relative to the pen on the baseline, the advance in pixels) of
    one character."""
    g = table()["glyphs"].get(ch)
    if g is None:
        raise NotPortedCharacter(
            f"character {ch!r} (U+{ord(ch):04X}) is not ported: cv2 5.0 "
            "draws it from a font the port's glyph table does not hold "
            "(the printable ASCII of Rubik; a CJK character would come "
            "from cv2's fallback font, WenQuanYi Micro Hei)")
    s = scale()
    advance = math.floor(g["advance"] * s)
    if "points" not in g:
        return None, 0, 0, advance
    flat = g["points"]
    pts = list(zip(flat[0::2], flat[1::2]))
    xs, ys = flat[0::2], flat[1::2]
    ix0, ix1 = math.floor(min(xs) * s), math.ceil(max(xs) * s)
    iy0, iy1 = math.floor(-max(ys) * s), math.ceil(-min(ys) * s)
    polys = flatten(shape(pts, [c == "1" for c in g["on"]], g["ends"]),
                    FLATNESS / s)
    cov = rasterize(polys, s, ix0, iy0, ix1 - ix0, iy1 - iy0)
    cov.setflags(write=False)
    return cov, ix0, iy0, advance


def check_text(text: str) -> None:
    """Raise `NotPortedCharacter` for the first character of `text` the
    table does not hold."""
    glyphs = table()["glyphs"]
    for ch in text:
        if ch not in glyphs:
            glyph(ch)


def put_text(img: np.ndarray, text: str, org: Tuple[int, int],
             color) -> np.ndarray:
    """Draw `text` into the (H, W, C) uint8 `img` in place, its baseline
    starting at `org` = (x, y), as `cv2.putText(img, text, org,
    FONT_HERSHEY_SIMPLEX, 0.5, color, 1)` draws it in cv2 5.0. Returns
    `img`."""
    check_text(text)
    h, w = img.shape[:2]
    c = np.asarray(color, np.int32)[:img.shape[2]]
    pen = int(org[0])
    y = int(org[1])
    for ch in text:
        cov, gx, gy, advance = glyph(ch)
        if cov is not None:
            x0, y0 = pen + gx, y + gy
            gh, gw = cov.shape
            xa, xb = max(x0, 0), min(x0 + gw, w)
            ya, yb = max(y0, 0), min(y0 + gh, h)
            if xa < xb and ya < yb:
                a = cov[ya - y0:yb - y0, xa - x0:xb - x0].astype(
                    np.int32)[..., None]
                dst = img[ya:yb, xa:xb].astype(np.int32)
                img[ya:yb, xa:xb] = (dst * (255 - a) + c * a + 127) // 255
        pen += advance
    return img


def text_box(text: str, org: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """(x0, y0, x1, y1), end exclusive: the pixels `put_text` may touch for
    `text` at `org`, before clipping to the image."""
    check_text(text)
    pen, y = int(org[0]), int(org[1])
    x0 = y0 = 1 << 30
    x1 = y1 = -(1 << 30)
    for ch in text:
        cov, gx, gy, advance = glyph(ch)
        if cov is not None:
            x0, y0 = min(x0, pen + gx), min(y0, y + gy)
            x1 = max(x1, pen + gx + cov.shape[1])
            y1 = max(y1, y + gy + cov.shape[0])
        pen += advance
    return (x0, y0, x1, y1) if x0 < x1 else (pen, y, pen, y)

