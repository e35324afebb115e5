"""Every character cv2 5.0 draws in a label, drawn to its pixels.

`utils/text.py` draws a label as `cv2.putText(img, s, org,
FONT_HERSHEY_SIMPLEX, 0.5, colour, 1)` draws it in cv2 5.0, for any `str`:
Rubik's whole character set (its table, `fonts/rubik_wght400.json`), the
fallback font WenQuanYi Micro Hei (cv2's own gzip member, parsed by
`utils/truetype.py`), the box (Rubik's `?`, for a character neither font
maps), line breaks and the end of text. Held here against cv2 itself, bit
for bit (max abs 0):

* every code point of Rubik's cmap drawn alone, by Unicode block;
* a seeded sample of the fallback font's code points (up to SAMPLE per
  Unicode block, composite glyphs among them) drawn alone, by block;
* 200 seeded labels mixing every route with combining marks, Hebrew,
  `\\t`, `\\r`, `\\n` and `\\0`, of random colour over random backgrounds,
  clipped at every edge; `text_box` bounds their ink;
* a lone surrogate raises (cv2 crashes the process on one); a damaged
  font file raises `GlyphTableError`, naming it.

The `slow` sweep holds all 34,600 code points of the fallback font, and
draws every code point neither font maps (U+0000-U+10FFFF, surrogates
skipped) as cv2's box:

    python -m pytest tests/test_torch_text_fallback.py -m slow -q
"""
import gzip

import cv2
import numpy as np
import pytest

from semi_detr_tpu_torch.utils import text, truetype

WHITE = (255, 255, 255)
SAMPLE = 128
# the Unicode blocks the two fonts map (Unicode 15.0 ranges)
BLOCKS = (
    (0x0000, 0x007F, "Basic Latin"), (0x0080, 0x00FF, "Latin-1 Supplement"),
    (0x0100, 0x017F, "Latin Extended-A"),
    (0x0180, 0x024F, "Latin Extended-B"), (0x0250, 0x02AF, "IPA Extensions"),
    (0x02B0, 0x02FF, "Spacing Modifier Letters"),
    (0x0300, 0x036F, "Combining Diacritical Marks"),
    (0x0370, 0x03FF, "Greek and Coptic"), (0x0400, 0x04FF, "Cyrillic"),
    (0x0500, 0x052F, "Cyrillic Supplement"), (0x0590, 0x05FF, "Hebrew"),
    (0x0600, 0x06FF, "Arabic"), (0x0E00, 0x0E7F, "Thai"),
    (0x1E00, 0x1EFF, "Latin Extended Additional"),
    (0x1F00, 0x1FFF, "Greek Extended"),
    (0x2000, 0x206F, "General Punctuation"),
    (0x2070, 0x209F, "Superscripts and Subscripts"),
    (0x20A0, 0x20CF, "Currency Symbols"),
    (0x2100, 0x214F, "Letterlike Symbols"), (0x2150, 0x218F, "Number Forms"),
    (0x2190, 0x21FF, "Arrows"), (0x2200, 0x22FF, "Mathematical Operators"),
    (0x2300, 0x23FF, "Miscellaneous Technical"),
    (0x2460, 0x24FF, "Enclosed Alphanumerics"),
    (0x2500, 0x257F, "Box Drawing"), (0x2580, 0x259F, "Block Elements"),
    (0x25A0, 0x25FF, "Geometric Shapes"),
    (0x2600, 0x26FF, "Miscellaneous Symbols"), (0x2700, 0x27BF, "Dingbats"),
    (0x3000, 0x303F, "CJK Symbols and Punctuation"),
    (0x3040, 0x309F, "Hiragana"), (0x30A0, 0x30FF, "Katakana"),
    (0x3100, 0x312F, "Bopomofo"),
    (0x3130, 0x318F, "Hangul Compatibility Jamo"),
    (0x3200, 0x32FF, "Enclosed CJK Letters and Months"),
    (0x3300, 0x33FF, "CJK Compatibility"),
    (0x3400, 0x4DBF, "CJK Unified Ideographs Extension A"),
    (0x4E00, 0x9FFF, "CJK Unified Ideographs"),
    (0xAC00, 0xD7AF, "Hangul Syllables"),
    (0xF900, 0xFAFF, "CJK Compatibility Ideographs"),
    (0xFB00, 0xFB4F, "Alphabetic Presentation Forms"),
    (0xFB50, 0xFDFF, "Arabic Presentation Forms-A"),
    (0xFE30, 0xFE4F, "CJK Compatibility Forms"),
    (0xFE50, 0xFE6F, "Small Form Variants"),
    (0xFE70, 0xFEFF, "Arabic Presentation Forms-B"),
    (0xFF00, 0xFFEF, "Halfwidth and Fullwidth Forms"),
    (0xFFF0, 0xFFFF, "Specials"), (0x10400, 0x1044F, "Deseret"),
    (0x1D300, 0x1D35F, "Tai Xuan Jing Symbols"))
BLOCK_NAMES = tuple(b[2] for b in BLOCKS)
# the characters the mixed labels draw from: every route, marks, line
# breaks, the end of text and the characters that draw nothing
POOL = ("abcXYZ019:._-" "éüßñçÅøÆ" "ąčęłőřşžĞİ" "ЖжЁёДдЯяЩщ" "שלוםאבג"
        "̧́̈" "猫狗人中文字" "あいうアイウ" "한국어고양이"
        "ＡＢ１２！" "😀ᚠ\U0001F431" "\t\r\n\n\0  　﻿​ ")


def block_of(code):
    for lo, hi, name in BLOCKS:
        if lo <= code <= hi:
            return name
    return None


def cv2_label(img, s, org, color=WHITE):
    return cv2.putText(img.copy(), s, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                       color, 1)


def hold_alone(codes):
    """Each code point drawn alone on black, port against cv2: the misses."""
    img = np.zeros((50, 70, 3), np.uint8)
    miss = []
    for code in codes:
        ch = chr(code)
        if not np.array_equal(text.put_text(img.copy(), ch, (20, 30), WHITE),
                              cv2_label(img, ch, (20, 30))):
            miss.append(f"U+{code:04X}")
    return miss


def rubik_codes(block):
    return [ord(c) for c in text.table()["cmap"]
            if block_of(ord(c)) == block]


def fallback_codes(block):
    """The fallback font's code points of `block` that Rubik lacks (those
    are the ones it draws), a seeded sample of at most SAMPLE."""
    codes = sorted(c for c in text.fallback().cmap
                   if block_of(c) == block
                   and chr(c) not in text.table()["cmap"])
    if len(codes) > SAMPLE:
        rng = np.random.default_rng(BLOCK_NAMES.index(block))
        codes = sorted(int(c) for c in rng.choice(codes, SAMPLE,
                                                  replace=False))
    return codes


def test_the_blocks_cover_both_fonts():
    codes = set(text.fallback().cmap) | {ord(c) for c in text.table()["cmap"]}
    assert all(block_of(c) for c in codes)
    assert len(text.fallback().cmap) == 34600
    assert len(text.table()["cmap"]) == 885


RUBIK_BLOCKS = tuple(sorted({block_of(ord(c)) for c in text.table()["cmap"]},
                            key=BLOCK_NAMES.index))


@pytest.mark.parametrize("block", RUBIK_BLOCKS)
def test_every_rubik_code_point_is_cv2s(block):
    codes = rubik_codes(block)
    assert codes and all(text.route(chr(c)) == "rubik" for c in codes)
    assert hold_alone(codes) == []


FALLBACK_BLOCKS = ("Basic Latin", "Latin Extended-A",
                   "Latin Extended-B", "Spacing Modifier Letters",
                   "Combining Diacritical Marks", "Greek and Coptic",
                   "Cyrillic", "Cyrillic Supplement", "Thai",
                   "Latin Extended Additional", "Greek Extended",
                   "General Punctuation", "Superscripts and Subscripts",
                   "Currency Symbols", "Letterlike Symbols", "Number Forms",
                   "Arrows", "Mathematical Operators",
                   "Miscellaneous Technical", "Enclosed Alphanumerics",
                   "Box Drawing", "Block Elements", "Geometric Shapes",
                   "Miscellaneous Symbols", "Dingbats",
                   "CJK Symbols and Punctuation", "Hiragana", "Katakana",
                   "Bopomofo", "Hangul Compatibility Jamo",
                   "Enclosed CJK Letters and Months", "CJK Compatibility",
                   "CJK Unified Ideographs Extension A",
                   "CJK Unified Ideographs", "Hangul Syllables",
                   "CJK Compatibility Ideographs",
                   "Alphabetic Presentation Forms", "CJK Compatibility Forms",
                   "Small Form Variants", "Arabic Presentation Forms-B",
                   "Halfwidth and Fullwidth Forms", "Specials", "Deseret",
                   "Tai Xuan Jing Symbols")


def test_the_fallback_blocks_are_the_fonts():
    drawn = {block_of(c) for c in text.fallback().cmap
             if chr(c) not in text.table()["cmap"]}
    assert drawn == set(FALLBACK_BLOCKS)


@pytest.mark.parametrize("block", FALLBACK_BLOCKS)
def test_fallback_code_points_are_cv2s(block):
    codes = fallback_codes(block)
    assert codes and all(text.route(chr(c)) == "fallback" for c in codes
                         if c != 0)
    assert hold_alone(codes) == []


def test_the_sample_holds_composite_glyphs():
    wqy = text.fallback()
    composite = [c for b in ("CJK Unified Ideographs", "Hangul Syllables")
                 for c in fallback_codes(b)
                 if wqy.data[wqy.glyf + wqy.loca[wqy.glyph_index(c)]] & 0x80]
    assert len(composite) > 64


def mixed_labels(seed, n=200):
    """Seeded labels of 1-24 characters of POOL, random colour, background
    and origin, on images 5-120 pixels wide."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        w, h = int(rng.integers(5, 120)), int(rng.integers(5, 70))
        bg = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        s = "".join(POOL[int(k)] for k in rng.integers(
            0, len(POOL), int(rng.integers(1, 25))))
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        org = (int(rng.integers(-40, w + 5)), int(rng.integers(-20, h + 15)))
        yield bg, s, org, color


def test_mixed_labels_are_cv2_put_text():
    routes = set()
    for bg, s, org, color in mixed_labels(16):
        routes |= {text.route(ch) for ch in s}
        np.testing.assert_array_equal(
            text.put_text(bg.copy(), s, org, color),
            cv2_label(bg, s, org, color), err_msg=f"{s!r} at {org}")
    assert routes == set(text.ROUTES)


def test_text_box_bounds_the_ink_of_mixed_labels():
    for _, s, _, _ in mixed_labels(17, 100):
        img = np.zeros((120, 400, 3), np.uint8)
        drawn = cv2_label(img, s, (60, 40)).any(-1)
        x0, y0, x1, y1 = text.text_box(s, (60, 40))
        ys, xs = np.nonzero(drawn)
        if len(xs):
            assert x0 <= xs.min() and xs.max() < x1 and y0 <= ys.min() \
                and ys.max() < y1, s


@pytest.mark.parametrize("label,want", [
    ("a\nb", "b on the second line, 18 pixels lower"),
    ("\n\nab", "leading line breaks are ignored"),
    ("​\nb", "a zero-width character starts the text"),
    ("a\0b", "the end of text"),
    ("a\tb\rc", "the box"),
    ("שלום", "code-point order"),
    ("café", "no composition")])
def test_line_breaks_and_the_end_of_text_are_cv2s(label, want):
    img = np.random.default_rng(3).integers(0, 256, (70, 90, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(text.put_text(img.copy(), label, (5, 20),
                                                (0, 255, 0)),
                                  cv2_label(img, label, (5, 20), (0, 255, 0)),
                                  err_msg=want)


def test_the_line_step_and_the_box():
    assert text.text_box("a\nb", (0, 20))[3] - text.text_box("a", (0, 20))[3] \
        == text.LINE_STEP
    for ch in ("😀", "ᚠ", "\t", "\r", "\x01", "\x7f", "\x9f"):
        assert text.route(ch) == "box"
        assert text.glyph(ch) is text.glyph(text.BOX) or all(
            np.array_equal(a, b) for a, b in zip(text.glyph(ch),
                                                 text.glyph(text.BOX)))


def test_a_lone_surrogate_raises():
    img = np.zeros((20, 60, 3), np.uint8)
    for label in ("a\ud800b", "\udfff", "ok:0.5\udc80"):
        with pytest.raises(ValueError, match="lone surrogate"):
            text.put_text(img, label, (2, 15), WHITE)
        with pytest.raises(ValueError, match="lone surrogate"):
            text.text_box(label, (2, 15))
    assert not img.any()


def test_a_damaged_fallback_font_raises(tmp_path, monkeypatch):
    with open(text.FALLBACK, "rb") as f:
        member = f.read()
    data = gzip.decompress(member)
    bodies = {"cut.ttf.gz": member[:len(member) // 2],
              "garbage.ttf.gz": gzip.compress(b"\0\1\0\0" + b"x" * 64),
              "truncated_font.ttf.gz": gzip.compress(data[:4096]),
              "missing.ttf.gz": None}
    for name, body in bodies.items():
        path = tmp_path / name
        if body is not None:
            path.write_bytes(body)
        monkeypatch.setattr(text, "FALLBACK", str(path))
        text.fallback.cache_clear()
        text.glyph.cache_clear()
        with pytest.raises(text.GlyphTableError, match=name):
            text.put_text(np.zeros((20, 20, 3), np.uint8), "猫", (1, 15),
                          WHITE)
    monkeypatch.undo()
    text.fallback.cache_clear()
    text.glyph.cache_clear()
    assert text.route("猫") == "fallback"


def test_a_truncated_font_or_a_damaged_glyph_raises():
    data = gzip.decompress(open(text.FALLBACK, "rb").read())
    font = truetype.Font(data, "wqy")
    gid = font.glyph_index(ord("猫"))
    off = font.glyf + font.loca[gid]
    with pytest.raises(truetype.GlyphTableError, match="font cut"):
        truetype.Font(data[:off + 12], "cut")
    assert font._i16(off) < 0                   # a composite glyph
    bad = bytearray(data)
    bad[off + 12:off + 14] = b"\xff\xff"        # its first component's glyph
    with pytest.raises(truetype.GlyphTableError, match="out of range"):
        truetype.Font(bytes(bad), "bad").shape(gid)


# ----------------------------------------------------------- the sweep

@pytest.mark.slow
def test_every_fallback_code_point_and_the_box_are_cv2s():
    """All 34,600 code points of the fallback font drawn alone (those Rubik
    has through Rubik), then every code point neither font maps drawn as
    cv2's box."""
    assert hold_alone(sorted(text.fallback().cmap)) == []
    mapped = set(text.fallback().cmap) | {ord(c) for c in text.table()["cmap"]}
    img = np.zeros((30, 30, 3), np.uint8)
    box = text.put_text(img.copy(), text.BOX, (5, 20), WHITE)
    miss = []
    for code in range(0x110000):
        if code in mapped or 0xD800 <= code <= 0xDFFF:
            continue
        ch = chr(code)
        want = box if ch != "\n" else img
        got = cv2_label(img, ch, (5, 20))
        if not np.array_equal(got, want) or not np.array_equal(
                text.put_text(img.copy(), ch, (5, 20), WHITE), want):
            miss.append(f"U+{code:04X}")
    assert miss == []
