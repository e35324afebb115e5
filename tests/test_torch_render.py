"""The render: every picture the JAX package draws, drawn to its pixels.

The JAX package draws with cv2 5.0: `cv2.rectangle(..., (0, 255, 0), 2)`
and `cv2.putText(f"{name}:{score:.2f}", (x0, max(y0 - 4, 0)),
FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)` in `api.save_result` and in
`utils.logging.log_image_with_boxes`. The port draws in numpy:
`utils.logging.draw_rect` (cv2.rectangle's rule) and `utils.text` (cv2
5.0's TrueType render of that call, from the committed fonts). Held
here, bit for bit:

* `draw_rect` against `cv2.rectangle` on 600 seeded boxes per thickness
  (off-image, degenerate and swapped ones among them);
* every printable glyph alone, and 200 seeded labels of random text,
  colour, background and position, against `cv2.putText` (the other
  characters, the fallback font and the box: `test_torch_text_fallback.py`);
* the port's `save_result` against the JAX one on the committed render
  cases (all 80 COCO names, scores 0.00-1.00, labels clipped at the top,
  left and right edges, on seeded backgrounds; a class list that takes
  every route of `utils.text`), box pixels and label
  pixels read apart; the committed references (`native/fixtures/
  render.json` and its PNGs, which `chip_smoke.py` holds the card's host
  to, where there is no cv2) against the JAX function's render now;
* `log_image_with_boxes` against the JAX one: both write `step_N.jpg`;
* `tools/font_table.py` regenerates the committed fonts (the Rubik table,
  WenQuanYi's gzip member, the notices) byte for byte from cv2's binary;
* no runtime module of the port imports cv2, PIL, fontTools or jax.

The label reading reached and pinned: every label pixel equal (share
1.0, max abs 0; ink IoU 1.0, mean abs 0), beside the floor a label is
held to at worst (`tools.render_check`: ink IoU 0.95, mean abs 2 levels
over its box).

Regenerate the render fixtures with `PYTHONPATH=. python
tests/test_torch_render.py` from the repo root.
"""
import ast
import json
import os
import sys

import cv2
import numpy as np
import pytest

from semi_detr_tpu_torch import native
from semi_detr_tpu_torch.api import save_result
from semi_detr_tpu_torch.data.coco import COCO_CLASSES
from semi_detr_tpu_torch.data.image_io import read_image
from semi_detr_tpu_torch.tools import render_check
from semi_detr_tpu_torch.utils import logging as port_logging
from semi_detr_tpu_torch.utils import text
from semi_detr_tpu_torch.utils.logging import draw_rect

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = os.path.join(native.FIXTURES, "render.json")
GREEN = (0, 255, 0)


def host_picture(h, w, seed):
    """chip_smoke.host_picture: seeded noise over gradients."""
    rs = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    base = (xs // 3 + ys // 2)[..., None] + 60 * np.arange(3)
    return ((base + rs.randint(0, 40, (h, w, 3))) % 256).astype(np.uint8)


# ------------------------------------------------------------- rectangles

def seeded_boxes(rng, n, h, w):
    """Boxes over and around an (h, w) image: random, degenerate (a line,
    a point), swapped corners, wholly outside."""
    out = []
    for i in range(n):
        x0, x1 = (int(v) for v in rng.integers(-12, w + 12, 2))
        y0, y1 = (int(v) for v in rng.integers(-12, h + 12, 2))
        kind = i % 8
        if kind == 1:
            x1 = x0
        elif kind == 2:
            y1 = y0
        elif kind == 3:
            x1, y1 = x0, y0
        elif kind == 4:
            x0, x1 = -30, -20
        out.append((x0, y0, x1, y1))
    return out


@pytest.mark.parametrize("thickness", [1, 2])
@pytest.mark.parametrize("hw", [(60, 80), (1, 1), (17, 5)])
def test_draw_rect_is_cv2_rectangle(thickness, hw):
    rng = np.random.default_rng(thickness * 100 + hw[0])
    h, w = hw
    n = 600 if hw == (60, 80) else 200
    for box in seeded_boxes(rng, n, h, w):
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        want = cv2.rectangle(img.copy(), box[:2], box[2:], GREEN, thickness)
        got = img.copy()
        draw_rect(got, *box, color=GREEN, thickness=thickness)
        np.testing.assert_array_equal(got, want, err_msg=str(box))


def test_draw_rect_takes_int_of_floats():
    img = np.zeros((30, 40, 3), np.uint8)
    want = cv2.rectangle(img.copy(), (3, 4), (20, 9), GREEN, 2)
    got = img.copy()
    draw_rect(got, 3.9, 4.2, 20.99, 9.5, GREEN)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="thickness"):
        draw_rect(got, 0, 0, 5, 5, GREEN, thickness=3)


# ----------------------------------------------------------------- labels

def cv2_label(img, s, org, color):
    return cv2.putText(img.copy(), s, org, cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                       color, 1)


@pytest.mark.parametrize("code", range(32, 127))
def test_glyph_is_cv2s(code):
    ch = chr(code)
    img = np.zeros((40, 50, 3), np.uint8)
    want = cv2_label(img, ch, (12, 26), (255, 255, 255))
    got = text.put_text(img.copy(), ch, (12, 26), (255, 255, 255))
    np.testing.assert_array_equal(got, want)


def test_labels_are_cv2_put_text():
    """Random printable text, colour, background and origin, clipped at
    every edge of images 5-100 pixels wide."""
    rng = np.random.default_rng(2)
    for _ in range(200):
        w, h = int(rng.integers(5, 100)), int(rng.integers(5, 40))
        bg = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        s = "".join(chr(int(c)) for c in rng.integers(
            32, 127, int(rng.integers(1, 25))))
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        org = (int(rng.integers(-40, w + 5)), int(rng.integers(-5, h + 15)))
        np.testing.assert_array_equal(
            text.put_text(bg.copy(), s, org, color),
            cv2_label(bg, s, org, color), err_msg=f"{s!r} at {org}")


def test_label_box_bounds_the_ink():
    img = np.zeros((60, 200, 3), np.uint8)
    s = "person:0.87"
    drawn = cv2_label(img, s, (20, 40), (255, 255, 255)).any(-1)
    x0, y0, x1, y1 = text.text_box(s, (20, 40))
    ys, xs = np.nonzero(drawn)
    assert x0 <= xs.min() and xs.max() < x1 and y0 <= ys.min() \
        and ys.max() < y1


@pytest.mark.parametrize("label", ["人:0.50", "café:0.31", "a\tb"])
def test_a_character_outside_the_table_raises(label):
    """A character outside printable ASCII is drawn as cv2 draws it (the
    fallback font, Rubik past ASCII, the box); the one character refused,
    before anything is drawn, is a lone surrogate, on which cv2 crashes."""
    img = np.random.default_rng(len(label)).integers(
        0, 256, (20, 80, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        text.put_text(img.copy(), label, (2, 15), GREEN),
        cv2_label(img, label, (2, 15), GREEN))
    bad = img.copy()
    with pytest.raises(ValueError, match="lone surrogate"):
        text.put_text(bad, label + "\ud800", (2, 15), GREEN)
    np.testing.assert_array_equal(bad, img)     # nothing drawn before it


def test_a_missing_or_damaged_table_raises(tmp_path, monkeypatch):
    for body in (None, "{", json.dumps({"font": {"wght": 400,
                                                 "ascender": 935},
                                        "glyphs": {"A": {"advance": 1,
                                                         "points": [1, 2],
                                                         "on": "1",
                                                         "ends": [3]}}})):
        path = tmp_path / "table.json"
        if body is not None:
            path.write_text(body)
        monkeypatch.setattr(text, "TABLE", str(path))
        text.table.cache_clear()
        text.glyph.cache_clear()
        with pytest.raises(text.GlyphTableError):
            text.put_text(np.zeros((20, 20, 3), np.uint8), "A", (1, 15),
                          GREEN)
        path.unlink(missing_ok=True)
    monkeypatch.undo()
    text.table.cache_clear()
    text.glyph.cache_clear()
    assert text.table()["font"]["wght"] == text.WGHT


# ---------------------------------------------------- save_result vs JAX

CASE_NAMES = ("edges", "coco80", "dense", "names")
# the class list of the "names" case: a name for every route of utils.text
# (Rubik past ASCII: Latin-1, Latin Extended, Cyrillic, Hebrew, a combining
# mark; the fallback font: Han, kana, Hangul, fullwidth forms; the box: an
# emoji, a tab, a carriage return) and a line break and an end of text
RENDER_NAMES = ("café", "Łódź żółw", "Ёжик", "שלום", "cafe\u0301", "猫",
                "ねこ", "고양이", "ＴＶ", "🐱 cat", "tab\there", "cr\rlf",
                "two\nlines", "end\0hidden")


def render_cases():
    with open(SPEC) as f:
        return json.load(f)["cases"]


def render_case(name):
    case, = [c for c in render_cases() if c["name"] == name]
    return case


def case_classes(case):
    return tuple(case.get("classes", COCO_CLASSES))


def case_inputs(case):
    img = host_picture(case["h"], case["w"], case["seed"])
    result = (np.asarray(case["boxes"], np.float32),
              np.asarray(case["scores"], np.float32),
              np.asarray(case["labels"], np.int64))
    return img, result


def jax_render(img, result, score_thr, path, classes=COCO_CLASSES):
    from semi_detr_tpu.api import save_result as jax_save_result
    jax_save_result(img, result, classes, path, score_thr=score_thr)
    return cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_save_result_is_jax_save_result(tmp_path, name):
    case = render_case(name)
    img, result = case_inputs(case)
    thr, classes = case["score_thr"], case_classes(case)
    want = jax_render(img, result, thr, str(tmp_path / "jax.png"), classes)
    out = save_result(img, result, classes, str(tmp_path / "port.png"),
                      score_thr=thr)
    got = read_image(out)
    held = render_check.hold(got, want, img, result, classes, thr)
    assert held["ok"] and held["box_max_abs"] == 0
    # the reading reached, pinned
    assert held["label"] == dict(equal=1.0, max_abs=0, iou=1.0,
                                 mean_abs=0.0), held
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_render_fixtures_are_cv2s(tmp_path, name):
    """The committed reference (what chip_smoke holds the card to) is the
    JAX save_result's render now, and the port draws it."""
    case = render_case(name)
    img, result = case_inputs(case)
    ref = read_image(os.path.join(native.FIXTURES, case["ref"]))
    classes = case_classes(case)
    np.testing.assert_array_equal(
        jax_render(img, result, case["score_thr"], str(tmp_path / "j.png"),
                   classes), ref)
    got = img.copy()
    for b, s, lab in zip(*result):
        if s >= case["score_thr"]:
            port_logging.draw_detection(got, b,
                                        f"{classes[int(lab)]}:{s:.2f}")
    np.testing.assert_array_equal(got, ref)


def test_render_cases_cover_the_names_scores_and_edges():
    cases = render_cases()
    assert [{k: v for k, v in c.items() if k != "ref"} for c in cases] == \
        make_cases()
    assert tuple(c["name"] for c in cases) == CASE_NAMES
    coco = [c for c in cases if "classes" not in c]
    labels = {int(x) for c in coco for x in c["labels"]}
    scores = [s for c in coco for s in c["scores"]]
    assert labels == set(range(80))
    assert min(scores) == 0.0 and max(scores) == 1.0
    edges = set()
    for c in cases:
        for (x0, y0, x1, y1), s in zip(c["boxes"], c["scores"]):
            if s < c["score_thr"]:
                continue
            if int(y0) - 4 < text.PIXEL_SIZE:
                edges.add("top")
            if int(x0) < 0:
                edges.add("left")
            if int(x0) + 40 > c["w"]:
                edges.add("right")
    assert edges == {"top", "left", "right"}
    names = render_case("names")
    assert tuple(names["classes"]) == RENDER_NAMES
    assert sorted(names["labels"]) == list(range(len(RENDER_NAMES)))
    drawn = "".join(RENDER_NAMES)
    assert {text.route(ch) for ch in drawn if ch not in "\n\0"} == \
        set(text.ROUTES)
    assert "\n" in drawn and "\0" in drawn


# ------------------------------------------------ log_image_with_boxes

@pytest.mark.parametrize("variant", ["scores", "no_scores", "no_names",
                                     "normalized", "non_ascii_names"])
def test_log_image_with_boxes_is_jax(tmp_path, variant):
    from semi_detr_tpu.utils.logging import log_image_with_boxes as jax_log
    case = render_case("names" if variant == "non_ascii_names" else "edges")
    img, (boxes, scores, labels) = case_inputs(case)
    keep = np.arange(len(boxes)) % 3 != 1
    kw = dict(scores=None if variant == "no_scores" else scores, keep=keep,
              class_names=None if variant == "no_names"
              else case_classes(case))
    if variant == "normalized":
        from semi_detr_tpu_torch.data.augment import IMG_MEAN, IMG_STD
        img = ((img - IMG_MEAN) / IMG_STD).astype(np.float32)
    a = jax_log(str(tmp_path / "jax"), "pseudo_vis", 4, img, boxes, labels,
                **kw)
    b = port_logging.log_image_with_boxes(str(tmp_path / "port"),
                                          "pseudo_vis", 4, img, boxes,
                                          labels, **kw)
    assert os.path.basename(a) == os.path.basename(b) == "step_4.jpg"
    with open(a, "rb") as f, open(b, "rb") as g:
        ja, jb = f.read(), g.read()
    np.testing.assert_array_equal(read_image(b), cv2.imdecode(
        np.frombuffer(ja, np.uint8), cv2.IMREAD_COLOR)[..., ::-1])
    assert ja == jb                 # the same pixels through one encoder


# ------------------------------------------------------ glyph provenance

def test_font_table_regenerates(tmp_path):
    pytest.importorskip("fontTools", reason="the generator instances the "
                        "font with fontTools, which this machine lacks")
    from semi_detr_tpu_torch.tools import font_table
    paths = font_table.main(["--out", str(tmp_path)])
    for path in paths:
        with open(path, "rb") as f, open(os.path.join(
                text.FONT_DIR, os.path.basename(path)), "rb") as g:
            assert f.read() == g.read(), os.path.basename(path)


def test_font_table_header_and_notice():
    head = text.table()["font"]
    assert head["wght"] == 400 and head["wght_normalized"] == 0.1875
    assert head["ascender"] == 935 and head["units_per_em"] == 1000
    cmap = text.table()["cmap"]
    assert len(cmap) == 885 and {chr(c) for c in range(32, 127)} <= set(cmap)
    with open(os.path.join(text.FONT_DIR, "Rubik-OFL.txt")) as f:
        notice = f.read()
    assert "SIL Open Font License, Version 1.1" in notice
    with open(os.path.join(text.FONT_DIR,
                           "WenQuanYiMicroHei-NOTICE.txt")) as f:
        notice = f.read()
    assert "Licensed under the Apache License, Version 2.0" in notice
    with open(os.path.join(text.FONT_DIR, "Apache-2.0.txt")) as f:
        assert "Apache License" in f.read()
    wqy = text.fallback()
    assert (wqy.units_per_em, wqy.ascent, wqy.descent) == (2048, 1918, -483)
    assert len(wqy.cmap) == 34600 and wqy.num_glyphs == 49531


FORBIDDEN = ("cv2", "PIL", "fontTools", "jax", "jaxlib", "semi_detr_tpu")


def test_no_runtime_module_imports_cv2_pil_fonttools_or_jax():
    pkg = os.path.join(REPO, "semi_detr_tpu_torch")
    found = []
    for root, _, files in os.walk(pkg):
        for name in files:
            path = os.path.join(root, name)
            rel = os.path.relpath(path, pkg)
            if not name.endswith(".py") or rel == os.path.join(
                    "tools", "font_table.py"):
                continue
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module or ""]
                else:
                    continue
                found += [(rel, m) for m in mods
                          if m.split(".")[0] in FORBIDDEN]
    assert not found


# --------------------------------------------------------------- fixtures

def make_cases():
    """The render cases: boxes, scores and labels over seeded pictures."""
    rng = np.random.default_rng(13)
    cases = []
    # 1: the edges: labels above the top, boxes off the left and right,
    # degenerate, swapped and outside boxes, score ties
    h, w = 80, 120
    boxes = [[3.7, 2.2, 40.1, 30.9], [-6.5, 20.0, 30.0, 50.0],
             [100.2, 40.0, 130.0, 70.0], [60.0, 5.0, 90.0, 35.0],
             [50.0, 60.0, 50.0, 75.0], [20.0, 70.0, 5.0, 55.0],
             [-40.0, -30.0, -10.0, -5.0], [110.0, -3.0, 125.0, 12.0],
             [30.0, 45.0, 70.0, 78.0], [0.0, 0.0, 119.0, 79.0],
             [85.0, 50.0, 118.0, 52.0], [10.0, 14.0, 26.0, 40.0]]
    scores = [1.0, 0.0, 0.995, 0.125, 0.005, 0.5, 0.9, 0.875, 0.29, 0.3,
              0.31, 0.67]
    labels = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]
    cases.append(dict(name="edges", h=h, w=w, seed=21, score_thr=0.0,
                      boxes=boxes, scores=scores, labels=labels))
    # 2: every COCO name once, scores 0.00-1.00
    h, w = 180, 280
    boxes = []
    for _ in range(80):
        x0, y0 = rng.uniform(-20, w - 10), rng.uniform(-10, h - 10)
        bw, bh = rng.uniform(4, 90), rng.uniform(4, 70)
        boxes.append([round(float(v), 2) for v in (x0, y0, x0 + bw,
                                                    y0 + bh)])
    scores = [round(float(s), 4) for s in np.linspace(0.0, 1.0, 80)]
    cases.append(dict(name="coco80", h=h, w=w, seed=22, score_thr=0.0,
                      boxes=boxes, scores=scores,
                      labels=[int(x) for x in rng.permutation(80)]))
    # 3: dense and thresholded, as the demo's default 0.3
    h, w = 150, 200
    boxes = []
    for _ in range(40):
        x0, y0 = rng.uniform(-10, w), rng.uniform(-10, h)
        boxes.append([round(float(v), 2) for v in (
            x0, y0, x0 + rng.uniform(1, 60), y0 + rng.uniform(1, 50))])
    cases.append(dict(name="dense", h=h, w=w, seed=23, score_thr=0.3,
                      boxes=boxes,
                      scores=[round(float(s), 3)
                              for s in rng.uniform(0, 1, 40)],
                      labels=[int(x) for x in rng.integers(0, 80, 40)]))
    # 4: a class list that takes every route of utils.text, fixed boxes and
    # scores, one label clipped at the top and one at the right edge
    h, w = 104, 230
    boxes = [[6.0, 20.0, 50.0, 40.0], [80.0, 18.0, 150.0, 45.0],
             [160.0, 24.0, 225.0, 50.0], [8.0, 55.0, 50.0, 75.0],
             [62.0, 60.0, 118.0, 80.0], [128.0, 62.0, 170.0, 85.0],
             [178.0, 66.0, 226.0, 90.0], [6.0, 88.0, 60.0, 110.0],
             [72.0, 95.0, 112.0, 112.0], [120.0, 104.0, 190.0, 118.0],
             [200.0, 8.0, 229.0, 30.0], [30.0, 2.0, 70.0, 12.0],
             [92.0, 84.0, 150.0, 92.0], [190.0, 100.0, 229.0, 119.0]]
    cases.append(dict(name="names", h=h, w=w, seed=24, score_thr=0.0,
                      boxes=boxes,
                      scores=[0.99, 0.87, 0.5, 0.31, 0.05, 1.0, 0.62, 0.44,
                              0.78, 0.12, 0.95, 0.3, 0.66, 0.21],
                      labels=list(range(len(RENDER_NAMES))),
                      classes=list(RENDER_NAMES)))
    return cases


def write_fixtures():
    import tempfile
    cases = make_cases()
    with tempfile.TemporaryDirectory() as tmp:
        for case in cases:
            case["ref"] = f"render_{case['name']}.png"
            img, result = case_inputs(case)
            got = jax_render(img, result, case["score_thr"],
                             os.path.join(tmp, "r.png"), case_classes(case))
            cv2.imwrite(os.path.join(native.FIXTURES, case["ref"]),
                        got[..., ::-1], [cv2.IMWRITE_PNG_COMPRESSION, 9])
    with open(SPEC, "w") as f:
        json.dump({"picture": "host_picture(h, w, seed) of "
                              "tests/test_torch_render.py and chip_smoke.py",
                   "drawn_by": "semi_detr_tpu.api.save_result (cv2 5.0.0) "
                               "with the 80 COCO class names, or the "
                               "case's classes",
                   "cases": cases}, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(write_fixtures())
