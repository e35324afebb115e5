"""The hold of a render against cv2's: `tests/test_torch_render.py` on the
CPU and `chip_smoke.py` phase 7r on the card's host read `save_result`'s
pixels through it.

Box pixels (those `draw_rect` paints) must be equal. A label is held at
worst to an ink IoU of at least IOU_FLOOR and a mean abs of at most
MEAN_ABS_CEIL grey levels over its pixels (the label's box less the box
pixels), where ink is the pixels moved more than half-way from the
background to the colour; the share of equal pixels and the max abs are
reported beside them (the render reaches equality: share 1.0, max abs
0).
"""
from __future__ import annotations

import numpy as np

from ..utils import text
from ..utils.logging import draw_rect

COLOUR = (0, 255, 0)
IOU_FLOOR, MEAN_ABS_CEIL = 0.95, 2.0


def label_text(name: str, score) -> str:
    """The label the JAX renders draw for a detection."""
    return f"{name}:{score:.2f}"


def masks(shape, result, class_names, score_thr):
    """(box mask, label mask) of what `save_result` draws on an image of
    `shape`: the pixels draw_rect paints, and the label boxes' pixels no
    box paints."""
    box = np.zeros(shape, np.uint8)
    label = np.zeros(shape[:2], bool)
    for b, s, lab in zip(*result):
        if s < score_thr:
            continue
        draw_rect(box, *b, color=(1, 1, 1))
        x0, y0, x1, y1 = text.text_box(
            label_text(class_names[int(lab)], s),
            (int(b[0]), max(int(b[1]) - 4, 0)))
        label[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = True
    box = box[..., 0] > 0
    return box, label & ~box


def label_reading(got, want, before, mask) -> dict:
    """Over the label pixels `mask`: the share equal, max abs, ink IoU and
    mean abs of `got` against `want`, drawn over `before`."""
    g, w, b = (x[mask].astype(np.int64) for x in (got, want, before))
    diff = np.abs(g - w)

    def ink(x):
        return (np.abs(x - COLOUR) * 2 < np.abs(b - COLOUR) + 1).all(-1)
    a, c = ink(g), ink(w)
    union = int((a | c).sum())
    return dict(equal=float((diff == 0).all(-1).mean()) if diff.size else 1.0,
                max_abs=int(diff.max()) if diff.size else 0,
                iou=float((a & c).sum() / union) if union else 1.0,
                mean_abs=float(diff.mean()) if diff.size else 0.0)


def hold(got, want, before, result, class_names, score_thr) -> dict:
    """The readings of a render `got` against `want` (both drawn over
    `before`) and whether they hold: {"box_max_abs", "label": reading,
    "ok"}."""
    box, label = masks(before.shape, result, class_names, score_thr)
    box_abs = int(np.abs(got[box].astype(np.int64) - want[box]).max(
        initial=0))
    r = label_reading(got, want, before, label)
    return dict(box_max_abs=box_abs, label=r,
                ok=box_abs == 0 and r["iou"] >= IOU_FLOOR
                and r["mean_abs"] <= MEAN_ABS_CEIL)
