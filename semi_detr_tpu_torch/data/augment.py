"""Weak/strong/supervised augmentations and the test-time resize, with the
3x3 transform matrix of every view.

Counterpart of `semi_detr_tpu/data/augment.py` (the reference's SSOD
pipelines, `configs/detr_ssod/base_dino_detr_ssod_coco.py:6-198`,
`detr_ssod/datasets/pipelines/rand_aug.py`, `geo_utils.py:7-94`):

* weak   = RandResize(11 scales, keep ratio) + RandFlip(0.5);
* strong = weak + shuffled [OneOf(9 colour ops), OneOf(translate_x |
  translate_y | rotate +-30 | shear_x then shear_y +-30)] + RandErase(1-4
  patches, fill 125);
* sup    = weak + OneOf(colour).

Every geometric step composes its homogeneous matrix into `matrix` (new =
T @ old), which the SSOD step uses to carry pseudo boxes between views.

Neither cv2 nor PIL is needed (the card's machine has neither). Every
function takes the JAX package's `np.random.Generator` and draws from it
in the same order with the same methods, so one seed gives the same ops,
magnitudes, angles and patches in both packages. The draws stay here; the
pixel work goes to `px`, the port's host library (`native/`, C++, the GIL
released), whose every function equals its numpy plain version in
`NumpyPixels` bit for bit:

* resize: bilinear with half-pixel centres, the JAX package's native
  formula (`sdt_resize_bilinear`): within one grey level of cv2's
  INTER_LINEAR;
* colour ops: Pillow's algorithms (`ImageOps` autocontrast / equalize /
  posterize, `ImageEnhance` Color / Contrast / Brightness / Sharpness as
  `Image.blend(degenerate, image, v)` in single precision, truncated and
  clipped), equal to Pillow's bit for bit;
* geometric ops: a bilinear affine warp through the inverse matrix at
  integer pixel centres, taps outside the image reading the border value
  FILL, as `cv2.warpAffine(..., borderValue=FILL)` does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Tuple

import numpy as np

from .. import native

COCO_SCALES: Tuple[Tuple[int, int], ...] = tuple(
    (s, 1333) for s in (480, 512, 544, 576, 608, 640, 672, 704, 736, 768,
                        800))
TEST_SCALE = (800, 1333)
IMG_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMG_STD = np.array([58.395, 57.12, 57.375], np.float32)
FILL = 125
# the pixel work of every function below: the host library; a measurement
# may set it to NumpyPixels (chip_smoke.py times both)
px = native


@dataclass
class Sample:
    img: np.ndarray                 # (H, W, 3) uint8 RGB
    boxes: np.ndarray               # (n, 4) xyxy float32
    labels: np.ndarray              # (n,) int64
    matrix: np.ndarray              # (3, 3) float64 accumulated transform
    # per-axis (fx, fy): the int-rounded keep-ratio resize makes nh/h
    # differ slightly from nw/w, and boxes rescale by [fx, fy, fx, fy]
    scale_factor: np.ndarray = field(
        default_factory=lambda: np.ones(2, np.float32))


def make_sample(img, boxes=None, labels=None) -> Sample:
    boxes = (np.zeros((0, 4), np.float32) if boxes is None
             else np.asarray(boxes, np.float32).reshape(-1, 4))
    labels = (np.zeros((0,), np.int64) if labels is None
              else np.asarray(labels, np.int64))
    return Sample(img=img, boxes=boxes, labels=labels,
                  matrix=np.eye(3, dtype=np.float64))


def _compose(sample: Sample, t: np.ndarray) -> np.ndarray:
    return t.astype(np.float64) @ sample.matrix


def _transform_boxes_np(boxes, mat, w, h, clip=True):
    """The four corners of each box through `mat`, their enclosing box,
    clipped to the image."""
    if len(boxes) == 0:
        return boxes
    x0, y0, x1, y1 = boxes.T
    xs = np.stack([x0, x1, x0, x1], 1)          # (n, 4)
    ys = np.stack([y0, y1, y1, y0], 1)
    pts = np.stack([xs, ys, np.ones_like(xs)], 1)   # (n, 3, 4)
    out = mat[None] @ pts
    px, py = out[:, 0] / out[:, 2], out[:, 1] / out[:, 2]
    nb = np.stack([px.min(1), py.min(1), px.max(1), py.max(1)], 1)
    if clip:
        nb[:, 0::2] = np.clip(nb[:, 0::2], 0, w)
        nb[:, 1::2] = np.clip(nb[:, 1::2], 0, h)
    return nb.astype(np.float32)


def _filter_degenerate(s: Sample, min_size: float = 0.0) -> Sample:
    if len(s.boxes) == 0:
        return s
    keep = ((s.boxes[:, 2] - s.boxes[:, 0]) > min_size) & (
        (s.boxes[:, 3] - s.boxes[:, 1]) > min_size)
    return replace(s, boxes=s.boxes[keep], labels=s.labels[keep])


# ---------------------------------------------------------------- resize/flip

def rescale_size(h: int, w: int, scale: Tuple[int, int]
                 ) -> Tuple[int, int, float]:
    """mmdet keep_ratio rescale: factor = min(long/max, short/min)."""
    short, long_ = min(scale), max(scale)
    f = min(long_ / max(h, w), short / min(h, w))
    return int(h * f + 0.5), int(w * f + 0.5), f


def resize_bilinear_np(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """numpy version of `native.resize_bilinear`: half-pixel centres, taps
    clamped to the image, float32 throughout, + 0.5 and truncated."""
    sh, sw = img.shape[:2]
    one, half = np.float32(1), np.float32(0.5)

    def taps(n_out, n_in):
        f = np.float32(n_in) / np.float32(n_out)
        s = np.maximum((np.arange(n_out, dtype=np.float32) + half) * f - half,
                       np.float32(0))
        i0 = np.minimum(s.astype(np.int64), n_in - 1)
        return i0, np.minimum(i0 + 1, n_in - 1), s - i0.astype(np.float32)

    y0, y1, wy = taps(dh, sh)
    x0, x1, wx = taps(dw, sw)
    x = img.astype(np.float32)
    wx, wy = wx[None, :, None], wy[:, None, None]
    top = x[y0][:, x0] * (one - wx) + x[y0][:, x1] * wx
    bot = x[y1][:, x0] * (one - wx) + x[y1][:, x1] * wx
    return (top * (one - wy) + bot * wy + half).astype(np.uint8)


def resized(sample: Sample, img: np.ndarray, src_hw) -> Sample:
    """`sample`, of size src_hw, with `img` (its image resized) in its
    place: boxes, matrix and scale factor follow the resize."""
    h, w = src_hw
    nh, nw = img.shape[:2]
    fx, fy = nw / w, nh / h
    t = np.array([[fx, 0, 0], [0, fy, 0], [0, 0, 1]], np.float64)
    boxes = sample.boxes * np.array([fx, fy, fx, fy], np.float32)
    return replace(sample, img=img, boxes=boxes, matrix=_compose(sample, t),
                   scale_factor=sample.scale_factor
                   * np.array([fx, fy], np.float32))


def resize(sample: Sample, scale: Tuple[int, int]) -> Sample:
    h, w = sample.img.shape[:2]
    nh, nw, _ = rescale_size(h, w, scale)
    return resized(sample, px.resize_bilinear(sample.img, nh, nw), (h, w))


def rand_resize(rng: np.random.Generator, sample: Sample,
                scales=COCO_SCALES) -> Sample:
    return resize(sample, scales[rng.integers(len(scales))])


def hflip(sample: Sample) -> Sample:
    h, w = sample.img.shape[:2]
    img = sample.img[:, ::-1]
    t = np.array([[-1, 0, w], [0, 1, 0], [0, 0, 1]], np.float64)
    if len(sample.boxes):
        b = sample.boxes.copy()
        b[:, [0, 2]] = w - sample.boxes[:, [2, 0]]
    else:
        b = sample.boxes
    return replace(sample, img=np.ascontiguousarray(img), boxes=b,
                   matrix=_compose(sample, t))


def rand_flip(rng, sample: Sample, p: float = 0.5) -> Sample:
    return hflip(sample) if rng.random() < p else sample


# ---------------------------------------------------------------- colour ops
# Pillow's algorithms (PIL/ImageOps.py, ImageEnhance.py, libImaging
# Blend.c, Filter.c, Convert.c), bit for bit; the numpy versions of the
# pixel loops below are the plain versions of the host library's

def _per_band_lut(img: np.ndarray, make_lut) -> np.ndarray:
    """Apply a 256-entry table per channel, built from its histogram
    (Pillow `_lut` -> `Image.point`, which clips entries to 0..255)."""
    luts = [np.clip(make_lut(h), 0, 255).astype(np.uint8)
            for h in px.histogram(img)]
    return px.apply_lut(img, np.stack(luts))


def _histogram_np(img: np.ndarray) -> np.ndarray:
    return np.stack([np.bincount(img[..., c].ravel(), minlength=256)
                     for c in range(img.shape[2])])


def _apply_lut_np(img: np.ndarray, luts: np.ndarray) -> np.ndarray:
    out = np.empty_like(img)
    for c in range(img.shape[2]):
        out[..., c] = luts[c][img[..., c]]
    return out


def _autocontrast_lut(h: np.ndarray) -> np.ndarray:
    nz = np.nonzero(h)[0]
    lo, hi = nz[0], nz[-1]
    if hi <= lo:
        return np.arange(256)
    scale = 255.0 / (hi - lo)
    offset = -lo * scale
    # Python's int() of ix * scale + offset, in doubles
    return np.trunc(np.arange(256, dtype=np.float64) * scale + offset)


def _equalize_lut(h: np.ndarray) -> np.ndarray:
    histo = h[h > 0]
    if len(histo) <= 1:
        return np.arange(256)
    step = (int(histo.sum()) - int(histo[-1])) // 255
    if not step:
        return np.arange(256)
    before = np.concatenate([[0], np.cumsum(h)[:-1]])
    return (step // 2 + before) // step


def _gray(img: np.ndarray) -> np.ndarray:
    """RGB -> L as Pillow's `convert("L")`: ITU-R 601-2 luma in 16-bit
    fixed point, rounded."""
    x = img.astype(np.int64)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _blend(degenerate: np.ndarray, img: np.ndarray, factor: float
           ) -> np.ndarray:
    """Pillow `Image.blend(degenerate, img, factor)`: in1 + alpha * (in2 -
    in1) in single precision, truncated to uint8 (clipped when alpha lies
    outside [0, 1])."""
    alpha = np.float32(factor)
    if alpha == 0.0:
        return np.array(np.broadcast_to(degenerate, img.shape))
    if alpha == 1.0:
        return img.copy()
    d = degenerate.astype(np.int32)
    v = d.astype(np.float32) + alpha * (img.astype(np.int32) - d).astype(
        np.float32)
    return np.clip(v, 0, 255).astype(np.uint8)


def _smooth(img: np.ndarray) -> np.ndarray:
    """Pillow's ImageFilter.SMOOTH (1 1 1 / 1 5 1 / 1 1 1, / 13): float32
    sums in Filter.c's order, +0.5, truncated and clipped; the border
    pixels are kept."""
    k1 = np.float32(1) / np.float32(13)
    k5 = np.float32(5) / np.float32(13)
    x = img.astype(np.float32)
    h, w = img.shape[:2]
    if h < 3 or w < 3:
        return img.copy()

    def row(r, kc):       # (a * k0 + b * k1) + c * k2 for one source row
        return (x[r, :-2] * k1 + x[r, 1:-1] * kc) + x[r, 2:] * k1

    ss = np.float32(0.5) + row(slice(2, None), k1)
    ss = ss + row(slice(1, -1), k5)
    ss = ss + row(slice(0, -2), k1)
    out = img.copy()
    out[1:-1, 1:-1] = np.clip(ss, 0, 255).astype(np.uint8)
    return out


def _solarize_np(img: np.ndarray, thr: int) -> np.ndarray:
    return np.where(img < thr, img, 255 - img).astype(img.dtype)


def _posterize_np(img: np.ndarray, mask: int) -> np.ndarray:
    return img & np.uint8(mask)


def apply_color_op(rng: np.random.Generator, sample: Sample) -> Sample:
    """OneOf the 9 colour ops (Identity included), magnitude ~ U{1..9} on a
    0-10 scale (`rand_aug.py:59-61`)."""
    op = int(rng.integers(9))
    mag = int(rng.integers(1, 10))
    img = sample.img
    v = mag * 1.8 / 10 + 0.1            # the ImageEnhance factor

    if op == 0:
        out = img
    elif op == 1:
        out = _per_band_lut(img, _autocontrast_lut)
    elif op == 2:
        out = _per_band_lut(img, _equalize_lut)
    elif op == 3:
        out = px.solarize(img, min(int(mag * 256 / 10), 255))
    elif op == 4:                       # Color: blend with the gray image
        out = px.blend(px.gray(img)[..., None], img, v)
    elif op == 5:                       # Contrast: with the mean gray
        g = px.gray(img)
        mean = int(int(g.astype(np.int64).sum()) / g.size + 0.5)
        out = px.blend(np.full((1, 1, 1), mean, np.uint8), img, v)
    elif op == 6:                       # Brightness: with black
        out = px.blend(np.zeros((1, 1, 1), np.uint8), img, v)
    elif op == 7:                       # Sharpness: with the smoothed image
        out = px.blend(px.smooth(img), img, v)
    else:
        bits = 4 - int(mag * 4 / 10)
        out = px.posterize(img, ~(2 ** (8 - bits) - 1) & 0xFF)
    return replace(sample, img=out)


# ---------------------------------------------------------------- geometric

def _inverse_affine(t2x3: np.ndarray) -> np.ndarray:
    """The destination -> source map of a forward 2x3 matrix, as
    cv2.warpAffine inverts it (imgwarp.cpp)."""
    m = np.asarray(t2x3, np.float64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, -m[1] * d, -m[3] * d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m.reshape(2, 3)


def warp_affine(img: np.ndarray, t2x3: np.ndarray, fill: int = FILL
                ) -> np.ndarray:
    """Bilinear affine warp of an (H, W, C) uint8 image into the same size:
    each destination pixel (x, y) samples the source at inv @ (x, y, 1);
    taps outside the image read `fill`."""
    return px.warp_affine(img, _inverse_affine(t2x3).astype(np.float32), fill)


def _warp_affine_np(img: np.ndarray, inv: np.ndarray, fill: int
                    ) -> np.ndarray:
    """numpy version of `native.warp_affine` (inv: the float32
    destination -> source map)."""
    h, w, c = img.shape
    xs = np.arange(w, dtype=np.float32)[None]
    ys = np.arange(h, dtype=np.float32)[:, None]
    sx = inv[0, 0] * xs + (inv[0, 1] * ys + inv[0, 2])
    sy = inv[1, 0] * xs + (inv[1, 1] * ys + inv[1, 2])
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    # a ring of `fill` around the image: every tap index is clipped into
    # [-1, W] x [-1, H], and all taps outside the image read the ring
    pad = np.full((h + 2, w + 2, c), fill, np.float32)
    pad[1:-1, 1:-1] = img
    flat = pad.reshape(-1, c)
    xi = [np.clip(x0 + dx, -1, w).astype(np.int64) + 1 for dx in (0, 1)]
    yi = [(np.clip(y0 + dy, -1, h).astype(np.int64) + 1) * (w + 2)
          for dy in (0, 1)]

    def lerp_x(dy):
        left = flat[yi[dy] + xi[0]]
        return left + fx * (flat[yi[dy] + xi[1]] - left)

    top = lerp_x(0)
    out = top + fy * (lerp_x(1) - top)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


class NumpyPixels:
    """The numpy plain versions of the host library's pixel functions,
    with its signatures: the tests and chip_smoke.py hold the library to
    them (and chip_smoke.py times the views with them as `px`)."""
    resize_bilinear = staticmethod(resize_bilinear_np)
    warp_affine = staticmethod(_warp_affine_np)
    histogram = staticmethod(_histogram_np)
    apply_lut = staticmethod(_apply_lut_np)
    gray = staticmethod(_gray)
    blend = staticmethod(_blend)
    smooth = staticmethod(_smooth)
    solarize = staticmethod(_solarize_np)
    posterize = staticmethod(_posterize_np)


def _warp(sample: Sample, t2x3: np.ndarray) -> Sample:
    h, w = sample.img.shape[:2]
    img = warp_affine(sample.img, t2x3)
    t3 = np.concatenate([t2x3, [[0, 0, 1]]], 0)
    boxes = _transform_boxes_np(sample.boxes, t3, w, h)
    s = replace(sample, img=img, boxes=boxes, matrix=_compose(sample, t3))
    return _filter_degenerate(s)


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: counter-clockwise by `angle` degrees about
    `center`."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]],
                    np.float64)


def translate(rng, sample: Sample, x_range=None, y_range=None) -> Sample:
    h, w = sample.img.shape[:2]
    dx = dy = 0.0
    if x_range is not None:
        dx = (rng.random() * (x_range[1] - x_range[0]) + x_range[0]) * w
    if y_range is not None:
        dy = (rng.random() * (y_range[1] - y_range[0]) + y_range[0]) * h
    t = np.array([[1, 0, dx], [0, 1, dy]], np.float64)
    return _warp(sample, t)


def rotate(rng, sample: Sample, angle_range=(-30, 30)) -> Sample:
    h, w = sample.img.shape[:2]
    angle = rng.random() * (angle_range[1] - angle_range[0]) + angle_range[0]
    center = ((w - 1) * 0.5, (h - 1) * 0.5)
    # mmcv.imrotate convention: a positive angle turns clockwise
    return _warp(sample, rotation_matrix_2d(center, -angle, 1.0))


def shear(rng, sample: Sample, x_range=(-30, 30), y_range=(-30, 30)
          ) -> Sample:
    # the reference applies shear_x then shear_y (its OneOf entry is a
    # 2-transform list); magnitudes in degrees -> tan
    for rg, horiz in ((x_range, True), (y_range, False)):
        deg = rng.random() * (rg[1] - rg[0]) + rg[0]
        m = np.tan(deg * np.pi / 180)
        t = (np.array([[1, m, 0], [0, 1, 0]], np.float64) if horiz
             else np.array([[1, 0, 0], [m, 1, 0]], np.float64))
        sample = _warp(sample, t)
    return sample


def apply_geometric_op(rng, sample: Sample) -> Sample:
    """OneOf: translate_x | translate_y | rotate | shear (x then y)."""
    op = int(rng.integers(4))
    if op == 0:
        return translate(rng, sample, x_range=(-0.1, 0.1))
    if op == 1:
        return translate(rng, sample, y_range=(-0.1, 0.1))
    if op == 2:
        return rotate(rng, sample)
    return shear(rng, sample)


def rand_erase(rng, sample: Sample, n_range=(1, 5), size=(0.0, 0.2)
               ) -> Sample:
    """1 to 4 patches of (r * H, r * W), one ratio r per patch, filled with
    FILL."""
    h, w = sample.img.shape[:2]
    img = sample.img.copy()
    n = int(rng.integers(n_range[0], n_range[1]))
    for _ in range(n):
        ratio = rng.random() * (size[1] - size[0]) + size[0]
        ph, pw = int(ratio * h), int(ratio * w)
        if w - pw <= 0 or h - ph <= 0:
            continue
        px = int(rng.integers(0, w - pw))
        py = int(rng.integers(0, h - ph))
        img[py:py + ph, px:px + pw] = FILL
    return replace(sample, img=img)


# ---------------------------------------------------------------- pipelines

def weak_augment(rng, sample: Sample, scales=COCO_SCALES) -> Sample:
    return rand_flip(rng, rand_resize(rng, sample, scales))


def sup_augment(rng, sample: Sample, scales=COCO_SCALES) -> Sample:
    return apply_color_op(rng, weak_augment(rng, sample, scales))


def strong_augment(rng, sample: Sample, scales=COCO_SCALES) -> Sample:
    s = weak_augment(rng, sample, scales)
    # ShuffledSequential over [colour, geometric]
    if rng.random() < 0.5:
        s = apply_geometric_op(rng, apply_color_op(rng, s))
    else:
        s = apply_color_op(rng, apply_geometric_op(rng, s))
    return rand_erase(rng, s)


def test_resize(sample: Sample, scale=TEST_SCALE) -> Sample:
    return resize(sample, scale)


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8 RGB -> float32 normalized (reference img_norm_cfg,
    `base_dino_detr_ssod_coco.py:4-5`)."""
    return (img.astype(np.float32) - IMG_MEAN) / IMG_STD
