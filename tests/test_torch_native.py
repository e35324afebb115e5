"""The port's host library (`semi_detr_tpu_torch/native/`) against its numpy
plain versions, the JAX package's native decoder and resize, and cv2.

* Bit for bit (max abs 0): the resize (to COCO scales, against the numpy
  mirror and `semi_detr_tpu.native.resize_bilinear`), the warp (translate,
  rotate +-30, shear), every pixel function of the colour ops and all 81
  op x magnitude cases, the PNG row filters and decoder (against
  `image_io`), JPEG decode (against the JAX decoder and cv2.imread) and
  encode (cv2.imwrite's bytes), on seeded images of odd sizes; the
  library's own sequential and progressive decoders (the card's route)
  against libjpeg on the fixtures and on cv2- and Pillow-written streams
  of every chroma layout, gray, restart intervals 1 and 7.
* Within tolerance: the resize within one grey level of cv2.resize.
* Behaviour: damaged, lossless and unknown files raise naming the file; the
  prefetch loader (the JAX test's cases, `next()` with nothing
  outstanding); the eval reader; `save_result` and the image demo.
"""
import io
import json
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from semi_detr_tpu_torch import native
from semi_detr_tpu_torch.data import augment as A
from semi_detr_tpu_torch.data import image_io, pipeline
from semi_detr_tpu_torch.data.coco import CocoDataset
from semi_detr_tpu_torch.data.pipeline import (make_test_batch,
                                               prefetched_test_batches)
from semi_detr_tpu_torch.data.synthetic import write_synthetic_coco

SIZES = ((61, 83), (480, 640))

from format_writers import jax_native, jax_native_fixture

# the JAX package's host library, loaded under the shared lock
jax_native_loaded = jax_native_fixture()


def _picture(h, w, seed, channels=3):
    """Noise over gradients: every tap and filter has work to do."""
    rs = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    base = (2 * xs + 3 * ys)[..., None] + 50 * np.arange(channels)
    return ((base + rs.randint(0, 60, (h, w, channels))) % 256).astype(
        np.uint8)


def fixture_picture(h, w, seed):
    """The picture of the committed JPEG fixtures: gradients, two discs
    and a little noise (smooth areas and sharp colour edges)."""
    rs = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([xs * 255 / w, ys * 255 / h,
                    (xs + ys) * 127 / (h + w) + 64], -1)
    for cx, cy, r, col in ((0.3, 0.4, 0.2, (230, 40, 40)),
                           (0.7, 0.6, 0.25, (30, 200, 90))):
        img[(xs - cx * w) ** 2 + (ys - cy * h) ** 2
            < (r * min(h, w)) ** 2] = col
    img = img + rs.randint(-8, 9, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv2_rgb(buf):
    return cv2.imdecode(np.frombuffer(buf, np.uint8),
                        cv2.IMREAD_COLOR)[..., ::-1]


def test_built_with_png_and_a_jpeg_decoder():
    found = native.probe()
    assert found["zlib"] and found["route"] in ("libjpeg", "nvjpeg")
    dec = native.decoders()
    assert set(dec) == {"png", "jpeg", "jpeg_sequential", "jpeg_progressive",
                        "jpeg_sequential_arithmetic",
                        "jpeg_progressive_arithmetic", "jpeg_lossless",
                        "jpeg_colour", "jpeg_other", "bmp", "pnm", "pam",
                        "tiff", "webp", "gif", "sun_raster", "pfm", "hdr",
                        "jpeg2000", "avif"}
    assert dec["jpeg"] == dec["jpeg_other"] == found["route"]
    # either build decodes every kind libjpeg decodes in the library itself,
    # libjpeg-exact
    for kind, route in native.ROUTES.items():
        assert dec["jpeg_" + kind.replace(" ", "_")] == route


# ---------------------------------------------------------------- resize

@pytest.mark.parametrize("scale", [A.COCO_SCALES[0], A.COCO_SCALES[5],
                                   A.COCO_SCALES[10], (24, 40)])
@pytest.mark.parametrize("hw", SIZES)
def test_resize_bit_equal(hw, scale):
    img = _picture(*hw, seed=hw[0])
    nh, nw, _ = A.rescale_size(*hw, scale)
    got = native.resize_bilinear(img, nh, nw)
    np.testing.assert_array_equal(got, A.resize_bilinear_np(img, nh, nw))
    np.testing.assert_array_equal(got, jax_native.resize_bilinear(
        img, nh, nw))
    diff = np.abs(got.astype(int) - cv2.resize(
        img, (nw, nh), interpolation=cv2.INTER_LINEAR).astype(int))
    print(f"{hw} -> {(nh, nw)}: {(diff > 0).mean():.4f} of the values "
          "differ from cv2.resize by one grey level")
    assert diff.max() <= 1


def test_resize_any_channel_count():
    img = _picture(17, 23, 3, channels=4)
    np.testing.assert_array_equal(native.resize_bilinear(img, 40, 9),
                                  A.resize_bilinear_np(img, 40, 9))
    np.testing.assert_array_equal(native.resize_bilinear(img, 17, 23), img)


# ---------------------------------------------------------------- warp

def _warps(h, w):
    c = ((w - 1) * 0.5, (h - 1) * 0.5)
    t = np.tan(np.radians(30))
    return {"translate_x": np.array([[1, 0, 0.1 * w], [0, 1, 0]]),
            "translate_y": np.array([[1, 0, 0], [0, 1, -0.07 * h]]),
            "rotate_+30": A.rotation_matrix_2d(c, 30.0, 1.0),
            "rotate_-30": A.rotation_matrix_2d(c, -30.0, 1.0),
            "shear_x": np.array([[1, t, 0], [0, 1, 0]]),
            "shear_y": np.array([[1, 0, 0], [-t, 1, 0]])}


@pytest.mark.parametrize("op", sorted(_warps(1, 1)))
@pytest.mark.parametrize("hw", SIZES)
def test_warp_bit_equal(hw, op):
    img = _picture(*hw, seed=7)
    inv = A._inverse_affine(_warps(*hw)[op]).astype(np.float32)
    got = native.warp_affine(img, inv, A.FILL)
    np.testing.assert_array_equal(got, A._warp_affine_np(img, inv, A.FILL))
    assert (got == A.FILL).any()                  # taps read the fill ring


# ---------------------------------------------------------------- colour

class _Draws:
    """A generator stand-in that returns (op, magnitude) to apply_color_op."""

    def __init__(self, op, mag):
        self.values = [op, mag]

    def integers(self, *args):
        return self.values.pop(0)


@pytest.mark.parametrize("mag", range(1, 10))
@pytest.mark.parametrize("op", range(9))
def test_colour_op_bit_equal(monkeypatch, op, mag):
    img = _picture(61, 83, seed=op)
    got = A.apply_color_op(_Draws(op, mag), A.make_sample(img)).img
    monkeypatch.setattr(A, "px", A.NumpyPixels)
    ref = A.apply_color_op(_Draws(op, mag), A.make_sample(img)).img
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, ref)


def _pixel_cases():
    img, tiny = _picture(45, 61, 1), _picture(2, 5, 2)
    luts = np.random.RandomState(0).randint(0, 256, (3, 256)).astype(
        np.uint8)
    cases = [("histogram", (img,)), ("apply_lut", (img, luts)),
             ("gray", (img,)), ("smooth", (img,)), ("smooth", (tiny,)),
             ("solarize", (img, 128)), ("posterize", (img, 0xF0))]
    for deg in (A._smooth(img), A._gray(img)[..., None],
                np.full((1, 1, 1), 97, np.uint8)):
        for factor in (0.0, 0.37, 1.0, 1.9):
            cases.append(("blend", (deg, img, factor)))
    return cases


@pytest.mark.parametrize("case", range(len(_pixel_cases())))
def test_pixel_function_bit_equal(case):
    name, args = _pixel_cases()[case]
    got = getattr(native, name)(*args)
    ref = getattr(A.NumpyPixels, name)(*args)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_strong_view_equal_through_either_pixels(monkeypatch):
    img = _picture(120, 160, 4)
    scales = ((96, 128), (128, 170))
    got = [A.strong_augment(np.random.default_rng(s), A.make_sample(img),
                            scales).img for s in range(6)]
    monkeypatch.setattr(A, "px", A.NumpyPixels)
    for s, g in enumerate(got):
        np.testing.assert_array_equal(g, A.strong_augment(
            np.random.default_rng(s), A.make_sample(img), scales).img)


# ---------------------------------------------------------------- PNG

def _raw_rows(rng, h, row_bytes, filters):
    rows = rng.randint(0, 256, (h, row_bytes + 1)).astype(np.uint8)
    rows[:, 0] = [filters[y % len(filters)] for y in range(h)]
    return rows.tobytes()


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_png_unfilter_bit_equal(bpp):
    rng = np.random.RandomState(bpp)
    raw = _raw_rows(rng, 9, 7 * bpp, [0, 1, 2, 3, 4, 4, 3])
    np.testing.assert_array_equal(
        native.png_unfilter(raw, 9, 7 * bpp, bpp),
        image_io._unfilter(raw, 9, 7 * bpp, bpp))
    bad = bytearray(raw)
    bad[(7 * bpp + 1) * 5] = 9
    with pytest.raises(ValueError, match="row 5: unknown filter type 9"):
        native.png_unfilter(bytes(bad), 9, 7 * bpp, bpp)


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba", "palette"])
@pytest.mark.parametrize("flt", ["adaptive", "average", "paeth"])
def test_png_decode_bit_equal(kind, flt):
    img = _picture(37, 53, seed=len(kind), channels={"gray": 1, "rgb": 3,
                                                     "rgba": 4}.get(kind, 3))
    if kind == "palette":          # cv2 writes no palette PNG; Pillow does
        buf = io.BytesIO()
        Image.fromarray(img).quantize(60).save(buf, "PNG")
        buf = buf.getvalue()
    else:
        flag = {"adaptive": cv2.IMWRITE_PNG_ALL_FILTERS,
                "average": cv2.IMWRITE_PNG_FILTER_AVG,
                "paeth": cv2.IMWRITE_PNG_FILTER_PAETH}[flt]
        ok, enc = cv2.imencode(".png", img if kind != "gray" else img[..., 0],
                               [cv2.IMWRITE_PNG_FILTER, flag])
        buf = enc.tobytes()
    got = native.decode_image(buf)
    np.testing.assert_array_equal(got, image_io.decode_png(buf))
    np.testing.assert_array_equal(got, _cv2_rgb(buf))


# ---------------------------------------------------------------- JPEG

def _upsample_np(plane, h, w, hs, vs):
    """numpy version of libjpeg-turbo's fancy upsampling (jdsample.c):
    3/4 nearer + 1/4 further sample per dimension with its biases, edges
    repeated, plain replication for 2h planes at most 2 samples wide."""
    p = plane.astype(np.int64)
    ch, cw = p.shape
    if hs == 2 and cw <= 2:
        return np.repeat(np.repeat(p, vs, 0), 2, 1)[:h, :w]
    if vs == 2:
        near = np.repeat(p, 2, 0)
        above = np.concatenate([p[:1], p[:-1]])
        below = np.concatenate([p[1:], p[-1:]])
        far = np.stack([above, below], 1).reshape(2 * ch, cw)
        cs = near * 3 + far
        if hs == 1:
            bias = np.tile([1, 2], ch)[:, None]
            return ((cs + bias) >> 2)[:h, :w]
        left = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
        even = (cs * 3 + left + 8) >> 4
        odd = (cs * 3 + right + 7) >> 4
        even[:, 0], odd[:, -1] = (cs[:, 0] * 4 + 8) >> 4, \
            (cs[:, -1] * 4 + 7) >> 4
        return np.stack([even, odd], 2).reshape(2 * ch, 2 * cw)[:h, :w]
    if hs == 1:
        return p[:h, :w]
    left = np.concatenate([p[:, :1], p[:, :-1]], 1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], 1)
    even, odd = (p * 3 + left + 1) >> 2, (p * 3 + right + 2) >> 2
    even[:, 0], odd[:, -1] = p[:, 0], p[:, -1]
    return np.stack([even, odd], 2).reshape(ch, 2 * cw)[:h, :w]


@pytest.mark.parametrize("factors", [(1, 1), (2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("hw", [(37, 51), (9, 3), (1, 1)])
def test_ycc_to_rgb_is_libjpegs_output_stage(hw, factors):
    """The nvJPEG route's finish: the upsampling against its numpy
    version, the colour tables against libjpeg (Pillow's YCbCr decode of
    the same stream, fully upsampled, gives libjpeg's RGB)."""
    h, w = hw
    hs, vs = factors
    rs = np.random.RandomState(h * w + hs)
    y = rs.randint(0, 256, (h, w)).astype(np.uint8)
    cb, cr = (rs.randint(0, 256, (-(-h // vs), -(-w // hs))).astype(
        np.uint8) for _ in range(2))
    got = native.ycc_to_rgb(y, cb, cr, hs, vs)
    ups = [_upsample_np(p, h, w, hs, vs).astype(np.uint8) for p in (cb, cr)]
    np.testing.assert_array_equal(got, native.ycc_to_rgb(y, *ups, 1, 1))
    img = _picture(h, w, seed=h)
    sf = {(1, 1): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
          (2, 1): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
          (1, 2): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
          (2, 2): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}[factors]
    buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                     sf])[1].tobytes()
    im = Image.open(io.BytesIO(buf))
    im.draft("YCbCr", im.size)
    ycc = np.asarray(im)
    np.testing.assert_array_equal(native.ycc_to_rgb(
        ycc[..., 0], ycc[..., 1], ycc[..., 2], 1, 1), native.decode_image(buf))


@pytest.mark.parametrize("kind", ["colour_420", "gray", "progressive",
                                  "colour_444"])
def test_jpeg_decode_equals_jax_and_cv2(kind):
    img = _picture(53, 77, seed=5)
    params = {"progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
              "colour_444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]}
    src = img[..., 0] if kind == "gray" else img
    buf = cv2.imencode(".jpg", src, params.get(kind, []))[1].tobytes()
    got = native.decode_image(buf)
    assert got.shape == (53, 77, 3)
    np.testing.assert_array_equal(got, jax_native.decode_image(buf))
    np.testing.assert_array_equal(got, _cv2_rgb(buf))


@pytest.mark.parametrize("name", ["colour_420", "gray", "progressive_420"])
def test_committed_fixtures(name):
    """The fixtures are cv2.imwrite's files of fixture_picture, each with
    its libjpeg decode as PNG; the library reads both to those pixels."""
    jpg = os.path.join(native.FIXTURES, f"{name}.jpg")
    with open(jpg, "rb") as f:
        buf = f.read()
    pic = fixture_picture(53, 67, 1).mean(-1).astype(np.uint8) \
        if name == "gray" else fixture_picture(75, 101, 0)
    src = pic[..., ::-1] if pic.ndim == 3 else pic
    params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1] if "progressive" in name \
        else []
    assert buf == cv2.imencode(".jpg", src, params)[1].tobytes()
    ref = image_io.read_image(os.path.join(native.FIXTURES, f"{name}.png"))
    np.testing.assert_array_equal(image_io.read_image(jpg), ref)
    np.testing.assert_array_equal(_cv2_rgb(buf), ref)


def test_jpeg_encode_is_cv2_imwrite(tmp_path):
    img = _picture(41, 59, 6)
    buf = native.encode_jpeg(img)
    assert buf == cv2.imencode(".jpg", img[..., ::-1])[1].tobytes()
    path = image_io.write_image(str(tmp_path / "a.jpeg"), img)
    np.testing.assert_array_equal(image_io.read_image(path), _cv2_rgb(buf))
    path = image_io.write_image(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(image_io.read_image(path), img)
    with pytest.raises(ValueError, match="no encoder for .xyz"):
        image_io.write_image(str(tmp_path / "a.xyz"), img)


def host_picture(h, w, seed):
    """chip_smoke.host_picture: seeded noise over gradients."""
    rs = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    base = (xs // 3 + ys // 2)[..., None] + 60 * np.arange(3)
    return ((base + rs.randint(0, 40, (h, w, 3))) % 256).astype(np.uint8)


def test_cv2_round_trip_reference():
    """The committed reference that chip_smoke phase 7a holds the card's
    JPEG encode + decode to: cv2's quality-95 round trip of each picture.
    The library's own round trip (cv2.imwrite's bytes here) reads the
    same."""
    with open(os.path.join(native.FIXTURES, "cv2_q95_roundtrip.json")) as f:
        ref = json.load(f)["pictures"]
    pics = {n: image_io.read_image(os.path.join(native.FIXTURES, n + ".png"))
            for n in ("colour_420", "gray")}
    pics["noise_480x640"] = host_picture(480, 640, 0)
    assert set(ref) == set(pics)
    for name, img in pics.items():
        for buf in (cv2.imencode(".jpg", img[..., ::-1])[1].tobytes(),
                    native.encode_jpeg(img)):
            diff = np.abs(_cv2_rgb(buf).astype(int) - img.astype(int))
            assert int(diff.max()) == ref[name]["max_abs"], name
            assert float(diff.mean()) == pytest.approx(
                ref[name]["mean_abs"], rel=1e-12), name


def rgb_to_ycc420_np(img):
    """libjpeg-turbo's jccolor.c (rgb_ycc_convert) and jcsample.c
    (h2v2_downsample, edges repeated), in numpy."""
    def fix(x):
        return int(x * 65536 + 0.5)
    r, g, b = (img[..., k].astype(np.int64) for k in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + offset
          + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + offset
          + half - 1) >> 16
    h, w = y.shape
    out = [y.astype(np.uint8)]
    for c in (cb, cr):
        c = np.pad(c, ((0, h % 2), (0, w % 2)), mode="edge")
        s = c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]
        bias = 1 + np.arange(s.shape[1]) % 2          # 1, 2, 1, 2, ...
        out.append(((s + bias) >> 2).astype(np.uint8))
    return out


@pytest.mark.parametrize("hw", [(61, 83), (40, 56), (1, 1), (2, 3)])
def test_rgb_to_ycc420_bit_equal(hw):
    img = _picture(*hw, seed=hw[1])
    for got, ref in zip(native.rgb_to_ycc420(img), rgb_to_ycc420_np(img)):
        np.testing.assert_array_equal(got, ref)


def test_rgb_to_ycc420_is_libjpegs_colour_conversion():
    """On a picture constant over each 2x2 block (where the downsampling
    changes nothing), the planes repeated to full size and handed to
    libjpeg as YCbCr encode to cv2.imwrite's pixels of the RGB picture."""
    img = np.repeat(np.repeat(_picture(23, 31, 5), 2, 0), 2, 1)
    y, cb, cr = native.rgb_to_ycc420(img)
    full = np.stack([y, np.repeat(np.repeat(cb, 2, 0), 2, 1),
                     np.repeat(np.repeat(cr, 2, 0), 2, 1)], -1)
    buf = io.BytesIO()
    Image.fromarray(full, "YCbCr").save(buf, "JPEG", quality=95,
                                        subsampling=2)
    np.testing.assert_array_equal(
        _cv2_rgb(buf.getvalue()),
        _cv2_rgb(cv2.imencode(".jpg", img[..., ::-1])[1].tobytes()))


def _valid_jpegs():
    img = _picture(45, 67, 3)
    out = {}
    for name, params in {
            "q95": [], "q5": [cv2.IMWRITE_JPEG_QUALITY, 5],
            "q100": [cv2.IMWRITE_JPEG_QUALITY, 100],
            "optimized": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
            "progressive": [cv2.IMWRITE_JPEG_PROGRESSIVE, 1],
            "rst1": [cv2.IMWRITE_JPEG_RST_INTERVAL, 1],
            "rst7": [cv2.IMWRITE_JPEG_RST_INTERVAL, 7],
            "444": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
            "422": [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]}.items():
        out["cv2_" + name] = cv2.imencode(".jpg", img, params)[1].tobytes()
    out["cv2_gray"] = cv2.imencode(".jpg", img[..., 0])[1].tobytes()
    for sub in (0, 1, 2):
        for extra in ({}, {"optimize": True}, {"progressive": True}):
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "JPEG", quality=80,
                                      subsampling=sub, **extra)
            out[f"pil_{sub}_{'_'.join(extra) or 'plain'}"] = buf.getvalue()
    out["library"] = native.encode_jpeg(img)
    # baseline, one component per scan (libjpeg with a scan script of three
    # sequential scans) and a restart interval of 5 MCUs
    with open(os.path.join(native.FIXTURES, "noninterleaved.jpg"), "rb") as f:
        out["noninterleaved"] = f.read()
    return out


# ------------------------------------------- the sequential JPEG decoder

@pytest.mark.parametrize("name", ["colour_420", "gray", "noninterleaved"])
def test_sequential_decoder_on_the_fixtures(name):
    """The library's own decoder (the card's route for these streams) gives
    libjpeg's pixels to the bit: the committed PNGs where there are, and
    libjpeg's decode here."""
    with open(os.path.join(native.FIXTURES, f"{name}.jpg"), "rb") as f:
        buf = f.read()
    assert native.jpeg_host_kind(buf) == "sequential"
    got = native.decode_jpeg_sequential(buf)
    np.testing.assert_array_equal(got, native.decode_jpeg_backend(buf))
    np.testing.assert_array_equal(got, _cv2_rgb(buf))
    png = os.path.join(native.FIXTURES, f"{name}.png")
    if os.path.exists(png):
        np.testing.assert_array_equal(got, image_io.read_image(png))


_SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


@pytest.mark.parametrize("rst", [0, 1, 7])
@pytest.mark.parametrize("kind", ["444", "422", "420", "440", "gray"])
def test_sequential_decoder_equals_libjpeg(kind, rst):
    """cv2-written streams of every chroma layout, gray, odd and tiny
    sizes, qualities 5 to 100 (large coefficients) and restart intervals
    1 and 7: bit-equal to libjpeg's decode (the back end here, and
    cv2.imread)."""
    for (h, w), q in zip(((1, 1), (7, 9), (17, 33), (61, 83), (64, 48)),
                         (5, 50, 75, 95, 100)):
        img = _picture(h, w, seed=h + q)
        src = img[..., 0] if kind == "gray" else img
        params = [cv2.IMWRITE_JPEG_QUALITY, q,
                  cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
        if kind != "gray":
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, _SAMPLING[kind]]
        buf = cv2.imencode(".jpg", src, params)[1].tobytes()
        assert native.jpeg_host_kind(buf) == "sequential"
        got = native.decode_jpeg_sequential(buf)
        np.testing.assert_array_equal(got, native.decode_jpeg_backend(buf))
        np.testing.assert_array_equal(got, _cv2_rgb(buf))


def test_sequential_decoder_on_other_writers():
    """Pillow's streams (4:4:4, 4:2:2, 4:2:0, optimized tables) and the
    library's own encode."""
    for name, buf in _valid_jpegs().items():
        if "progressive" in name:
            continue
        assert native.jpeg_host_kind(buf) == "sequential", name
        np.testing.assert_array_equal(native.decode_jpeg_sequential(buf),
                                      _cv2_rgb(buf), err_msg=name)


def test_sequential_decoder_raises_on_damage():
    """The decoder checks as it decodes: every fault jpeg_check finds
    raises ImageDecodeError with the same message."""
    with open(os.path.join(native.FIXTURES, "colour_420.jpg"), "rb") as f:
        buf = f.read()
    mid = _entropy_middle(buf)
    rst = cv2.imencode(".jpg", _picture(40, 56, 2),
                       [cv2.IMWRITE_JPEG_RST_INTERVAL, 1])[1].tobytes()
    marks = [i for i in range(len(rst) - 1)
             if rst[i] == 0xFF and 0xD0 <= rst[i + 1] <= 0xD7]
    for bad in (buf[:len(buf) // 2], buf[:len(buf) - 2],
                buf[:mid] + b"\xff\x00" * 8 + buf[mid + 16:],
                rst[:marks[2]] + rst[marks[2] + 2:]):
        fault = native.jpeg_check(bad)
        assert fault is not None
        with pytest.raises(native.ImageDecodeError) as err:
            native.decode_jpeg_sequential(bad)
        assert fault in str(err.value)


def test_progressive_stream_is_routed_not_decoded():
    """A progressive stream is not the sequential decoder's, which refuses
    it rather than decode it: it takes the progressive decoder's route
    (`decoders()["jpeg_progressive"]`). A CMYK stream is the sequential
    decoder's, which gives cv2.imread's pixels (the JAX loader's fallback
    for it)."""
    img = _picture(33, 47, 4)
    buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[
        1].tobytes()
    assert native.jpeg_host_kind(buf) == "progressive"
    with pytest.raises(native.ImageDecodeError, match="not a sequential"):
        native.decode_jpeg_sequential(buf)
    np.testing.assert_array_equal(native.decode_jpeg_progressive(buf),
                                  _cv2_rgb(buf))
    np.testing.assert_array_equal(native.decode_image(buf), _cv2_rgb(buf))
    assert set(native.decoders()) >= {"jpeg_sequential", "jpeg_progressive",
                                      "jpeg_other"}
    cmyk = io.BytesIO()
    Image.new("CMYK", (20, 10), (10, 20, 30, 40)).save(cmyk, "JPEG")
    cmyk = cmyk.getvalue()
    assert native.jpeg_host_kind(cmyk) == "sequential"
    assert native.jpeg_colour(cmyk) == "CMYK"
    np.testing.assert_array_equal(native.decode_jpeg_sequential(cmyk),
                                  _cv2_rgb(cmyk))
    np.testing.assert_array_equal(native.decode_image(cmyk), _cv2_rgb(cmyk))
    seq = cv2.imencode(".jpg", img)[1].tobytes()
    with pytest.raises(native.ImageDecodeError, match="not a progressive"):
        native.decode_jpeg_progressive(seq)


# ------------------------------------------ the progressive JPEG decoder

def _scans(buf):
    """(start of each SOS marker, start of its entropy-coded data)."""
    out, i = [], 0
    while (i := buf.find(b"\xff\xda", i)) >= 0:
        out.append((i, i + 2 + (buf[i + 2] << 8 | buf[i + 3])))
        i += 2
    return out


@pytest.mark.parametrize("rst", [0, 1, 7])
@pytest.mark.parametrize("kind", ["444", "422", "420", "440", "gray"])
def test_progressive_decoder_equals_libjpeg(kind, rst):
    """cv2's progressive streams (libjpeg's scan script: DC first and
    refinement scans, AC first bands with end-of-band runs, AC refinements
    with correction bits) of every chroma layout, gray, odd and tiny
    sizes, qualities 5 to 100 and restart intervals 1 and 7: bit-equal to
    libjpeg's decode (the back end here, and cv2.imread)."""
    for (h, w), q in zip(((1, 1), (7, 9), (17, 33), (61, 83), (64, 48)),
                         (5, 50, 75, 95, 100)):
        img = _picture(h, w, seed=h + q)
        src = img[..., 0] if kind == "gray" else img
        params = [cv2.IMWRITE_JPEG_QUALITY, q,
                  cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
                  cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
        if kind != "gray":
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, _SAMPLING[kind]]
        buf = cv2.imencode(".jpg", src, params)[1].tobytes()
        assert len(_scans(buf)) > 2
        assert native.jpeg_host_kind(buf) == "progressive"
        got = native.decode_jpeg_progressive(buf)
        np.testing.assert_array_equal(got, native.decode_jpeg_backend(buf))
        np.testing.assert_array_equal(got, _cv2_rgb(buf))


@pytest.mark.parametrize("quality", [10, 75, 95])
def test_progressive_decoder_on_other_writers(quality):
    """Pillow's progressive streams (4:4:4, 4:2:2, 4:2:0, optimized
    tables, gray) and the committed fixture."""
    for sub in (0, 1, 2):
        for hw in ((1, 1), (13, 29), (61, 83)):
            for extra in ({}, {"optimize": True}):
                buf = io.BytesIO()
                Image.fromarray(_picture(*hw, sub + quality)).save(
                    buf, "JPEG", quality=quality, subsampling=sub,
                    progressive=True, **extra)
                buf = buf.getvalue()
                assert native.jpeg_host_kind(buf) == "progressive"
                np.testing.assert_array_equal(
                    native.decode_jpeg_progressive(buf), _cv2_rgb(buf),
                    err_msg=f"{sub} {hw} {extra}")
    buf = io.BytesIO()
    Image.fromarray(_picture(40, 50, 1)[..., 0]).save(
        buf, "JPEG", quality=quality, progressive=True)
    np.testing.assert_array_equal(
        native.decode_jpeg_progressive(buf.getvalue()),
        _cv2_rgb(buf.getvalue()))
    with open(os.path.join(native.FIXTURES, "progressive_420.jpg"),
              "rb") as f:
        buf = f.read()
    np.testing.assert_array_equal(
        native.decode_jpeg_progressive(buf), image_io.read_image(
            os.path.join(native.FIXTURES, "progressive_420.png")))


def test_progressive_decoder_raises_on_damage():
    """Truncated data, a bad Huffman code in the DC scan and restart
    markers out of order raise ImageDecodeError; the check finds the
    truncation first."""
    buf = cv2.imencode(".jpg", _picture(96, 128, 5),
                       [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    (_, start), (nxt, _) = _scans(buf)[:2]
    mid = (start + nxt) // 2 - 8
    assert buf.find(b"\xff", mid, mid + 16) < 0
    ones = buf[:mid] + b"\xff\x00" * 8 + buf[mid + 16:]
    rst = cv2.imencode(".jpg", _picture(40, 56, 2),
                       [cv2.IMWRITE_JPEG_RST_INTERVAL, 1,
                        cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    marks = [i for i in range(len(rst) - 1)
             if rst[i] == 0xFF and 0xD0 <= rst[i + 1] <= 0xD7]
    for bad, fault in ((buf[:len(buf) // 2], "Premature end"),
                       (buf[:len(buf) - 2], "Premature end"),
                       (ones, "bad Huffman code"),
                       (rst[:marks[2]] + rst[marks[2] + 2:],
                        "restart marker")):
        with pytest.raises(native.ImageDecodeError, match=fault):
            native.decode_jpeg_progressive(bad)
    for bad in (buf[:len(buf) // 2], buf[:len(buf) - 2]):
        assert "Premature end" in native.jpeg_check(bad)


def test_incomplete_progressive_script_is_refused():
    """A script that ends before the last bit of the DC or the first AC
    coefficients (the first scans of a stream, then EOI) is one libjpeg
    decodes with block smoothing: the progressive decoder takes it and
    gives libjpeg-turbo 2.1's smoothed pixels (the JAX package's decoder;
    the libjpeg-turbo that cv2 bundles smooths otherwise), on either
    route."""
    buf = cv2.imencode(".jpg", _picture(48, 64, 7),
                       [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    scans = _scans(buf)
    for k in (1, 3, len(scans) - 1):
        cut = buf[:scans[k][0]] + b"\xff\xd9"
        assert native.jpeg_check(cut) is None
        assert native.jpeg_host_kind(cut) == "progressive", k
        ref = jax_native.decode_image(cut)
        np.testing.assert_array_equal(native.decode_jpeg_progressive(cut),
                                      ref)
        np.testing.assert_array_equal(native.decode_image(cut), ref)


def test_jpeg_check_passes_whole_streams():
    streams = _valid_jpegs()
    assert streams["noninterleaved"].count(b"\xff\xda") == 3
    for name, buf in streams.items():
        assert native.jpeg_check(buf) is None, name
        assert native.jpeg_check(buf + b"trailing bytes") is None, name
        np.testing.assert_array_equal(native.decode_image(buf),
                                      _cv2_rgb(buf))


def _entropy_middle(buf):
    """The middle of the first scan's entropy-coded data."""
    sos = buf.index(b"\xff\xda")
    start = sos + 2 + (buf[sos + 2] << 8 | buf[sos + 3])
    return (start + len(buf) - 2) // 2


def test_jpeg_check_finds_damage():
    streams = _valid_jpegs()
    for name in ("colour_420", "gray"):
        with open(os.path.join(native.FIXTURES, f"{name}.jpg"), "rb") as f:
            streams[name] = f.read()
    for name, buf in streams.items():
        for cut in (len(buf) - 2, len(buf) // 2, 30):
            assert "Premature end" in native.jpeg_check(buf[:cut]), name
        if "progressive" in name:           # walked marker by marker only
            continue
        mid = _entropy_middle(buf)
        # 64 one bits: no Huffman code is all ones
        ones = buf[:mid] + b"\xff\x00" * 8 + buf[mid + 16:]
        assert native.jpeg_check(ones) == "JPEG: damaged data: bad Huffman " \
            "code", name
    # restart markers swapped, and one left out
    buf = streams["cv2_rst1"]
    rst = [i for i in range(len(buf) - 1)
           if buf[i] == 0xFF and 0xD0 <= buf[i + 1] <= 0xD7]
    swapped = bytearray(buf)
    swapped[rst[1] + 1], swapped[rst[2] + 1] = buf[rst[2] + 1], buf[rst[1] + 1]
    dropped = buf[:rst[3]] + buf[rst[3] + 2:]
    for bad in (bytes(swapped), dropped):
        assert "restart marker" in native.jpeg_check(bad)


def test_bad_files_raise_naming_the_file(tmp_path):
    good = cv2.imencode(".jpg", _picture(30, 40, 8))[1].tobytes()
    # lossless (SOF3), which libjpeg-turbo 2.1 refuses
    sof = good.index(b"\xff\xc0")
    lossless = good[:sof + 1] + b"\xc3" + good[sof + 2:]
    fixtures = {}
    for name in ("colour_420", "gray"):
        with open(os.path.join(native.FIXTURES, f"{name}.jpg"), "rb") as f:
            buf = f.read()
        mid = _entropy_middle(buf)
        fixtures[f"{name}_bad_code.jpg"] = (
            buf[:mid] + b"\xff\x00" * 8 + buf[mid + 16:], "bad Huffman code")
    cases = {**fixtures,
             "truncated.jpg": (good[:len(good) // 2], "Premature end"),
             "lossless.jpg": (lossless, "SOF type 0xc3"),
             "header_only.jpg": (good[:20], "JPEG"),
             "text.png": (b"not an image at all", "neither a JPEG nor"),
             "crc.png": (bytes(bytearray(image_io.encode_png(
                 _picture(9, 9, 1)))[:40]) + b"\0" * 40, "PNG")}
    for name, (buf, what) in cases.items():
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(buf)
        with pytest.raises(native.ImageDecodeError) as err:
            image_io.read_image(path)
        assert name in str(err.value) and what in str(err.value), err.value


# ---------------------------------------------------------------- loader

def test_prefetch_loader(tmp_path):
    img = _picture(50, 70, 9)
    path = str(tmp_path / "a.jpg")
    image_io.write_image(path, img)
    decoded = image_io.read_image(path)
    pl = native.PrefetchLoader(2)
    for i in range(3):
        pl.submit(i, path, (30, 40))
    pl.submit(9, str(tmp_path / "missing.jpg"))
    pl.submit(4, path)
    got, errors = {}, []
    while pl.outstanding:
        try:
            r = pl.next()
            got[r.index] = r
        except native.ImageDecodeError as e:
            errors.append(str(e))
    assert sorted(got) == [0, 1, 2, 4]
    for i in range(3):
        np.testing.assert_array_equal(
            got[i].image, native.resize_bilinear(decoded, 30, 40))
        assert got[i].src_hw == (50, 70)
    np.testing.assert_array_equal(got[4].image, decoded)
    assert len(errors) == 1 and "missing.jpg" in errors[0]
    with pytest.raises(RuntimeError, match="no task outstanding"):
        pl.next()
    pl.close()
    with pytest.raises(RuntimeError, match="closed"):
        pl.submit(0, path)


def test_prefetched_test_batches_equal_make_test_batch(tmp_path,
                                                      monkeypatch):
    paths, img_dir = write_synthetic_coco(str(tmp_path), n=7, hw=(45, 61),
                                          seed=2, max_boxes=3)
    ds = CocoDataset(paths, img_dir, classes=("person",), test_mode=True)
    groups = [([0, 1, 2], (72, 96)), ([3, 4, 5], (72, 96)),
              ([6, 6, 6], (72, 96))]
    # 2 images in flight beyond a batch: results arrive out of order and
    # wait for their batch
    monkeypatch.setattr(pipeline, "PREFETCH_AHEAD", 2)
    for scale in ((30, 40), (64, 96)):
        got = list(prefetched_test_batches(ds, groups, scale=scale))
        assert len(got) == len(groups)
        for g, (idx, bucket) in zip(got, groups):
            ref = make_test_batch(ds, idx, bucket, scale=scale)
            assert set(g) == set(ref)
            for k in ("images", "img_hw", "tmat", "image_ids",
                      "scale_factors"):
                np.testing.assert_array_equal(g[k], ref[k], err_msg=k)
            for k in ref["gt"]:
                np.testing.assert_array_equal(g["gt"][k], ref["gt"][k])
    ds.records[1].height += 1                   # the file says otherwise
    with pytest.raises(ValueError, match="annotation file"):
        list(prefetched_test_batches(ds, groups[:1]))


# ---------------------------------------------------------------- rendering

@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_save_result_without_cv2(tmp_path, ext):
    """The render is the JAX save_result's: cv2.rectangle's band, 3 pixels
    centred on each edge with the outer corners left, and the label
    above the box; below score_thr nothing is drawn."""
    from semi_detr_tpu.api import save_result as jax_save_result
    from semi_detr_tpu_torch.api import save_result
    img = np.zeros((40, 50, 3), np.uint8)
    result = (np.asarray([[5.0, 16.0, 30.0, 35.0], [1.0, 1.0, 9.0, 9.0]]),
              np.asarray([0.9, 0.1]), np.asarray([0, 1]))
    out = save_result(img, result, ("a", "b"), str(tmp_path / f"r.{ext}"),
                      score_thr=0.3)
    back = image_io.read_image(out)
    assert back.shape == img.shape and not img.any()   # input untouched
    want = jax_save_result(img, result, ("a", "b"),
                           str(tmp_path / f"jax.{ext}"), score_thr=0.3)
    np.testing.assert_array_equal(back, _cv2_rgb(open(want, "rb").read()))
    if ext == "png":
        green = (back == (0, 255, 0)).all(-1)
        assert green[15:18, 5:31].all() and green[16:36, 4:7].all()
        assert not green[15, 4] and not green[36, 31]   # corners cut
        assert not green[20, 10] and not green[1:10, 1].any()
        assert back[:12, 5:30, 1].max() > 200            # the label "a:0.90"


def test_image_demo(tmp_path):
    from semi_detr_tpu_torch.api import init_detector
    from semi_detr_tpu_torch.tools import image_demo

    cfg = tmp_path / "tiny.py"
    cfg.write_text("model = dict(num_classes=5, num_queries=20, d_model=32, "
                   "n_heads=2, num_encoder_layers=1, num_decoder_layers=1, "
                   "d_ffn=64)\n")
    det = init_detector(str(cfg), None, device="cpu", seed=3).detector
    ckpt = str(tmp_path / "det.pth")
    torch.save({"state_dict": det.state_dict()}, ckpt)
    src = tmp_path / "in"
    src.mkdir()
    image_io.write_image(str(src / "a.jpg"), _picture(48, 64, 1))
    image_io.write_image(str(src / "b.png"), _picture(56, 40, 2))
    out = image_demo.main([str(src / "*"), str(cfg), "--checkpoint", ckpt,
                           "--output-dir", str(tmp_path / "out"),
                           "--score-thr", "0.0", "--device", "cpu"])
    assert [os.path.basename(p) for p in out] == ["a.jpg", "b.png"]
    for p, hw in zip(out, ((48, 64), (56, 40))):
        back = image_io.read_image(p)
        assert back.shape == hw + (3,)
    assert (image_io.read_image(out[1]) == (0, 255, 0)).all(-1).any()
