"""Every JPEG the JAX package's loader reads, read to the same pixels by
the port's own decoders.

The JAX package decodes JPEG with libjpeg (libjpeg-turbo 2.1.5 here:
`semi_detr_tpu.native.decode_image`, output RGB, islow IDCT, fancy
upsampling, block smoothing on) and falls back to `cv2.imread(path,
IMREAD_COLOR)` where libjpeg gives no RGB (CMYK and YCCK;
`CocoDataset.load_image`). The host library's own decoders
(`semi_detr_tpu_torch/native/jpeg_host.cpp`, the card's route too) are
held to those pixels bit for bit (max abs 0), called directly
(`native.decode_jpeg_sequential` / `_progressive` / `_arithmetic`) and
through `native.decode_image`:

* every sampling layout cv2 writes (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1,
  gray) at restart intervals 0 and 1, sequential and progressive;
* arithmetic coding (SOF9, SOF10), colour and gray, with restarts;
* progressive scripts cut after scans 1, 3 and n - 1 (libjpeg smooths
  their blocks), Huffman and arithmetic;
* Adobe RGB and 'R', 'G', 'B' component ids (no colour transform);
* CMYK and YCCK against `CocoDataset.load_image` (cv2's conversion), and
  their EXIF orientations;
* damaged streams raise `ImageDecodeError` naming the fault on both
  routes.

Arithmetic and YCCK streams come from `tests/jpeg_tool.cpp` (g++ against
the machine's libjpeg): cv2's streams transcoded losslessly, as `jpegtran
-arithmetic` does. The committed fixtures (`native/fixtures/jpeg_*.jpg`,
each beside its reference pixels as an 8-bit RGB PNG, which
`chip_smoke.py` phase 7a decodes on the card) are regenerated here and
compared byte for byte; `PYTHONPATH=. python
tests/test_torch_jpeg_formats.py` from the repo root writes them.
"""
import functools
import io
import json
import os
import subprocess
import sys
import tempfile

import cv2
import numpy as np
import pytest
from PIL import Image

from semi_detr_tpu.data.coco import CocoDataset as JaxCocoDataset
from semi_detr_tpu_torch import native
from semi_detr_tpu_torch.data import image_io

LAYOUTS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
           "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
           "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
           "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
           "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, "gray": None}
# (h, w), quality: tiny planes (the narrow-plane cut-offs), odd sizes
SHAPES = (((1, 1), 50), ((5, 3), 90), ((9, 17), 5), ((17, 33), 75),
          ((45, 61), 95))
DECODERS = {"sequential": native.decode_jpeg_sequential,
            "progressive": native.decode_jpeg_progressive,
            "sequential arithmetic": native.decode_jpeg_arithmetic,
            "progressive arithmetic": native.decode_jpeg_arithmetic}

from format_writers import jax_native, jax_native_fixture

# the JAX package's host library, loaded under the shared lock
jax_native_loaded = jax_native_fixture()


def picture(h, w, seed, channels=3):
    """Gradients, a disc and seeded noise: smooth areas and sharp edges."""
    rs = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([xs * 255 / w, ys * 255 / h, (xs + ys) * 127 / (h + w)
                    + 64, 255 - xs * 200 / w], -1)[..., :channels]
    img[(xs - 0.4 * w) ** 2 + (ys - 0.5 * h) ** 2 < (0.3 * min(h, w)) ** 2] \
        = (230, 40, 90, 20)[:channels]
    img = img + rs.randint(-12, 13, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def cv2_jpeg(img, layout="420", quality=95, restart=0, progressive=False):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
              cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
    if layout != "gray":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, LAYOUTS[layout]]
    src = img[..., 0] if layout == "gray" else img[..., ::-1]
    return cv2.imencode(".jpg", src, params)[1].tobytes()


@functools.lru_cache(maxsize=None)
def jpeg_tool() -> str:
    """tests/jpeg_tool.cpp built with g++ against the machine's libjpeg."""
    out = os.path.join(tempfile.mkdtemp(prefix="sdt_jpeg_tool_"),
                       "jpeg_tool")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "jpeg_tool.cpp")
    subprocess.run(["g++", "-O1", "-std=c++17", src, "-o", out, "-ljpeg"],
                   check=True, capture_output=True)
    return out


def transcode(buf: bytes, *opts: str) -> bytes:
    """buf's coefficients rewritten by libjpeg: "arithmetic",
    "progressive", "restart", "N"."""
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.jpg"), os.path.join(tmp, "out.jpg")
        with open(src, "wb") as f:
            f.write(buf)
        subprocess.run([jpeg_tool(), "transcode", src, dst, *opts],
                       check=True, capture_output=True)
        with open(dst, "rb") as f:
            return f.read()


def ycck_jpeg(cmyk: np.ndarray, quality: int = 90) -> bytes:
    """CMYK pixels encoded by libjpeg as a YCCK stream."""
    h, w, _ = cmyk.shape
    with tempfile.TemporaryDirectory() as tmp:
        raw, dst = os.path.join(tmp, "in.cmyk"), os.path.join(tmp, "out.jpg")
        np.ascontiguousarray(cmyk, np.uint8).tofile(raw)
        subprocess.run([jpeg_tool(), "ycck", raw, str(h), str(w),
                        str(quality), dst], check=True, capture_output=True)
        with open(dst, "rb") as f:
            return f.read()


def pil_jpeg(img, mode, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def scans(buf: bytes):
    """The start of each SOS marker."""
    out, i = [], 0
    while (i := buf.find(b"\xff\xda", i)) >= 0:
        out.append(i)
        i += 2
    return out


def cut_after(buf: bytes, k: int) -> bytes:
    """The stream's first k scans, then EOI: a script that stops short."""
    return buf[:scans(buf)[k]] + b"\xff\xd9"


def jax_loader_image(buf: bytes) -> np.ndarray:
    """The JAX package's `CocoDataset.load_image` of a file holding buf
    (its native decoder, else cv2.imread)."""
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "x.jpg"), "wb") as f:
            f.write(buf)
        ds = JaxCocoDataset({"images": [{"id": 1, "file_name": "x.jpg",
                                         "width": 8, "height": 8}]},
                            tmp, test_mode=True)
        return ds.load_image(0)


def assert_host_decodes(buf: bytes, ref: np.ndarray, kind: str):
    """The host decoder of the stream's kind, called directly, and
    decode_image, both equal to ref."""
    assert native.jpeg_host_kind(buf) == kind
    np.testing.assert_array_equal(DECODERS[kind](buf), ref)
    np.testing.assert_array_equal(native.decode_image(buf), ref)


# ----------------------------------------------------------- Huffman

@pytest.mark.parametrize("restart", [0, 1])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sampling_layout_equals_libjpeg(layout, restart):
    """Each component upsampled as jdsample.c chooses against the frame's
    largest factors (full size, h2v1, h1v2, h2v2 fancy, int_upsample for
    4:1:1, plain where a plane is at most 2 samples wide)."""
    for (h, w), q in SHAPES:
        img = picture(h, w, seed=h + q)
        for progressive in (False, True):
            buf = cv2_jpeg(img, layout, q, restart, progressive)
            assert_host_decodes(buf, jax_native.decode_image(buf),
                                "progressive" if progressive
                                else "sequential")


# -------------------------------------------------------- arithmetic

@pytest.mark.parametrize("colour", ["colour", "gray"])
@pytest.mark.parametrize("mode", ["sequential", "progressive"])
def test_arithmetic_equals_libjpeg(mode, colour):
    """cv2's streams transcoded to arithmetic coding (jdarith.c's QM coder,
    statistics bins, DAC conditioning, the four progressive scan types,
    the statistics reset at each restart), every layout for colour."""
    layouts = ("420", "444", "422", "411") if colour == "colour" \
        else ("gray",)
    for (h, w), q in SHAPES:
        for i, layout in enumerate(layouts):
            base = cv2_jpeg(picture(h, w, seed=q + i), layout, q)
            for restart in ("0", "1", "3"):
                opts = ["arithmetic", "restart", restart]
                if mode == "progressive":
                    opts.append("progressive")
                buf = transcode(base, *opts)
                assert buf[2:].find(b"\xff\xc9" if mode == "sequential"
                                    else b"\xff\xca") >= 0
                assert_host_decodes(buf, jax_native.decode_image(buf),
                                    f"{mode} arithmetic")


@pytest.mark.parametrize("cut", ["1", "3", "n-1"])
@pytest.mark.parametrize("coding", ["huffman", "arithmetic"])
def test_smoothed_progressive_script_equals_libjpeg(coding, cut):
    """A script cut short leaves the DC or AC 1-9 short of their last bit:
    libjpeg smooths the blocks (jdcoefct.c, the 3x3 and, with no AC data
    yet, the DC-changing 5x5 estimates, edges repeated)."""
    for (h, w), q in SHAPES:
        for layout in ("420", "444", "411", "gray"):
            buf = cv2_jpeg(picture(h, w, seed=q), layout, q,
                           progressive=True)
            if coding == "arithmetic":
                buf = transcode(buf, "arithmetic", "progressive")
            n = len(scans(buf))
            short = cut_after(buf, n - 1 if cut == "n-1" else int(cut))
            assert native.jpeg_check(short) is None
            assert_host_decodes(short, jax_native.decode_image(short),
                                "progressive" if coding == "huffman"
                                else "progressive arithmetic")


# ------------------------------------------------------------ colour

@pytest.mark.parametrize("case", ["adobe", "rgb_ids", "adobe_progressive"])
def test_rgb_streams_equal_libjpeg(case):
    """No colour transform where libjpeg's guess says RGB: an Adobe marker
    with transform 0, or component ids 'R', 'G', 'B' without a JFIF or
    Adobe marker."""
    for (h, w), _ in SHAPES:
        buf = pil_jpeg(picture(h, w, 3), "RGB", quality=90, keep_rgb=True,
                       progressive=case == "adobe_progressive")
        if case == "rgb_ids":
            app14 = buf.index(b"\xff\xee")
            buf = buf[:app14] + buf[app14 + 2 + (buf[app14 + 2] << 8
                                                 | buf[app14 + 3]):]
            assert b"Adobe" not in buf and b"JFIF" not in buf
        assert native.jpeg_colour(buf) == "RGB"
        assert_host_decodes(buf, jax_native.decode_image(buf),
                            "progressive" if "progressive" in case
                            else "sequential")


CMYK_CASES = ("cmyk", "cmyk_progressive", "ycck", "ycck_small",
              "ycck_arithmetic") + tuple(f"cmyk_exif{o}" for o in range(2, 9))


@functools.lru_cache(maxsize=None)
def _cmyk_streams():
    cmyk = picture(37, 53, 5, channels=4)
    out = {"cmyk": pil_jpeg(cmyk, "CMYK", quality=90),
           "cmyk_progressive": pil_jpeg(cmyk, "CMYK", quality=90,
                                        progressive=True),
           "ycck": ycck_jpeg(cmyk), "ycck_small": ycck_jpeg(cmyk[:3, :5])}
    out["ycck_arithmetic"] = transcode(out["ycck"], "arithmetic")
    for o in range(2, 9):
        exif = Image.Exif()
        exif[0x0112] = o
        out[f"cmyk_exif{o}"] = pil_jpeg(cmyk[:13, :29], "CMYK", quality=90,
                                        exif=exif.tobytes())
    return out


@pytest.mark.parametrize("case", CMYK_CASES)
def test_cmyk_and_ycck_equal_the_jax_loader(case, tmp_path):
    """libjpeg gives no RGB for 4 components; the JAX loader falls back to
    cv2.imread: YCCK -> CMYK as jdcolor.c converts it, OpenCV's CMYK ->
    BGR on Adobe's inverted CMYK, and the EXIF orientation. The port's
    decoders give those pixels (`image_io.read_image`, as the port's
    datasets read a file)."""
    buf = _cmyk_streams()[case]
    ref = jax_loader_image(buf)
    assert jax_native.decode_image(buf) is None         # cv2's fallback
    assert native.jpeg_colour(buf) == ("YCCK" if "ycck" in case else "CMYK")
    kind = native.jpeg_host_kind(buf)
    assert kind == ("sequential arithmetic" if "arithmetic" in case
                    else "progressive" if "progressive" in case
                    else "sequential")
    assert native.image_size(buf) == ref.shape[:2]
    np.testing.assert_array_equal(DECODERS[kind](buf), ref)
    path = str(tmp_path / f"{case}.jpg")
    with open(path, "wb") as f:
        f.write(buf)
    np.testing.assert_array_equal(image_io.read_image(path), ref)


@functools.lru_cache(maxsize=None)
def _cut_cmyk_streams():
    """Progressive CMYK (Pillow, every component 1x1) and YCCK (libjpeg,
    Y and K 2x2: vertical subsampling) streams of sizes whose last iMCU
    row is whole, short, or a row of two blocks, Huffman and arithmetic."""
    out = {}
    for h, w in ((37, 53), (17, 40), (64, 96), (40, 9), (31, 16)):
        cmyk = picture(h, w, h + w, channels=4)
        out[f"cmyk_{h}x{w}"] = pil_jpeg(cmyk, "CMYK", quality=80,
                                        progressive=True)
        ycck = ycck_jpeg(cmyk, 80)
        out[f"ycck_{h}x{w}"] = transcode(ycck, "progressive")
        if (h, w) == (37, 53):
            out[f"ycck_arith_{h}x{w}"] = transcode(ycck, "arithmetic",
                                                   "progressive")
    return out


@pytest.mark.parametrize("case", sorted(_cut_cmyk_streams()))
def test_cut_cmyk_and_ycck_scripts_equal_the_jax_loader(case):
    """A CMYK or YCCK progressive script cut after each of its scans is
    smoothed as the JAX loader's cv2 (libjpeg-turbo 3.1) smooths it: its
    5 x 5 neighbourhood takes the rows two away that 2.1 replaces by a
    nearer one under vertical subsampling, and clamps its columns on a row
    of two blocks."""
    buf = _cut_cmyk_streams()[case]
    for k in range(1, len(scans(buf))):
        short = cut_after(buf, k)
        ref = jax_loader_image(short)
        kind = native.jpeg_host_kind(short)
        np.testing.assert_array_equal(DECODERS[kind](short), ref,
                                      err_msg=f"{case} cut after {k}")


# ------------------------------------------------------------ routes

def test_every_kind_is_named_and_routed_to_the_host():
    """`decoders()` names a host route for each kind; `jpeg_host_kind`
    names each stream's; what libjpeg-turbo 2.1.5 refuses (12 bits,
    lossless) stays with the back end, which refuses it too."""
    dec = native.decoders()
    for kind in DECODERS:
        assert dec["jpeg_" + kind.replace(" ", "_")].startswith("host ")
    assert "CMYK" in dec["jpeg_colour"] and "YCCK" in dec["jpeg_colour"]
    base = cv2_jpeg(picture(17, 23, 1))
    assert native.jpeg_host_kind(transcode(base, "arithmetic")) == \
        "sequential arithmetic"
    sof = base.index(b"\xff\xc0")
    for marker, precision in ((0xC3, 8), (0xC1, 12)):
        other = bytearray(base)
        other[sof + 1], other[sof + 4] = marker, precision
        assert native.jpeg_host_kind(bytes(other)) is None
        assert native.jpeg_colour(bytes(other)) is None
        with pytest.raises(native.ImageDecodeError):
            native.decode_image(bytes(other))


# ------------------------------------------------------------ damage

DAMAGE_CASES = ("arith_truncated", "arith_bad_code",
                "arith_progressive_bad_code", "arith_restart_dropped",
                "smoothed_truncated")


@functools.lru_cache(maxsize=None)
def _damaged():
    img = picture(64, 96, 9)
    # noise: many nonzero coefficients, where a run of one bits overflows
    noise = np.random.RandomState(0).randint(0, 256, (64, 96, 3)).astype(
        np.uint8)
    seq = transcode(cv2_jpeg(noise[..., ::-1], "420", 90), "arithmetic")
    prog = transcode(cv2_jpeg(noise[..., ::-1], "444", 90), "arithmetic",
                     "progressive")
    rst = transcode(cv2_jpeg(img, quality=90), "arithmetic", "restart", "1")
    marks = [i for i in range(len(rst) - 1)
             if rst[i] == 0xFF and 0xD0 <= rst[i + 1] <= 0xD7]

    def ones(buf):          # a run of stuffed 0xFF bytes mid-scan
        sos = buf.index(b"\xff\xda")
        start = sos + 2 + (buf[sos + 2] << 8 | buf[sos + 3])
        mid = (start + len(buf)) // 2
        return buf[:mid] + b"\xff\x00" * 8 + buf[mid + 16:]

    short = cut_after(cv2_jpeg(img, progressive=True), 3)
    mid = (scans(short)[2] + len(short)) // 2     # inside the third scan
    return {"arith_truncated": (seq[:len(seq) // 2], "Premature end"),
            "arith_bad_code": (ones(seq), "bad arithmetic code"),
            "arith_progressive_bad_code": (ones(prog),
                                           "bad arithmetic code"),
            "arith_restart_dropped": (rst[:marks[2]] + rst[marks[2] + 2:],
                                      "restart marker"),
            "smoothed_truncated": (short[:mid] + b"\xff\xd9",
                                   "premature end of data segment")}


@pytest.mark.parametrize("case", DAMAGE_CASES)
def test_damaged_stream_raises_naming_the_fault(case, tmp_path):
    """Where libjpeg warns of damage, the host decoders raise with the
    fault (and the back end too, here); nothing comes back blank or goes
    quietly to another decoder."""
    buf, fault = _damaged()[case]
    path = str(tmp_path / f"{case}.jpg")
    with open(path, "wb") as f:
        f.write(buf)
    with pytest.raises(native.ImageDecodeError) as err:
        image_io.read_image(path)
    assert f"{case}.jpg" in str(err.value) and fault in str(err.value), \
        err.value
    with pytest.raises(native.ImageDecodeError):
        DECODERS[native.jpeg_host_kind(buf)](buf)
    with pytest.raises(native.ImageDecodeError):
        native.decode_jpeg_backend(buf)


# ---------------------------------------------------------- fixtures

@functools.lru_cache(maxsize=None)
def fixture_streams():
    """name -> (stream, reference pixels): the JAX package's decode, or
    its loader's (cv2) for CMYK and YCCK."""
    img = picture(45, 61, 0)
    cmyk = picture(45, 61, 1, channels=4)
    prog = cv2_jpeg(img, progressive=True)
    streams = {
        "jpeg_411": cv2_jpeg(img, "411"),
        "jpeg_440": cv2_jpeg(img, "440"),
        "jpeg_adobe_rgb": pil_jpeg(img, "RGB", quality=90, keep_rgb=True),
        "jpeg_arith_sequential": transcode(cv2_jpeg(img), "arithmetic"),
        "jpeg_arith_progressive": transcode(cv2_jpeg(img), "arithmetic",
                                            "progressive"),
        "jpeg_progressive_cut3": cut_after(prog, 3),
        "jpeg_cmyk": pil_jpeg(cmyk, "CMYK", quality=90),
        "jpeg_ycck": ycck_jpeg(cmyk)}
    return {name: (buf, jax_loader_image(buf))
            for name, buf in streams.items()}


FIXTURE_KINDS = {"jpeg_411": "sequential", "jpeg_440": "sequential",
                 "jpeg_adobe_rgb": "sequential",
                 "jpeg_arith_sequential": "sequential arithmetic",
                 "jpeg_arith_progressive": "progressive arithmetic",
                 "jpeg_progressive_cut3": "progressive",
                 "jpeg_cmyk": "sequential", "jpeg_ycck": "sequential"}


def write_fixtures(root: str = native.FIXTURES):
    index = {}
    for name, (buf, ref) in fixture_streams().items():
        with open(os.path.join(root, f"{name}.jpg"), "wb") as f:
            f.write(buf)
        image_io.write_png(os.path.join(root, f"{name}.png"), ref)
        index[name] = dict(kind=FIXTURE_KINDS[name],
                           colour=native.jpeg_colour(buf))
    with open(os.path.join(root, "jpeg_formats.json"), "w") as f:
        json.dump(index, f, indent=1, sort_keys=True)
        f.write("\n")


@pytest.mark.parametrize("name", sorted(FIXTURE_KINDS))
def test_committed_jpeg_fixtures(name):
    """The committed fixture is this file's stream, its committed pixels
    the JAX loader's, and the host decoders read it to them (the kind and
    colour the card's phase 7a reads from jpeg_formats.json)."""
    buf, ref = fixture_streams()[name]
    with open(os.path.join(native.FIXTURES, f"{name}.jpg"), "rb") as f:
        assert f.read() == buf
    np.testing.assert_array_equal(image_io.read_image(
        os.path.join(native.FIXTURES, f"{name}.png")), ref)
    with open(os.path.join(native.FIXTURES, "jpeg_formats.json")) as f:
        index = json.load(f)[name]
    assert index == dict(kind=FIXTURE_KINDS[name],
                         colour=native.jpeg_colour(buf))
    assert_host_decodes(buf, ref, index["kind"])


if __name__ == "__main__":
    sys.exit(write_fixtures())
