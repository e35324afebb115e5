"""AVIF of the chroma layouts and colour descriptions other writers give,
read by the port's host library to cv2's pixels.

cv2 writes 4:2:0 BT.601 full range (lossy) or 4:4:4 identity (lossless);
other writers (Pillow's AVIF plugin, avifenc) write lossy 4:4:4 and 4:2:2,
lossless 4:2:0 and 4:2:2 with a YUV matrix, limited range, and the BT.709,
BT.2020 and other matrices, all of which cv2 reads through libavif. The
port is held so:

* The AV1 decoder (`native/av1_*.cpp`): every committed `avif_layout_*`
  fixture (lossy 4:4:4 and 4:2:2 at speed 0 with loop restoration, at an
  odd size, of screen content with the chroma palette, with CDEF and its
  4:2:2 chroma direction; intra block copy at 4:2:2; lossless 4:2:0 and
  4:2:2) gives dav1d's planes (`tests/av1_witness.py`) with the in-loop
  filters off one at a time.
* The YUV to RGB (`native/avif_host.cpp`): libyuv's conversions as
  libavif hands them over (I444ToRGB24Matrix, I422ToRGB24MatrixFilter,
  I420ToRGB24MatrixFilter) with the constants of BT.601 (matrices 5, 6
  and 2, unspecified), BT.709 (1), BT.2020 NCL (9) and chromaticity-
  derived NCL (12, by its primaries), full and limited range: the
  committed `avif_colr_*` fixtures and fresh colr edits of every layout
  decode to cv2's pixels and the JAX loader's at max abs 0.
* What libavif does not hand to libyuv (another matrix, the identity
  matrix at limited range), film grain, segmentation, superres and delta
  loop filter levels raise "not ported", each naming itself.
"""
import numpy as np
import pytest

import av1_witness
import format_writers as fw
from _format_checks import check_against_cv2, check_against_loaders, read
from semi_detr_tpu_torch import native

STAGES = ("none", "deblock", "deblock_cdef", "all")
LAYOUTS = sorted(fw.committed(("avif_layout_",)))
COLOURS = sorted(fw.committed(("avif_colr_",)))


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("name", LAYOUTS)
def test_stage_planes_equal_a_conformant_decoder(name, stage):
    data = read(name)
    got = native.avif_planes(data, stage, name)
    ref = av1_witness.planes(data, stage)
    assert len(got) == len(ref) == 3
    for p, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape, (name, p, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{name} plane {p}")


def test_layouts_are_what_they_name():
    """Each layout fixture's chroma is subsampled as its name says, and the
    lossless ones are lossless (base_q_idx 0 and no delta q)."""
    for name in LAYOUTS:
        info = fw.av1_frame_info(_item(read(name)))
        want = (0, 0) if "444" in name else (1, 0) if "422" in name else (1, 1)
        assert (info["seq"]["ssx"], info["seq"]["ssy"]) == want, name
        assert info["lossless"] == ("lossless" in name), name


def test_each_filter_stage_moves_a_layout():
    """The layout fixtures exercise every in-loop filter at 4:4:4 and at
    4:2:2 (so holding them to the witness holds something)."""
    for tag in ("444", "422"):
        moved = set()
        for name in (n for n in LAYOUTS if tag in n and "lossless" not in n):
            planes = [av1_witness.planes(read(name), s) for s in STAGES]
            for k in range(1, len(STAGES)):
                if any((a != b).any() for a, b in zip(planes[k - 1], planes[k])):
                    moved.add(STAGES[k])
        assert moved == set(STAGES[1:]), (tag, moved)


def _item(data: bytes) -> bytes:
    a = fw.avif_items(data)
    return a["items"][a["primary"]]["data"]


@pytest.mark.parametrize("name", LAYOUTS + COLOURS)
def test_fixture_against_cv2_and_jax_loader(name, tmp_path):
    assert fw.committed((name,))[name]["expect"] == "pixels"
    assert check_against_loaders(read(name), tmp_path, name)


pic = fw._avif_picture
FRESH = {
    "444_q70_speed8": lambda: fw.avif_pil(pic(50, 71, 51), subsampling="4:4:4",
                                          quality=70, speed=8),
    "422_q30_speed1": lambda: fw.avif_pil(pic(66, 90, 52), subsampling="4:2:2",
                                          quality=30, speed=1),
    "422_1x40": lambda: fw.avif_pil(pic(1, 40, 53), subsampling="4:2:2"),
    "444_40x1": lambda: fw.avif_pil(pic(40, 1, 54), subsampling="4:4:4"),
    "lossless_420_odd": lambda: fw.avif_pil(pic(31, 45, 55), quality=100,
                                            speed=2),
    "lossless_422_1x3": lambda: fw.avif_pil(pic(1, 3, 56), quality=100,
                                            subsampling="4:2:2"),
    "444_screen_q60": lambda: fw.avif_pil(fw._avif_screen(80, 144, 57),
                                          subsampling="4:4:4", quality=60,
                                          speed=3),
    "422_cdef_restoration": lambda: fw.avif_pil(
        pic(72, 104, 58), subsampling="4:2:2", quality=35, speed=3,
        advanced={"enable-cdef": "1", "enable-restoration": "1"}),
}


@pytest.mark.parametrize("case", sorted(FRESH))
def test_fresh_layouts_against_cv2_and_a_conformant_decoder(case, tmp_path):
    """Fresh Pillow writes (other sizes, seeds, qualities and speeds than
    the fixtures): cv2's pixels at max abs 0, dav1d's planes with the
    filters off and on."""
    data = FRESH[case]()
    assert check_against_cv2(data, tmp_path, case + ".avif")
    for stage in ("none", "all"):
        for a, b in zip(native.avif_planes(data, stage),
                        av1_witness.planes(data, stage)):
            np.testing.assert_array_equal(a, b, err_msg=f"{case} {stage}")


SUBSAMPLINGS = ("4:2:0", "4:2:2", "4:4:4")
# (matrix_coefficients, full range, colour_primaries or None)
COLRS = [(1, 1, None), (1, 0, None), (2, 0, None), (5, 1, None), (6, 0, None),
         (9, 1, None), (9, 0, None), (12, 1, 1), (12, 0, 6), (12, 1, 2)]


@pytest.mark.parametrize("colr", COLRS, ids=lambda c: "m{}_full{}_p{}".format(*c))
@pytest.mark.parametrize("sub", SUBSAMPLINGS)
def test_colour_descriptions_against_cv2(sub, colr, tmp_path):
    """Every layout under every matrix libavif hands to libyuv, full and
    limited range (colr edits of one Pillow file per layout): cv2's pixels
    at max abs 0."""
    data = fw.avif_colr(fw.avif_pil(pic(57, 83, 59), subsampling=sub),
                        *colr)
    assert check_against_cv2(data, tmp_path, "colr.avif")


def test_ten_bit_limited_range_against_cv2(tmp_path):
    """A 10-bit lossy file (cv2's) edited to limited range and BT.709: cut
    to 8 bits before libyuv's conversion, as at full range."""
    data = fw.avif_cv2(pic(48, 64, 60).astype(np.uint16) * 4 + 2, quality=60,
                       depth=10)
    assert check_against_cv2(fw.avif_colr(data, 1, 0), tmp_path, "ten.avif")


def test_monochrome_limited_range_reads_as_gray(tmp_path):
    """cv2 takes a monochrome plane as gray whatever its range."""
    data = fw.avif_cv2(pic(48, 64, 61)[..., 0].copy(), quality=80)
    assert check_against_cv2(fw.avif_colr(data, full=0), tmp_path, "mono.avif")


# ------------------------------------------------------------ refusals

def _delta_lf(data: bytes) -> bytes:
    """A committed lossy file (delta q present) with delta_lf_present set
    in its frame header; the tile data stays (the refusal comes first)."""
    def av1(item):
        info = fw.av1_frame_info(item)
        obus = fw.av1_obus(item)
        frame = next(b for t, _, b in obus if t == 6)
        bits = fw._Bits(frame).bits
        p = info["delta_lf_at"]
        head = bits[:p] + "1" + "000" + bits[p + 1:info["header_end"]]
        head += "0" * (-len(head) % 8)
        body = bytes(int(head[i:i + 8], 2) for i in range(0, len(head), 8))
        body += frame[(info["header_end"] + 7) // 8:]
        return fw.av1_join([(t, h, body if t == 6 else b) for t, h, b in obus])
    return fw._avif_edit(data, av1=av1)


REFUSALS = {
    "film_grain": (lambda: fw.avif_pil(pic(48, 64, 62),
                                       advanced={"film-grain-test": "1"}),
                   "film grain"),
    "delta_lf": (lambda: _delta_lf(read("avif_lossy_480x640.avif")),
                 "delta loop filter levels"),
    "matrix_4": (lambda: fw.avif_colr(read("avif_layout_444.avif"), 4),
                 "matrix_coefficients 4"),
    "matrix_12_primaries_4": (lambda: fw.avif_colr(read("avif_layout_444.avif"),
                                                   12, primaries=4),
                              "matrix_coefficients 12"),
    "identity_limited": (lambda: fw.avif_colr(read("avif_rgb8.avif"), full=0),
                         "limited-range samples of the identity matrix"),
}


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_refusals_that_stay(what, tmp_path):
    """What cv2 reads and the port does not raises "not ported" naming
    itself: film grain (Pillow's film-grain-test file), delta loop filter
    levels (a header edit of a committed file), and the colour descriptions
    libavif converts without libyuv (each read by cv2)."""
    make, words = REFUSALS[what]
    data = make()
    if what != "delta_lf":  # a real file, which cv2 reads (the header
        # edit's tile data is not coded for its deltas: libaom fails on it)
        assert fw.cv2_rgb(data, str(tmp_path)) is not None
    name = f"{what}.avif"
    with pytest.raises(native.ImageDecodeError) as err:
        native.decode_image(data, name)
    msg = str(err.value)
    assert name in msg and "AVIF" in msg and "not ported" in msg, msg
    assert words in msg, msg
