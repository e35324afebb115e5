"""PFM and Radiance HDR: the host library's decoders
(`native/float_host.cpp`) against the JAX package's loader, which hands
these files to `cv2.imread(path, IMREAD_COLOR)` (OpenCV 5.0's PFMDecoder
and HdrDecoder).

Both are float formats that cv2 turns to 8 bits with Mat::convertTo: a PFM
sample times 1 / |scale|, an HDR one (RGBE) times 255, each rounded to the
nearest (ties to even) and saturated, where a NaN, an infinity or a value
of 2 ** 31 or more reads 0. The committed fixtures (`pfm_*`, `hdr_*`,
`other_pfm.pfm`, `other_hdr.hdr`, with `formats.json`) decode to their
stored cv2 pixels and to the JAX loader's at max abs 0. Seeded files cover
both byte orders and scales, rows bottom-up, the rounding's ties and
extremes, HDR's run-length scanlines (runs and literals, widths 8-300),
flat pixels (and widths under 8), a run-length file that turns flat, both
header signatures and header lines around FORMAT; each is held to
cv2.imread and to the JAX loader at max abs 0, or raises where cv2 refuses
(a one-channel PFM, a scale of 0, another orientation, a missing FORMAT
line, old-style run-length pixels, which cv2 reads as flat ones and so runs
out of data). Damaged copies raise naming the file.
"""
import numpy as np
import pytest

from _format_checks import (check_against_loaders, check_damaged,
                            check_fixture, fixture_params)
from format_writers import hdr_rle_scanline, rgbe, write_hdr, write_pfm

H, W = 17, 31


@pytest.mark.parametrize("name,entry", fixture_params(
    ("pfm_", "hdr_", "other_pfm", "other_hdr")))
def test_fixture(name, entry):
    check_fixture(name, entry)


SPECIAL = np.array([np.nan, np.inf, -np.inf, 0.5, 1.5, 2.5, 254.5, 255.5,
                    -0.5, -1e9, 1e10, 2147483520.0, 2147483648.0, 65535.4,
                    32767.6, 3e38], np.float32)


@pytest.mark.parametrize("scale", [-1.0, 1.0, -2.0, 0.5, -0.3, 3.0, 1e-3])
def test_seeded_pfm(scale, tmp_path):
    rs = np.random.RandomState(int(abs(scale) * 1000))
    a = rs.uniform(-40, 300, (H, W, 3)).astype(np.float32) * abs(scale)
    a.reshape(-1)[:len(SPECIAL)] = SPECIAL
    assert check_against_loaders(write_pfm(a, scale), tmp_path, "s.pfm")


def test_seeded_pfm_unit_range(tmp_path):
    """A [0, 1] PFM reads almost black: no scaling to 255."""
    rs = np.random.RandomState(1)
    a = rs.uniform(0, 1, (H, W, 3)).astype(np.float32)
    assert check_against_loaders(write_pfm(a), tmp_path, "u.pfm")


@pytest.mark.parametrize("name,data", [
    ("gray_pf", write_pfm(np.ones((H, W), np.float32))),
    ("scale_zero", b"PF\n3 2\n0\n" + bytes(72)),
    ("size_zero", b"PF\n0 2\n-1\n"),
    ("cr_header", b"PF\r\n3 2\n-1\n" + bytes(72))])
def test_pfm_what_cv2_refuses_raises(name, data, tmp_path):
    assert not check_against_loaders(data, tmp_path, name + ".pfm")


def _hdr_pixels(rs, h, w, runs=False):
    e = rs.randint(0, 256, (h, w, 4)).astype(np.uint8)
    e[..., 3] = rs.randint(118, 140, (h, w))
    if runs:
        e[:, : w // 2] = e[:, :1]
        e[::3, w // 3:] = e[::3, w // 3:w // 3 + 1]
    e[0, :3, 3] = 0  # RGBE zero
    return e


@pytest.mark.parametrize("w", [8, 31, 127, 128, 129, 300])
@pytest.mark.parametrize("runs", [False, True])
def test_seeded_hdr_rle(w, runs, tmp_path):
    rs = np.random.RandomState(w)
    e = _hdr_pixels(rs, 5, w, runs)
    assert check_against_loaders(write_hdr(e), tmp_path, "r.hdr")


@pytest.mark.parametrize("w", [1, 7, 8, 31])
def test_seeded_hdr_flat(w, tmp_path):
    rs = np.random.RandomState(w + 1)
    e = _hdr_pixels(rs, 6, w)
    assert check_against_loaders(write_hdr(e, "flat"), tmp_path, "f.hdr")


def test_hdr_exponents_and_floats(tmp_path):
    """Every exponent byte (tiny floats, and products past 2 ** 31 that
    read 0), and Ward's float2rgbe of a float picture, the way cv2.imwrite
    writes one."""
    rs = np.random.RandomState(3)
    e = rs.randint(0, 256, (8, 64, 4)).astype(np.uint8)
    e[..., 3] = np.arange(256).reshape(8, 32).repeat(2, 1)
    assert check_against_loaders(write_hdr(e), tmp_path, "x.hdr")
    img = rs.uniform(0, 2, (H, W, 3))
    assert check_against_loaders(write_hdr(rgbe(img)), tmp_path, "y.hdr")


def test_hdr_headers_and_mixed_scanlines(tmp_path):
    rs = np.random.RandomState(4)
    e = _hdr_pixels(rs, H, W)
    for magic in (b"#?RADIANCE", b"#?RGBE"):
        for lines in ((), (b"EXPOSURE=2.0", b"GAMMA=1.0",
                           b"SOFTWARE=" + b"x" * 200)):
            data = write_hdr(e, magic=magic, extra_lines=lines)
            assert check_against_loaders(data, tmp_path, "h.hdr")
    head = write_hdr(e[:0], extra_lines=())  # the header of a 0-row file
    head = head[:head.rindex(b"-Y")] + f"-Y {H} +X {W}\n".encode()
    mixed = head + hdr_rle_scanline(e[0]) + hdr_rle_scanline(e[1]) + \
        e[2:].tobytes()
    assert check_against_loaders(mixed, tmp_path, "m.hdr")
    after = head.replace(b"FORMAT=32-bit_rle_rgbe\n",
                         b"FORMAT=32-bit_rle_rgbe\nEXPOSURE=1\n")
    assert check_against_loaders(after + e.tobytes(), tmp_path, "a.hdr")


def _hdr_refused():
    rs = np.random.RandomState(5)
    e = _hdr_pixels(rs, 6, 20)
    e[2, 3:12] = e[2, 3]
    body = write_hdr(e)
    res = body[body.index(b"-Y"):].split(b"\n", 1)
    return {
        "flipped_y": body.replace(b"-Y 6 +X 20", b"+Y 6 +X 20"),
        "x_first": body.replace(b"-Y 6 +X 20", b"+X 20 -Y 6"),
        "xyze": body.replace(b"FORMAT=32-bit_rle_rgbe",
                             b"FORMAT=32-bit_rle_xyze"),
        "blank_before_format": body.replace(b"#?RADIANCE\n",
                                            b"#?RADIANCE\n\n"),
        "old_rle": write_hdr(e, "old"),
        "size_zero": body.replace(b"-Y 6", b"-Y 0")[:len(res[0]) + 40],
    }


@pytest.mark.parametrize("name,data", sorted(_hdr_refused().items()))
def test_hdr_what_cv2_refuses_raises(name, data, tmp_path):
    assert not check_against_loaders(data, tmp_path, name + ".hdr")


def test_damaged_copies_raise_naming_the_file():
    rs = np.random.RandomState(6)
    pfm = write_pfm(rs.uniform(0, 255, (H, W, 3)).astype(np.float32))
    check_damaged(pfm[:len(pfm) - 4], "pfm_truncated.pfm", "PFM")
    check_damaged(b"PF\n", "pfm_header_only.pfm", "PFM")
    hdr = write_hdr(_hdr_pixels(rs, H, W, True))
    check_damaged(hdr[:len(hdr) // 2], "hdr_truncated.hdr", "HDR")
    bad = bytearray(hdr)
    start = hdr.index(b"+X 31\n") + 6
    bad[start + 2:start + 4] = b"\0\x09"  # a scanline of the wrong width
    check_damaged(bytes(bad), "hdr_bad_width.hdr", "scanline")
    check_damaged(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n",
                  "hdr_header_only.hdr", "HDR")
