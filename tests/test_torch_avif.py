"""AVIF read by the port's host library (`native/avif_host.cpp` with the
AV1 decoder of `native/av1_*.cpp`) against cv2 and the JAX loader.

The JAX package reads AVIF through its loader's cv2 fallback (cv2 5.0:
libavif over libaom 3.14.1). cv2.imwrite at quality 100 writes a lossless
AV1 key frame (4:4:4 with the identity matrix, or monochrome), and those
decode here to cv2.imread's pixels at max abs 0: every committed `avif_*`
fixture (8, 10 and 12 bits, monochrome, speeds 0-9, screen content with
palette and intra block copy, edge sizes, the alpha item, the container
edits, a grid, a full sequence header; and the lossy `avif_lossy_*` ones,
which tests/test_torch_avif_lossy.py holds stage by stage), and pictures
written afresh. The tool tally (`native.avif_tools`) shows each coding
tool reached; the lossless tools no fixture reaches raise "AVIF ... not
ported"; damaged files raise naming the file. `tools.av1_table` rewrites
`native/av1_tables.h` from cv2's libaom as it is committed.
"""
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

import format_writers as fw
from _format_checks import (check_against_loaders, check_damaged,
                            check_fixture, fixture_params, read)
from semi_detr_tpu_torch import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name,entry", fixture_params(("avif_", "other_avif")))
def test_avif_fixture(name, entry):
    check_fixture(name, entry)
    if entry["expect"] == "pixels":
        assert entry["route"] == "avif"


CASES = {
    "rgb_31x57": lambda: fw.avif_cv2(fw._avif_picture(31, 57, 11)),
    "rgb_speed3": lambda: fw.avif_cv2(fw._avif_picture(40, 80, 12), speed=3),
    "rgb10_odd": lambda: fw.avif_cv2(
        fw._avif_picture(17, 29, 13).astype(np.uint16) * 4 + 2, depth=10),
    "rgb12_speed0": lambda: fw.avif_cv2(
        fw._avif_picture(24, 40, 14).astype(np.uint16) * 16 + 9, depth=12,
        speed=0),
    "gray_speed2": lambda: fw.avif_cv2(
        fw._avif_picture(33, 21, 15)[..., 2].copy(), speed=2),
    "screen_speed2": lambda: fw.avif_cv2(fw._avif_screen(64, 96, 16), speed=2),
    "noise": lambda: fw.avif_cv2(np.random.RandomState(17).randint(
        0, 256, (20, 36, 3)).astype(np.uint8)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_avif_against_cv2_and_jax_loader(case, tmp_path):
    """Fresh cv2 writes (other sizes, speeds and seeds than the fixtures):
    cv2's pixels and the JAX loader's, at max abs 0."""
    assert check_against_loaders(CASES[case](), tmp_path, case + ".avif")


def test_avif_tools_all_reached():
    """Decoding the committed pixel fixtures reaches every tool the
    decoder counts: a tool no fixture reaches would be decoded untested."""
    before = native.avif_tools()
    for name, entry in fw.committed(("avif_",)).items():
        if entry["expect"] == "pixels":
            native.decode_image(read(name), name)
    after = native.avif_tools()
    assert set(after) == set(before) and len(after) >= 40
    missed = [t for t in after if after[t] == before[t]]
    assert not missed, missed
    assert "avif" in native.decoders()


def _refused(data: bytes, name: str, *words):
    with pytest.raises(native.ImageDecodeError) as err:
        native.decode_image(data, name)
    msg = str(err.value)
    assert name in msg and "AVIF" in msg and "not ported" in msg, msg
    for w in words:
        assert w in msg, msg


def test_avif_refusals():
    """A lossless tool no fixture reaches (segmentation: a header edit of a
    committed fixture) raises naming the tool; `image_size` refuses as the
    decode does. (cv2's lossy files now read to cv2's pixels:
    test_torch_avif_lossy.py; several tiles too: test_torch_avif_tiles.py.)"""
    seg = fw._avif_edit(read("avif_rgb8.avif"), av1=lambda d:
                        fw.av1_header_edit(d, segmentation=True))
    _refused(seg, "segmentation.avif", "segmentation")
    with pytest.raises(native.ImageDecodeError, match="segmentation"):
        native.image_size(seg, "segmentation.avif")


def _cut_tile(item: bytes) -> bytes:
    """The frame OBU's tile data cut to half, its size written anew."""
    out = []
    for t, h, body in fw.av1_obus(item):
        if t == 6:
            body = body[:len(body) // 2]
        out.append((t, h, body))
    return fw.av1_join(out)


def _obu_past_end(item: bytes) -> bytes:
    """The frame OBU claiming 1,000 bytes more than the item holds."""
    obus = fw.av1_obus(item)
    head = b"".join(bytes([h]) + fw._leb128(len(b)) + b for t, h, b in obus
                    if t != 6)
    t, h, body = next(o for o in obus if o[0] == 6)
    return head + bytes([h]) + fw._leb128(len(body) + 1000) + body


def _iloc_broken(data: bytes) -> bytes:
    """iloc's offset size set to 3 bytes, which the format does not have."""
    meta = next(b for b in fw.avif_boxes(data) if b[0] == b"meta")
    iloc = next(b for b in fw.avif_boxes(data, meta[1] + 4, meta[2])
                if b[0] == b"iloc")
    out = bytearray(data)
    out[iloc[1] + 4] = 0x34
    return bytes(out)


DAMAGED = {
    "truncated_mdat": (lambda d: d[:len(d) - len(d) // 3], "runs past"),
    "obu_past_end": (lambda d: fw._avif_edit(d, av1=_obu_past_end),
                     "runs past the end"),
    "broken_iloc": (_iloc_broken, "iloc"),
    "tile_ends_early": (lambda d: fw._avif_edit(d, av1=_cut_tile), ""),
}


@pytest.mark.parametrize("kind", sorted(DAMAGED))
def test_avif_damaged(kind, tmp_path):
    """Damage raises ImageDecodeError naming the file (and cv2 refuses the
    file too)."""
    make, fault = DAMAGED[kind]
    data = make(read("avif_speed0.avif"))
    name = f"avif_{kind}.avif"
    check_damaged(data, name, fault)
    assert fw.cv2_rgb(data, str(tmp_path), name) is None


def test_av1_table_tool_rewrites_the_header(tmp_path):
    """`tools.av1_table` finds libaom's tables in cv2's copy again (the
    coefficient CDFs in .rodata, the mode CDFs in the frame context its
    decoder builds, the other tables by their structure) and writes the
    committed av1_tables.h byte for byte. It runs in a process of its own,
    as a maintainer runs it: its memory scan reads that process's heap."""
    out = tmp_path / "av1_tables.h"
    res = subprocess.run([sys.executable, "-m",
                          "semi_detr_tpu_torch.tools.av1_table", "--out",
                          str(out)], cwd=REPO, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stderr + res.stdout
    with open(os.path.join(REPO, "semi_detr_tpu_torch", "native",
                           "av1_tables.h")) as f:
        assert out.read_text() == f.read()


def test_avif_decode_equals_cv2_at_full_width():
    """The 480x640 fixture (phase 7a's): cv2's pixels, the size from the
    headers alone."""
    data = read("avif_480x640.avif")
    assert native.image_size(data) == (480, 640)
    ref = cv2.imread(os.path.join(native.FIXTURES, "avif_480x640.ref.png"),
                     cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(native.decode_image(data), ref)
