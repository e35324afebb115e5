"""AVIF of several tiles, read and written by the port's host library as
cv2 reads and writes it.

AV1 splits a frame into tiles where one cannot hold it: more than 64
superblocks of 64x64 across (a picture wider than 4096) or more than 2304
in all (any picture over about 9.4 MP, such as a 12 MP photo), and other
writers split smaller frames on request (Pillow's tile_rows, tile_cols and
autotiling). Each tile is coded on its own: its own symbols, CDFs, above
contexts, qindex and loop restoration references, its blocks' neighbours
only those inside it; the in-loop filters then run over the whole frame.
The port (`native/av1_obu.cpp`, `native/av1_intra.cpp`,
`native/av1_encode.cpp`) is held so:

* Reading: the committed tile fixtures (Pillow's forced 2x2 at 240x320,
  cv2's 2x1 at 300x4200 and 256x4104), cv2's own 12 MP photo (1x2 tiles,
  written here by cv2.imencode) and Pillow's autotiled 4x1 file decode to
  cv2's pixels and the JAX loader's at max abs 0, `image_size` agrees, and
  their planes equal dav1d's (`tests/av1_witness.py`) with the in-loop
  filters off one at a time.
* Writing: `write_image` writes a picture wider than 4096 and one of over
  2304 superblocks in the tile_info cv2 writes for the same size (uniform
  spacing, the fewest tiles the limits allow), context_update_tile_id and
  TileSizeBytes by the rule cv2's files show (the largest tile; the fewest
  bytes that hold its size); cv2 reads each file to the encoder's
  reconstruction at max abs 0; against cv2's own round trip, RGB PSNR at
  most 0.5 dB below and bytes at most 1.5 times.
* The image demo reads the several-tile fixture 256x4104 and writes its
  render as an .avif of several tiles, which cv2 reads to the port's
  pixels.
"""
import functools
import os
import shutil
import time

import cv2
import numpy as np
import pytest
import torch

import av1_witness
import format_writers as fw
from _format_checks import check_against_loaders, read
from semi_detr_tpu_torch import native
from semi_detr_tpu_torch.data import image_io
from test_torch_avif_write import (BYTES_RATIO_MAX, PSNR_SLACK_DB,
                                   host_picture, psnr)

STAGES = ("none", "deblock", "deblock_cdef", "all")
FIXTURES = {"avif_tiles_2x2.avif": (2, 2), "avif_tiles_300x4200.avif": (2, 1),
            "avif_tiles_256x4104.avif": (2, 1)}
# the writer's pictures: wider than 4096 (2x1 tiles), and of over 2304
# superblocks under 4096 wide (1x2): the one large encode of the suite
WRITES = {"wide_256x4104": (256, 4104, (2, 1)),
          "area_2400x3900": (2400, 3900, (1, 2))}


def frame_info(data: bytes) -> dict:
    a = fw.avif_items(data)
    return fw.av1_frame_info(a["items"][a["primary"]]["data"])


def tiles_of(data: bytes):
    f = frame_info(data)
    return f["tile_cols"], f["tile_rows"]


def libaom_tile_fields(info: dict):
    """context_update_tile_id and TileSizeBytes as libaom chooses them from
    its tiles' sizes: the first largest tile, the fewest bytes that hold
    its size."""
    sizes = info["tile_sizes"]
    largest = max(sizes)
    return sizes.index(largest), (largest.bit_length() + 7) // 8


def assert_planes_equal_dav1d(data: bytes, name: str, stages=STAGES):
    for stage in stages:
        got = native.avif_planes(data, stage, name)
        ref = av1_witness.planes(data, stage)
        assert len(got) == len(ref)
        for p, (a, b) in enumerate(zip(got, ref)):
            assert a.shape == b.shape, (name, stage, p)
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {stage} {p}")


# ------------------------------------------------------------ reading

@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_tiles_and_loaders(name, tmp_path):
    """Each committed tile fixture holds the tiles it names, and decodes to
    cv2's pixels and the JAX loader's (image_size agreeing)."""
    data = read(name)
    assert tiles_of(data) == FIXTURES[name]
    assert check_against_loaders(data, tmp_path, name)


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_planes_equal_a_conformant_decoder(name, stage):
    assert_planes_equal_dav1d(read(name), name, (stage,))


@functools.lru_cache(maxsize=None)
def photo_12mp():
    """cv2.imencode's .avif of a 3000x4000 picture at its defaults."""
    img = fw._avif_picture(3000, 4000, 41)
    ok, buf = cv2.imencode(".avif", img)
    assert ok
    return buf.tobytes()


def test_cv2_12mp_photo_reads_as_cv2_reads_it():
    """cv2's own file of a 12 MP photo is 1x2 tiles; the port decodes it to
    cv2's pixels at max abs 0 (image_size agreeing), its planes dav1d's
    with the filters off and with all on; the decode's seconds printed."""
    data = photo_12mp()
    assert tiles_of(data) == (1, 2)
    t0 = time.perf_counter()
    got = native.decode_image(data, "photo_12mp.avif")
    seconds = time.perf_counter() - t0
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert got.shape == (3000, 4000, 3)
    assert np.abs(got.astype(int) - ref[..., ::-1].astype(int)).max() == 0
    assert native.image_size(data, "photo_12mp.avif") == (3000, 4000)
    assert_planes_equal_dav1d(data, "photo_12mp.avif", ("none", "all"))
    print(f"avif 12 MP photo: {len(data)} bytes, 1x2 tiles, decode "
          f"{seconds:.3f} s on one core")


@pytest.mark.parametrize("kind", ["autotiling", "forced_4x2"])
def test_pillow_tiles_read_as_cv2_reads_them(kind, tmp_path):
    """Pillow's autotiled file of a picture 4200 wide (4x1 tiles), and its
    forced 4x2 tiles at 4:4:4: cv2's pixels and the JAX loader's, and
    dav1d's planes with the filters off and on."""
    if kind == "autotiling":
        data = fw.avif_pil(fw._avif_picture(300, 4200, 42), autotiling=True)
        want = (4, 1)
    else:
        data = fw.avif_pil(fw._avif_picture(200, 512, 43), tile_cols=2,
                           tile_rows=1, subsampling="4:4:4", speed=5)
        want = (4, 2)
    assert tiles_of(data) == want
    assert check_against_loaders(data, tmp_path, kind + ".avif")
    assert_planes_equal_dav1d(data, kind, ("none", "all"))


def test_tile_groups_of_tile_group_obus():
    """The same tiles in a frame header OBU and tile group OBUs, one tile
    per group with its start and end given (tile_start_and_end_present_flag),
    decode as the frame OBU does."""
    data = read("avif_tiles_2x2.avif")
    a = fw.avif_items(data)
    item = a["items"][a["primary"]]["data"]
    info = fw.av1_frame_info(item)
    obus = fw.av1_obus(item)
    frame = next(b for t, _, b in obus if t == 6)
    head_bits = fw._Bits(frame).bits[:info["header_end"]]
    head = fw._pack(head_bits)  # frame_header_obu: trailing bits
    p = (info["header_end"] + 7) // 8 + 1
    tiles = []
    for t, size in enumerate(info["tile_sizes"]):
        if t < len(info["tile_sizes"]) - 1:
            p += info["tile_size_bytes"]
        tiles.append(frame[p:p + size])
        p += size
    bits = info["cols_log2"] + info["rows_log2"]
    out = [(t, h, b) for t, h, b in obus if t != 6]
    out.append((3, 3 << 3 | 2, head))
    for t, tile in enumerate(tiles):
        flag = "1" + format(t, f"0{bits}b") * 2
        flag += "0" * (-len(flag) % 8)
        out.append((4, 4 << 3 | 2, bytes(int(flag[i:i + 8], 2)
                                         for i in range(0, len(flag), 8))
                    + tile))
    groups = fw._avif_edit(data, av1=lambda _: fw.av1_join(out))
    assert np.array_equal(native.decode_image(groups, "groups.avif"),
                          native.decode_image(data, "frame.avif"))


def test_damaged_tile_sizes_raise():
    """A tile size past its tile group, or a tile group cut inside a tile's
    size, raises naming the tile."""
    data = read("avif_tiles_2x2.avif")
    info = frame_info(data)
    p = (info["header_end"] + 7) // 8 + 1  # the first tile's size field

    def edit(fn):
        def av1(item):
            obus = fw.av1_obus(item)
            return fw.av1_join([(t, h, fn(b) if t == 6 else b)
                                for t, h, b in obus])
        return fw._avif_edit(data, av1=av1)
    k = info["tile_size_bytes"]
    past = edit(lambda b: b[:p] + b"\xff" * k + b[p + k:])
    with pytest.raises(native.ImageDecodeError, match="tile 0 of"):
        native.decode_image(past, "past.avif")
    cut = edit(lambda b: b[:p + 1] if k > 1 else b[:p])
    with pytest.raises(native.ImageDecodeError, match="tile"):
        native.decode_image(cut, "cut.avif")


# ------------------------------------------------------------ writing

@functools.lru_cache(maxsize=None)
def written(name):
    """(picture, the port's file by write_image, its reconstruction, cv2's
    file, the encode's seconds)."""
    h, w, _ = WRITES[name]
    img = host_picture(h, w, 0)
    t0 = time.perf_counter()
    data, recon = native.avif_encode_planes(img)
    seconds = time.perf_counter() - t0
    ok, ref = cv2.imencode(".avif", np.ascontiguousarray(img[..., ::-1]))
    assert ok
    return img, data, recon, ref.tobytes(), seconds


@pytest.mark.parametrize("name", sorted(WRITES))
def test_write_image_in_cv2s_tiles(name, tmp_path):
    """write_image writes the encoder's file; its tile_info is cv2's for
    the same size, its context_update_tile_id and TileSizeBytes libaom's
    rule of its own tiles' sizes (cv2's file obeying the same rule)."""
    img, data, _, ref, _ = written(name)
    path = str(tmp_path / (name + ".avif"))
    assert image_io.write_image(path, img) == path
    with open(path, "rb") as f:
        assert f.read() == data
    ours, theirs = frame_info(data), frame_info(ref)
    keys = ("uniform", "cols_log2", "rows_log2", "tile_cols", "tile_rows",
            "mi_col_starts", "mi_row_starts", "start_and_end_present")
    assert {k: ours[k] for k in keys} == {k: theirs[k] for k in keys}
    assert (ours["tile_cols"], ours["tile_rows"]) == WRITES[name][2]
    for info in (ours, theirs):
        assert (info["context_update_tile_id"], info["tile_size_bytes"]) == \
            libaom_tile_fields(info)
    print(f"avif tiles {name}: port {ours['tile_sizes']} bytes, tile "
          f"{ours['context_update_tile_id']}, {ours['tile_size_bytes']}-byte "
          f"sizes; cv2 {theirs['tile_sizes']}")


def test_libaom_tile_fields_rule():
    """cv2's files whose largest tile is the last one: context_update_tile_id
    names it, TileSizeBytes holds its size (the rule the writer follows)."""
    rs = np.random.RandomState(44)
    for h, w in ((64, 4200), (16, 4160)):
        img = np.full((h, w, 3), 128, np.uint8)
        img[:, w // 2 + 64:] = rs.randint(0, 256, (h, w - w // 2 - 64, 3))
        ok, buf = cv2.imencode(".avif", img)
        info = frame_info(buf.tobytes())
        sizes = info["tile_sizes"]
        assert len(sizes) == 2 and sizes[1] > sizes[0]
        assert info["context_update_tile_id"] == 1
        assert (1, info["tile_size_bytes"]) == libaom_tile_fields(info)


@pytest.mark.parametrize("name", sorted(WRITES))
def test_cv2_reads_the_reconstruction(name):
    """cv2.imdecode of the port's several-tile file equals the port's
    decode at max abs 0, and the decoder's planes equal the encoder's
    reconstruction and dav1d's."""
    _, data, recon, _, _ = written(name)
    got = native.decode_image(data, name)
    theirs = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert np.abs(theirs[..., ::-1].astype(int) - got.astype(int)).max() == 0
    planes = native.avif_planes(data, "all")
    for a, b, c in zip(recon, planes, av1_witness.planes(data, "all")):
        assert a.shape == b.shape == c.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() == 0
        assert np.abs(c.astype(int) - b.astype(int)).max() == 0


@pytest.mark.parametrize("name", sorted(WRITES))
def test_psnr_and_bytes_against_cv2(name):
    """RGB PSNR at most PSNR_SLACK_DB below cv2's round trip of the same
    picture, the file at most BYTES_RATIO_MAX times cv2's; each figure
    printed with the encode's seconds."""
    img, data, _, ref, seconds = written(name)
    ours = native.decode_image(data, name)
    theirs = cv2.imdecode(np.frombuffer(ref, np.uint8),
                          cv2.IMREAD_COLOR)[..., ::-1]
    p_ours, p_cv2 = psnr(ours, img), psnr(theirs, img)
    ratio = len(data) / len(ref)
    print(f"avif write {name}: {len(data)} bytes, cv2 {len(ref)}, ratio "
          f"{ratio:.4f}; RGB PSNR {p_ours:.4f} dB, cv2 {p_cv2:.4f} dB "
          f"({p_ours - p_cv2:+.4f}); encode {seconds:.3f} s")
    assert p_ours >= p_cv2 - PSNR_SLACK_DB, (p_ours, p_cv2)
    assert ratio <= BYTES_RATIO_MAX, ratio


# ------------------------------------------------------------ the demo

def test_demo_on_a_several_tile_avif(tmp_path):
    """The image demo with a tiny seeded detector on the committed
    256x4104 fixture (cv2's 2x1 tiles): its render is written as .avif in
    2x1 tiles, the encoder's bytes of the render, read back by cv2 to the
    port's pixels at the render's size."""
    from semi_detr_tpu_torch.api import init_detector
    from semi_detr_tpu_torch.tools import image_demo
    from semi_detr_tpu_torch.utils.logging import draw_detection

    cfg = tmp_path / "tiny.py"
    cfg.write_text("model = dict(num_classes=80, num_queries=20, d_model=32,"
                   " n_heads=2, num_encoder_layers=1, num_decoder_layers=1, "
                   "d_ffn=64)\n")
    predictor = init_detector(str(cfg), None, device="cpu", seed=3)
    ckpt = str(tmp_path / "det.pth")
    torch.save({"state_dict": predictor.detector.state_dict()}, ckpt)
    src = tmp_path / "in"
    src.mkdir()
    name = "avif_tiles_256x4104.avif"
    shutil.copy(os.path.join(native.FIXTURES, name), src)
    out = image_demo.main([str(src / "*"), str(cfg), "--checkpoint", ckpt,
                           "--output-dir", str(tmp_path / "out"),
                           "--score-thr", "0.0", "--device", "cpu"])
    assert [os.path.basename(p) for p in out] == [name]
    img = image_io.read_image(str(src / name))
    boxes_, scores, labels = predictor(img, score_thr=0.0)
    render = np.array(img, np.uint8)
    for b, s, l in zip(boxes_, scores, labels):
        draw_detection(render, b, f"{predictor.class_names[int(l)]}:{s:.2f}")
    got = str(tmp_path / "out" / name)
    with open(got, "rb") as f:
        data = f.read()
    assert data == native.encode_avif(render)
    assert tiles_of(data) == (2, 1)
    back = image_io.read_image(got)
    assert back.shape == render.shape
    assert np.array_equal(back, cv2.imread(got, cv2.IMREAD_COLOR)[..., ::-1])
