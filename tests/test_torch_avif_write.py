"""`native.encode_avif` and `data.image_io.write_image` for .avif against
`cv2.imwrite`, which the JAX package's `save_result` calls with no
parameters.

cv2 5.0 writes a colour picture through libavif over libaom 3.14.1 at its
defaults, which are what its IMWRITE_AVIF_QUALITY 50 writes (not 95):
4:2:0, BT.601 full range, base_q_idx 148, chroma delta q -16, quantizer
matrix level 8, deblocking and CDEF, and a qindex per superblock. The
port's encoder (`native/av1_encode.cpp`, `native/avif_encode_host.cpp`)
cannot write libaom's bytes (its rate-distortion decisions), so it is held
to the rest:

* the symbol writer is the exact inverse of the decoder's symbol reader
  (seeded round trips of symbols, booleans, literals and ns values);
* the boxes equal cv2's file of the same size box for box but the item's
  extent and data, the sequence header OBU equals cv2's byte for byte, and
  the frame header carries cv2's base_q_idx, delta q values, quantizer
  matrix levels, deblocking levels and CDEF strengths (each header
  printed);
* the encoder's RGB to YUV 4:2:0 is the one cv2's own files witness
  (libyuv's ARGBToJ420 as libavif runs it; each formula's bias printed);
* cv2.imdecode of every file the port writes equals the port's own decode
  of it at max abs 0 (libavif's decoder witnesses a conformant stream),
  and the encoder's reconstruction equals the decoder's planes at max abs
  0;
* against cv2's own round trip of the same picture: RGB PSNR no more than
  0.5 dB below cv2's from 45x61 up, bytes at most 1.5 times cv2's from
  480x640 up, each figure printed with the encode's seconds;
* two encodes give the same bytes, and the committed sha256 and length
  of each picture's file (`native/fixtures/avif_writes.json`, which
  `chip_smoke.py` phase 7a holds the card's host to) are this encoder's;
* the image demo writes an .avif render of an AVIF input under its name.

Run as a script to rewrite avif_writes.json:

    PYTHONPATH=. python tests/test_torch_avif_write.py
"""
import functools
import hashlib
import json
import os
import struct
import time

import cv2
import numpy as np
import pytest
import torch

from semi_detr_tpu_torch import native
from semi_detr_tpu_torch.data import image_io

FIXTURE_JSON = os.path.join(native.FIXTURES, "avif_writes.json")
# the picture set: host_picture at a photo's size and at the edge sizes
# (a pixel, odd sides, partial superblocks), the committed jp2w_*.png
# pictures and one render.json render
HOST_PICTURES = ((480, 640), (800, 1344))
EDGE_SIZES = ((1, 1), (2, 3), (45, 61), (65, 129))
PNG_PICTURES = ("jp2w_noise_48x64.png", "jp2w_over_budget_64x64.png",
                "jp2w_smooth_48x64.png", "render_coco80.png")
PSNR_SLACK_DB = 0.5      # below cv2's round trip, from 45x61 up
BYTES_RATIO_MAX = 1.5    # of cv2's file, from 480x640 up


def host_picture(h, w, seed):
    """chip_smoke.host_picture: seeded noise over gradients."""
    rs = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    base = (xs // 3 + ys // 2)[..., None] + 60 * np.arange(3)
    return ((base + rs.randint(0, 40, (h, w, 3))) % 256).astype(np.uint8)


def pictures():
    """name -> (H, W, 3) RGB of the picture set."""
    out = {}
    for h, w in HOST_PICTURES + EDGE_SIZES:
        out[f"host_picture_{h}x{w}"] = host_picture(h, w, 0)
    for name in PNG_PICTURES:
        out[name] = image_io.read_image(os.path.join(native.FIXTURES, name))
    return out


@functools.lru_cache(maxsize=None)
def encoded(name):
    """(picture, the port's file, its reconstruction, cv2's file, the
    encode's seconds on this machine)."""
    img = pictures()[name]
    t0 = time.perf_counter()
    data, recon = native.avif_encode_planes(img)
    seconds = time.perf_counter() - t0
    ok, ref = cv2.imencode(".avif", np.ascontiguousarray(img[..., ::-1]))
    assert ok
    return img, data, recon, ref.tobytes(), seconds


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255 ** 2 / mse)


# ------------------------------------------------------------ the syntax

def boxes(d, start=0, end=None):
    """[(type, body)] of the boxes in d[start:end], meta, iinf, iprp and
    ipco opened (each followed by its children)."""
    end = len(d) if end is None else end
    out, p = [], start
    while p < end:
        size, typ = struct.unpack(">I4s", d[p:p + 8])
        typ = typ.decode()
        out.append((typ, d[p + 8:p + size]))
        skip = {"meta": 4, "iinf": 6, "iprp": 0, "ipco": 0}.get(typ)
        if skip is not None:
            out += boxes(d, p + 8 + skip, p + size)
        p += size
    return out


def obus(item):
    """[(type, payload)] of a temporal unit's OBUs (each with its size)."""
    out, p = [], 0
    while p < len(item):
        typ = (item[p] >> 3) & 15
        q, size, shift = p + 1, 0, 0
        while True:
            size |= (item[q] & 0x7f) << shift
            shift += 7
            q += 1
            if not item[q - 1] & 0x80:
                break
        out.append((typ, item[q:q + size]))
        p = q + size
    return out


def item_data(d):
    return dict(boxes(d))["mdat"]


class Bits:
    def __init__(self, d):
        self.d, self.p = d, 0

    def f(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | ((self.d[self.p >> 3] >> (7 - (self.p & 7))) & 1)
            self.p += 1
        return v

    def su(self, n):
        v = self.f(n)
        return v - (1 << n) if v >> (n - 1) else v


def frame_header(frame, h, w):
    """The fields of a key frame's uncompressed header under the reduced
    still-picture sequence header cv2 writes (no screen content, one tile,
    CDEF on, loop restoration off): base_q_idx, the delta q values
    [DeltaQYDc, DeltaQUDc, DeltaQUAc], the quantizer matrix levels [y, u],
    delta q per superblock (present, res), the loop filter levels and
    sharpness, CDEF's damping and strengths, TX_MODE_SELECT."""
    r = Bits(frame)
    r.f(3)  # disable_cdf_update, allow_screen_content_tools, render size
    assert r.f(1) == 1  # uniform_tile_spacing_flag
    sb_cols, sb_rows = (w + 63) // 64, (h + 63) // 64
    for n in (sb_cols, sb_rows):
        if n > 1:  # one increment bit, 0
            assert r.f(1) == 0
    out = {"base_q_idx": r.f(8),
           "delta_q": [r.su(7) if r.f(1) else 0 for _ in range(3)]}
    out["qm"] = [r.f(4), r.f(4)] if r.f(1) else []
    assert r.f(1) == 0  # segmentation_enabled
    present = r.f(1)
    out["delta_q_present"] = [present, r.f(2) if present else 0]
    if present:
        assert r.f(1) == 0  # delta_lf_present
    lf = [r.f(6), r.f(6)]
    if lf[0] or lf[1]:
        lf += [r.f(6), r.f(6)]
    out["loop_filter"] = lf + [r.f(3)]  # the levels, sharpness
    if r.f(1) and r.f(1):  # loop_filter_delta_enabled, _update
        raise AssertionError("loop filter delta update")
    damping, bits = r.f(2) + 3, r.f(2)
    out["cdef"] = [damping] + [[r.f(4), r.f(2), r.f(4), r.f(2)]
                               for _ in range(1 << bits)]
    out["tx_mode_select"] = r.f(1)
    return out


def quantizer(frame, h, w):
    """(base_q_idx, delta q values, quantizer matrix levels)."""
    f = frame_header(frame, h, w)
    return f["base_q_idx"], f["delta_q"], f["qm"]


# ------------------------------------------------------------ tests

@pytest.mark.parametrize("seed", range(4))
def test_symbol_writer_inverts_the_reader(seed):
    """Seeded symbols of adaptive CDFs (2 to 16 symbols), booleans,
    literals and ns values, written by the encoder's SymbolWriter, read
    back by the decoder's SymbolReader; the reader stays in the tile."""
    rs = np.random.RandomState(seed)
    n = 3000
    kinds = rs.randint(0, 4, n)
    # a skewed stream: most symbols small, so the CDFs adapt
    ns = np.where(kinds == 0, rs.randint(2, 17, n),
                  np.where(kinds == 2, rs.randint(1, 17, n),
                           rs.randint(2, 3000, n)))
    values = np.array([
        min(int(rs.geometric(0.5)) - 1, m - 1) if k == 0 else
        rs.randint(0, 2) if k == 1 else
        rs.randint(0, 1 << m) if k == 2 else rs.randint(0, m)
        for k, m in zip(kinds, ns)])
    data, back, over = native.av1_symbol_round_trip(kinds, ns, values)
    assert np.array_equal(back, values)
    assert not over and len(data) > 0


@pytest.mark.parametrize("name", sorted(pictures()))
def test_boxes_and_headers_are_cv2s(name):
    """Every box equals cv2's but iloc's extent and mdat; the sequence
    header OBU equals cv2's; the frame carries cv2's quantizer."""
    img, data, _, ref, _ = encoded(name)
    ours, theirs = boxes(data), boxes(ref)
    assert [t for t, _ in ours] == [t for t, _ in theirs]
    for (t, a), (_, b) in zip(ours, theirs):
        if t == "iloc":
            assert a[:-8] == b[:-8]  # all but extent offset and length
        elif t not in ("mdat", "meta", "iinf", "iprp", "ipco"):
            assert a == b, t
    a_obus, b_obus = obus(item_data(data)), obus(item_data(ref))
    assert [t for t, _ in a_obus] == [t for t, _ in b_obus] == [2, 1, 6]
    assert a_obus[1][1] == b_obus[1][1]  # the sequence header
    h, w = img.shape[:2]
    q_ours = quantizer(a_obus[2][1], h, w)
    assert q_ours == quantizer(b_obus[2][1], h, w)
    assert q_ours == (148, [0, -16, -16], [8, 8])
    # and cv2's in-loop filters: deblocking 15 at sharpness 1, CDEF damping
    # 5 of one strength
    ours, theirs = (frame_header(o[2][1], h, w) for o in (a_obus, b_obus))
    assert ours["loop_filter"] == theirs["loop_filter"] == [15] * 4 + [1]
    assert ours["cdef"] == theirs["cdef"] == [5, [2, 1, 0, 0]]
    print(f"avif header {name}: cv2 {theirs}; port {ours}")


@pytest.mark.parametrize("name", sorted(pictures()))
def test_cv2_reads_the_ports_pixels(name):
    """Conformance: cv2.imdecode of the port's file equals the port's
    decode at max abs 0; the encoder's reconstruction is the decoder's
    planes."""
    _, data, recon, _, _ = encoded(name)
    got = native.decode_image(data, name)
    theirs = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert theirs is not None
    assert np.abs(theirs[..., ::-1].astype(int) - got.astype(int)).max() == 0
    for a, b in zip(recon, native.avif_planes(data, "all")):
        assert a.shape == b.shape
        assert np.abs(a.astype(int) - b.astype(int)).max() == 0


@pytest.mark.parametrize("name", sorted(pictures()))
def test_psnr_and_bytes_against_cv2(name):
    """The port's RGB PSNR is at most PSNR_SLACK_DB below cv2's round trip
    of the same picture (from 45x61 up), its file at most BYTES_RATIO_MAX
    times cv2's (from 480x640 up); each figure printed."""
    img, data, _, ref, seconds = encoded(name)
    ours = native.decode_image(data, name)
    theirs = cv2.imdecode(np.frombuffer(ref, np.uint8),
                          cv2.IMREAD_COLOR)[..., ::-1]
    p_ours, p_cv2 = psnr(ours, img), psnr(theirs, img)
    ratio = len(data) / len(ref)
    max_abs = int(np.abs(ours.astype(int) - img.astype(int)).max())
    print(f"avif write {name} {img.shape[0]}x{img.shape[1]}: "
          f"{len(data)} bytes, cv2 {len(ref)}, ratio {ratio:.4f}; RGB PSNR "
          f"{p_ours:.4f} dB, cv2 {p_cv2:.4f} dB ({p_ours - p_cv2:+.4f}); "
          f"max abs {max_abs}; encode {seconds:.3f} s")
    h, w = img.shape[:2]
    if h * w >= 45 * 61:
        assert p_ours >= p_cv2 - PSNR_SLACK_DB, (p_ours, p_cv2)
    if h * w >= 480 * 640:
        assert ratio <= BYTES_RATIO_MAX, ratio


def test_colour_conversion_is_libyuvs():
    """The RGB to YUV 4:2:0 the encoder takes (av1_encode.cpp's to_yuv,
    libyuv's ARGBToJ420 as libavif runs it for BT.601 full range) against
    cv2's own: cv2.imwrite's files at quality 99 of flat 64x64 blocks of
    seeded colours (Y, U and V held at the blocks' centres) and of one 2x2
    cell repeated over each block (U and V, the cell's average), decoded by
    the port's AV1 decoder. Compression leaves +-1 in the samples, so each
    formula is read by its bias and its share of exact samples: the one
    taken is the least biased (|mean| under 0.1, where rounding with 0x8080
    is off by half a level) and the most often exact; each figure
    printed."""
    rs = np.random.RandomState(1)
    side, size = 64, 512
    errs = {}

    def note(key, got, want):
        errs.setdefault(key, []).extend((got - want).ravel().tolist())

    def sample(img):
        ok, buf = cv2.imencode(".avif", np.ascontiguousarray(
            img.astype(np.uint8)[..., ::-1]), [cv2.IMWRITE_AVIF_QUALITY, 99])
        y, u, v = (a.astype(np.int64) for a in native.avif_planes(
            buf.tobytes(), "all"))
        c = side // 2
        return (y[side // 2::side, side // 2::side], u[c // 2::c, c // 2::c],
                v[c // 2::c, c // 2::c])

    def uv(r, g, b, off):
        return ((127 * b - 84 * g - 43 * r + off) >> 8,
                (127 * r - 107 * g - 20 * b + off) >> 8)

    for _ in range(4):
        flat = rs.randint(0, 256, (size // side, size // side, 3))
        y, u, v = sample(np.repeat(np.repeat(flat, side, 0), side, 1))
        r, g, b = flat[..., 0], flat[..., 1], flat[..., 2]
        note("Y (77 R + 150 G + 29 B + 128) >> 8", y,
             (77 * r + 150 * g + 29 * b + 128) >> 8)
        note("Y (38 R + 75 G + 15 B + 64) >> 7", y,
             (38 * r + 75 * g + 15 * b + 64) >> 7)
        cells = rs.randint(0, 256, (size // side, size // side, 2, 2, 3))
        img = np.zeros((size, size, 3), np.int64)
        for i in range(size // side):
            for j in range(size // side):
                img[i * side:(i + 1) * side, j * side:(j + 1) * side] = \
                    np.tile(cells[i, j], (side // 2, side // 2, 1))
        _, u, v = sample(img)
        p = [cells[:, :, a, b_] for a in (0, 1) for b_ in (0, 1)]
        avgb = lambda a, b_: (a + b_ + 1) >> 1  # noqa: E731
        means = {"(sum + 2) >> 2": (p[0] + p[1] + p[2] + p[3] + 2) >> 2,
                 "AVGB pairs": avgb(avgb(p[0], p[2]), avgb(p[1], p[3]))}
        for how, m in means.items():
            for off in (0x8000, 0x8080):
                wu, wv = uv(m[..., 0], m[..., 1], m[..., 2], off)
                note(f"UV {how}, + {off:#x}", np.concatenate([u, v]),
                     np.concatenate([wu, wv]))
    stats = {k: (float(np.mean(e)), float(np.mean(np.array(e) == 0)))
             for k, e in errs.items()}
    for k, (bias, exact) in stats.items():
        print(f"colour witness {k}: bias {bias:+.4f}, exact {exact:.4f}")
    taken_y, taken_uv = ("Y (77 R + 150 G + 29 B + 128) >> 8",
                         "UV (sum + 2) >> 2, + 0x8000")
    assert abs(stats[taken_y][0]) < 0.1 and stats[taken_y][1] == max(
        v[1] for k, v in stats.items() if k.startswith("Y"))
    assert abs(stats[taken_uv][0]) < 0.1 and stats[taken_uv][1] == max(
        v[1] for k, v in stats.items() if k.startswith("UV"))
    assert abs(stats["UV (sum + 2) >> 2, + 0x8080"][0]) > 0.3


def test_encode_is_deterministic():
    img = pictures()["host_picture_45x61"]
    assert native.encode_avif(img) == native.encode_avif(img)
    assert native.encode_avif(img) == encoded("host_picture_45x61")[1]


def test_committed_writes_are_this_encoders():
    """avif_writes.json (what chip_smoke.py holds the card's host to): the
    length and sha256 of each picture's file and of its decode."""
    with open(FIXTURE_JSON) as f:
        spec = json.load(f)
    assert spec["pictures"] == expected_rows()


def expected_rows():
    rows = []
    for name, img in pictures().items():
        data = encoded(name)[1]
        rows.append(dict(name=name, h=img.shape[0], w=img.shape[1],
                         bytes=len(data),
                         sha256=hashlib.sha256(data).hexdigest(),
                         decode_sha256=hashlib.sha256(native.decode_image(
                             data, name).tobytes()).hexdigest()))
    return rows


def test_write_image_avif(tmp_path):
    """write_image writes the encoder's file; cv2.imwrite's file of the
    same picture has the same boxes around a tile of its own."""
    img = pictures()["host_picture_65x129"]
    path = str(tmp_path / "a.avif")
    assert image_io.write_image(path, img) == path
    with open(path, "rb") as f:
        assert f.read() == encoded("host_picture_65x129")[1]
    cv2_path = str(tmp_path / "b.avif")
    assert cv2.imwrite(cv2_path, np.ascontiguousarray(img[..., ::-1]))
    with open(cv2_path, "rb") as f:
        assert f.read() == encoded("host_picture_65x129")[3]


def test_demo_writes_avif_renders(tmp_path):
    """The image demo on the two committed AVIF fixtures with a tiny
    seeded detector: each render written as .avif under its input's name,
    read back by cv2 to the port's pixels, within PSNR_SLACK_DB of cv2's
    round trip of the render's pixels."""
    import shutil

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
    inputs = ("avif_480x640.avif", "avif_lossy_480x640.avif")
    for name in inputs:
        shutil.copy(os.path.join(native.FIXTURES, name), src)
    out = image_demo.main([str(src / "*"), str(cfg), "--checkpoint", ckpt,
                           "--output-dir", str(tmp_path / "out"),
                           "--score-thr", "0.0", "--device", "cpu"])
    assert [os.path.basename(p) for p in out] == sorted(inputs)
    assert sorted(os.listdir(tmp_path / "out")) == sorted(inputs)
    for name in inputs:
        img = image_io.read_image(str(src / name))
        boxes_, scores, labels = predictor(img, score_thr=0.0)
        render = np.array(img, np.uint8)
        for b, s, l in zip(boxes_, scores, labels):
            draw_detection(render, b,
                           f"{predictor.class_names[int(l)]}:{s:.2f}")
        got = str(tmp_path / "out" / name)
        with open(got, "rb") as f:
            data = f.read()
        assert data == native.encode_avif(render), name
        back = image_io.read_image(got)
        assert np.array_equal(back, cv2.imread(got, cv2.IMREAD_COLOR)[
            ..., ::-1]), name
        ok, ref = cv2.imencode(".avif", np.ascontiguousarray(
            render[..., ::-1]))
        theirs = cv2.imdecode(ref, cv2.IMREAD_COLOR)[..., ::-1]
        p_ours, p_cv2 = psnr(back, render), psnr(theirs, render)
        print(f"demo render {name}: {len(data)} bytes, cv2 {len(ref)}; "
              f"PSNR {p_ours:.4f} dB, cv2 {p_cv2:.4f} dB")
        assert p_ours >= p_cv2 - PSNR_SLACK_DB, name


def write_fixtures():
    """avif_writes.json: the length and sha256 of this encoder's file of
    each picture and of the port's decode of it."""
    spec = {"encoder": "native.encode_avif (av1_encode.cpp): cv2.imwrite's "
                       "defaults, base_q_idx 148, the library's own tile",
            "pictures": expected_rows()}
    with open(FIXTURE_JSON, "w") as f:
        json.dump(spec, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    write_fixtures()
