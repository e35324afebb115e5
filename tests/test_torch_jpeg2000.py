"""JPEG 2000: the host library's decoder (`native/j2k_host.cpp`) against the
JAX package's loader, which hands `.jp2` and `.j2k` files to
`cv2.imread(path, IMREAD_COLOR)` (cv2 5.0, OpenJPEG 2.5.3).

The committed fixtures (`j2k_*` written by Pillow's OpenJPEG encoder,
`j2kw_*` by `tools.raw_formats`, `other_jp2.jp2` by cv2.imencode, with
`formats.json`) decode to their stored cv2 pixels, to live cv2.imread and
to the JAX loader's at max abs 0; what cv2 refuses raises saying so. They
cover both wavelets, the RCT and the ICT, the five progression orders and
POC, tiles of odd sizes, precincts, every code-block style bit, several
layers (and layers cut by Pillow's rate allocation), RGN, PPM / PPT, SOP /
EPH, interleaved tile-parts, COC / QCC, gray, gray + alpha, RGBA, 16- and
12-bit, mixed precisions, palettes, channel definitions, the colour
specifications cv2 tells apart, and raw codestreams. A seeded grid over
Pillow's encode options at 32x32 or less is held to cv2.imread; the
`tools.raw_formats` fixtures are regenerated byte for byte; copies cut at
each marker of a stream decode as cv2 does or raise as it raises; the JAX
loader and the port's `CocoDataset.load_image` (and its prefetch loader)
agree on a COCO folder of JPEG 2000 files.

`python tests/test_torch_jpeg2000.py` rewrites the fixtures and their cv2
references, and their `formats.json` entries.
"""
import io
import json
import os

import numpy as np
import pytest

from _format_checks import check_against_cv2, check_fixture, fixture_params
from format_writers import committed, cv2_rgb, jax_load_images
from semi_detr_tpu_torch import native
from semi_detr_tpu_torch.tools import raw_formats

PREFIXES = ("j2k_", "j2kw_", "other_jp2")


def _pil(arr, **kw) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def pil_files():
    """{name: (bytes, format, variant, expect)} of the fixtures Pillow
    writes (the host library's decode is held to cv2 on each)."""
    a = raw_formats._picture(32, 32, 21)
    rng = np.random.default_rng(22)
    prc = dict(precinct_size=(8, 8), num_resolutions=3)
    lay = [60.0, 30.0, 10.0]
    cases = {
        "j2k_rev.jp2": (a, {}, "5/3, RCT, defaults"),
        "j2k_irr.jp2": (a, dict(irreversible=True), "9/7, ICT"),
        "j2k_raw.j2k": (a, dict(no_jp2=True), "raw codestream"),
        "j2k_tiles_rev.jp2": (a, dict(tile_size=(13, 11),
                                      num_resolutions=3),
                              "13x11 tiles, 5/3"),
        "j2k_tiles_irr.jp2": (a, dict(tile_size=(13, 11), num_resolutions=3,
                                      irreversible=True), "13x11 tiles, 9/7"),
        "j2k_rlcp.jp2": (a, dict(progression="RLCP", quality_layers=lay,
                                 irreversible=True, **prc),
                         "RLCP, precincts, 3 layers cut by rate, 9/7"),
        "j2k_rpcl.jp2": (a, dict(progression="RPCL", quality_layers=lay,
                                 **prc), "RPCL, precincts, 3 layers"),
        "j2k_pcrl.jp2": (a, dict(progression="PCRL", quality_layers=lay,
                                 irreversible=True, **prc),
                         "PCRL, precincts, 3 layers, 9/7"),
        "j2k_cprl.jp2": (a, dict(progression="CPRL", quality_layers=lay,
                                 **prc), "CPRL, precincts, 3 layers"),
        "j2k_lossy_layers.jp2": (a, dict(quality_layers=[80.0, 40.0, 20.0],
                                         irreversible=True),
                                 "9/7, 3 layers cut by rate"),
        "j2k_cblk_4x16.jp2": (a, dict(codeblock_size=(4, 16)),
                              "4x16 code-blocks"),
        "j2k_no_mct.jp2": (a, dict(mct=0), "no colour transform"),
        "j2k_plt_comment.jp2": (a, dict(plt=True, comment="fixture"),
                                "PLT and COM markers"),
        "j2k_gray.jp2": (a[..., 1].copy(), {}, "gray"),
        "j2k_gray_alpha.jp2": (np.dstack([a[..., 1], a[..., 2]]), {},
                               "gray + alpha"),
        "j2k_rgba.jp2": (np.dstack([a, rng.integers(0, 256, (32, 32),
                                                    dtype=np.uint8)]),
                         dict(irreversible=True), "RGBA, 9/7"),
        "j2k_gray16.jp2": ((a[..., 0].astype(np.uint16) * 257 +
                            rng.integers(0, 256, (32, 32))).astype(np.uint16),
                           {}, "16-bit gray"),
        "j2k_480x640_lossless.jp2": (raw_formats._picture(480, 640, 23, 3),
                                     {}, "480x640, 5/3"),
        "j2k_480x640_lossy.jp2": (raw_formats._picture(480, 640, 24, 3),
                                  dict(irreversible=True,
                                       quality_layers=[20.0]),
                                  "480x640, 9/7 at 20:1"),
        "j2k_offset.jp2": (a, dict(offset=(3, 5), tile_offset=(2, 2),
                                   tile_size=(16, 16)),
                           "image and tile offsets"),
        "j2k_signed.jp2": (a, dict(signed=True), "signed components"),
        "j2k_raw_gray.j2k": (a[..., 0].copy(), dict(no_jp2=True),
                             "one component, no colour space"),
    }
    out = {}
    for name, (arr, kw, variant) in cases.items():
        data = _pil(arr, **kw)
        fmt = "JPEG 2000 (codestream)" if name.endswith(".j2k") \
            else "JPEG 2000 (JP2)"
        out[name] = (data, fmt, variant, "refused" if name in (
            "j2k_offset.jp2", "j2k_signed.jp2", "j2k_raw_gray.j2k")
            else "pixels")
    return out


def write_fixtures(root: str = native.FIXTURES):
    import cv2
    with open(os.path.join(root, "formats.json")) as f:
        index = json.load(f)
    files = pil_files()
    files.update(raw_formats.jpeg2000_files())
    for name, (data, fmt, variant, expect) in files.items():
        path = os.path.join(root, name)
        with open(path, "wb") as f:
            f.write(data)
        ref = cv2.imread(path, cv2.IMREAD_COLOR)
        assert (ref is not None) == (expect == "pixels"), name
        if ref is not None:
            cv2.imwrite(path.rsplit(".", 1)[0] + ".ref.png", ref)
        index[name] = {"format": fmt, "variant": variant, "expect": expect,
                       "route": "jpeg2000" if expect == "pixels" else None}
    ref = cv2.imread(os.path.join(root, "other_jp2.jp2"), cv2.IMREAD_COLOR)
    cv2.imwrite(os.path.join(root, "other_jp2.ref.png"), ref)
    index["other_jp2.jp2"].update(expect="pixels", route="jpeg2000")
    with open(os.path.join(root, "formats.json"), "w") as f:
        json.dump(index, f, indent=1, sort_keys=True)


def _read(name):
    with open(os.path.join(native.FIXTURES, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name,entry", fixture_params(PREFIXES))
def test_fixture(name, entry):
    check_fixture(name, entry)


@pytest.mark.parametrize("name,entry", fixture_params(PREFIXES))
def test_fixture_against_live_cv2(name, entry, tmp_path):
    pytest.importorskip("cv2")
    assert check_against_cv2(_read(name), tmp_path, name) == (
        entry["expect"] == "pixels")


def test_raw_formats_regenerates_its_fixtures():
    index = committed(("j2kw_",))
    files = raw_formats.jpeg2000_files()
    assert sorted(files) == sorted(index)
    for name, (data, fmt, variant, expect) in files.items():
        assert data == _read(name), name
        assert index[name]["expect"] == expect, name


def _grid_case(rng):
    h, w = int(rng.integers(2, 33)), int(rng.integers(2, 33))
    kw = {}
    if rng.random() < 0.5:
        kw["irreversible"] = True
    nres = int(rng.integers(1, 7))
    kw["num_resolutions"] = min(nres, int(np.log2(min(h, w))) + 1)
    if rng.random() < 0.5:
        kw["progression"] = ("LRCP", "RLCP", "RPCL", "PCRL",
                             "CPRL")[int(rng.integers(5))]
    if rng.random() < 0.3:
        ts = (int(rng.integers(4, 33)), int(rng.integers(4, 33)))
        if w % ts[0] != 1 and h % ts[1] != 1:
            kw["tile_size"] = ts
    if rng.random() < 0.3:
        kw["codeblock_size"] = (2 ** int(rng.integers(2, 7)),
                                2 ** int(rng.integers(2, 7)))
    if rng.random() < 0.3:
        kw["precinct_size"] = (2 ** int(rng.integers(3, 8)),) * 2
    if rng.random() < 0.4:
        kw["quality_layers"] = sorted(
            (float(rng.integers(2, 60)) for _ in range(
                int(rng.integers(1, 4)))), reverse=True)
    if rng.random() < 0.2:
        kw["mct"] = 0
    kind = ("rgb", "rgb", "rgb", "gray", "rgba", "gray16")[
        int(rng.integers(6))]
    return h, w, kind, kw


def _grid_array(i, h, w, kind):
    a = raw_formats._picture(h, w, 100 + i)
    return {"rgb": a, "gray": a[..., 0].copy(),
            "rgba": np.dstack([a, a[..., 1]]),
            "gray16": a[..., 0].astype(np.uint16) * 257}[kind]


def _grid():
    """24 seeded option sets of Pillow's OpenJPEG encoder at 32x32 or less
    (the sets it refuses to encode are drawn again)."""
    rng = np.random.default_rng(25)
    cases = []
    while len(cases) < 24:
        i = len(cases)
        h, w, kind, kw = _grid_case(rng)
        try:
            _pil(_grid_array(i, h, w, kind), **kw)
        except ImportError:  # no Pillow: no grid
            break
        except OSError:
            continue
        cases.append(pytest.param(i, h, w, kind, kw, id=f"{i}-{kind}"))
    return cases


@pytest.mark.parametrize("i,h,w,kind,kw", _grid())
def test_seeded_pillow_grid(i, h, w, kind, kw, tmp_path):
    check_against_cv2(_pil(_grid_array(i, h, w, kind), **kw), tmp_path,
                      f"grid_{i}.jp2")


def _writer_grid():
    """12 seeded option sets of `tools.raw_formats.j2k_codestream`: sizes
    from 1 to 25, 0-4 levels, every code-block style bit, 1-3 layers,
    precincts, progressions and POC, tiles, tile-parts, SOP / EPH, PPM /
    PPT, RGN, 3 or 4 components."""
    rng = np.random.default_rng(26)
    cases = []
    for i in range(12):
        h, w = int(rng.integers(1, 26)), int(rng.integers(1, 26))
        nc = int(rng.choice([3, 3, 4]))
        levels = int(rng.integers(0, 5))
        cbw, cbh = int(rng.integers(2, 7)), int(rng.integers(2, 7))
        kw = dict(levels=levels, cblk=(min(cbw, 12 - cbh), cbh),
                  style=int(rng.integers(0, 64)),
                  layers=int(rng.integers(1, 4)),
                  mct=bool(rng.random() < 0.7))
        if rng.random() < 0.5:
            kw["precincts"] = [(int(rng.integers(1, 6)),
                                int(rng.integers(1, 6)))
                               for _ in range(levels + 1)]
        if rng.random() < 0.3:
            kw["pocs"] = [(0, 0, int(rng.integers(1, 4)),
                           int(rng.integers(1, levels + 2)), nc,
                           int(rng.integers(0, 5))),
                          (0, 0, 3, levels + 1, nc, int(rng.integers(0, 5)))]
        else:
            kw["progression"] = int(rng.integers(0, 5))
        if rng.random() < 0.4:
            kw["tile"] = (int(rng.integers(3, 20)), int(rng.integers(3, 20)))
        kw["sop"], kw["eph"] = bool(rng.random() < 0.3), bool(
            rng.random() < 0.3)
        r = rng.random()
        if r < 0.2:
            kw["ppt"] = True
        elif r < 0.4:
            kw["ppm"] = True
        if rng.random() < 0.3 and not kw.get("ppm"):
            kw["tile_parts"] = 2
        if rng.random() < 0.2 and not kw["style"] & raw_formats.BYPASS:
            kw["roi"] = (12, 0.5)
        cases.append(pytest.param(i, h, w, nc, kw, id=str(i)))
    return cases


@pytest.mark.parametrize("i,h,w,nc,kw", _writer_grid())
def test_seeded_writer_grid(i, h, w, nc, kw, tmp_path):
    """Each stream decodes to cv2.imread's pixels, which are the picture
    (the writer is lossless)."""
    a = raw_formats._picture(h, w, 200 + i, 40)
    planes = [a[..., c] for c in range(3)] + [a[..., 0] // 2] * (nc - 3)
    data = raw_formats.j2k_codestream(planes, **kw)
    assert check_against_cv2(data, tmp_path, f"writer_{i}.j2k")
    np.testing.assert_array_equal(native.decode_image(data), a)


def _markers(data: bytes):
    """The offsets of a codestream's marker segments, and half-way into
    each tile-part's data (a JP2 file's codestream box included)."""
    at = data.find(b"\xff\x4f\xff\x51")
    cuts, pos = [at + 2], at + 2
    while pos + 4 <= len(data):
        m = int.from_bytes(data[pos:pos + 2], "big")
        cuts.append(pos)
        if m == 0xFFD9:
            break
        seg = int.from_bytes(data[pos + 2:pos + 4], "big")
        if m == 0xFF90:
            psot = int.from_bytes(data[pos + 6:pos + 10], "big")
            cuts.append(pos + psot // 2)
            pos += psot
            continue
        pos += 2 + seg
    return cuts


TRUNCATED = ("j2k_rev.jp2", "j2k_tiles_irr.jp2", "j2k_raw.j2k",
             "j2kw_ppm.j2k", "j2kw_tile_parts.j2k", "j2kw_palette.jp2")


@pytest.mark.parametrize("name", TRUNCATED)
def test_truncated_at_each_marker(name, tmp_path):
    """Each copy cut at a marker (or half-way into a tile-part's data, or
    just before EOC) decodes to cv2's pixels where cv2 reads it, and raises
    ImageDecodeError naming the file where cv2 refuses it."""
    pytest.importorskip("cv2")
    data = _read(name)
    cuts = sorted(set(_markers(data) + [len(data) - 2, 8, 40]))
    read = 0
    for n in cuts:
        stem, ext = name.rsplit(".", 1)
        read += check_against_cv2(data[:n], tmp_path, f"{stem}_{n}.{ext}")
    assert read < len(cuts)


def test_jax_loader_and_load_image_on_a_coco_folder(tmp_path):
    """A COCO folder of JPEG 2000 files: the JAX package's
    CocoDataset.load_image (cv2.imread) and the port's, and the port's
    prefetch loader, give the same pixels."""
    from semi_detr_tpu_torch.data.coco import CocoDataset
    names = ["j2k_rev.jp2", "j2k_irr.jp2", "j2k_raw.j2k", "j2k_rgba.jp2",
             "j2k_gray16.jp2", "j2kw_palette.jp2", "j2kw_colr_18.jp2"]
    for n in names:
        with open(tmp_path / n, "wb") as f:
            f.write(_read(n))
    jax = jax_load_images(str(tmp_path), names)
    ann = {"images": [{"id": i + 1, "file_name": n, "width": 1, "height": 1}
                      for i, n in enumerate(names)],
           "annotations": [], "categories": [{"id": 1, "name": "person"}]}
    ds = CocoDataset(ann, str(tmp_path), classes=("person",),
                     filter_empty_gt=False, test_mode=True)
    loader = native.PrefetchLoader(2)
    for i, n in enumerate(names):
        got = ds.load_image(i)
        assert isinstance(jax[n], np.ndarray), (n, jax[n])
        np.testing.assert_array_equal(got, jax[n], err_msg=n)
        loader.submit(i, str(tmp_path / n))
    for _ in names:
        item = loader.next()
        np.testing.assert_array_equal(item.image, jax[names[item.index]])
    loader.close()


def test_decoders_name_the_route():
    assert "JPEG 2000" in native.decoders()["jpeg2000"]


def test_avif_still_not_ported():
    """AV1 film grain, which cv2's files never carry, stays refused naming
    the format and "not ported" (cv2's own AVIF, `other_avif.avif`, which
    this refused before, now reads to cv2's pixels)."""
    from test_torch_avif_lossy import _edit
    data = _edit(_read("avif_lossy_480x640.avif"), "film_grain")
    with pytest.raises(native.ImageDecodeError, match="AVIF.*film grain.*not ported"):
        native.decode_image(data, "grain.avif")


def test_damaged_copies_raise_naming_the_file(tmp_path):
    """Code-block data overwritten, a tile-part length past the end, a
    JP2 box past the end: each raises naming the file, or (where OpenJPEG
    decodes the damage without complaint) decodes to cv2's pixels."""
    data = bytearray(_read("j2k_rev.jp2"))
    sot = data.find(b"\xff\x90")
    bad_len = bytearray(data)
    bad_len[sot + 6:sot + 10] = (len(data)).to_bytes(4, "big")
    cases = {"psot_past_end.jp2": bytes(bad_len),
             "box_past_end.jp2": bytes(data[:40]) + b"\0" * 8}
    for n, d in cases.items():
        with pytest.raises(native.ImageDecodeError, match=n):
            native.decode_image(d, n)
    scrambled = bytearray(data)
    scrambled[sot + 40:sot + 60] = b"\x00" * 20
    if cv2_rgb(bytes(scrambled), str(tmp_path)) is not None:
        check_against_cv2(bytes(scrambled), tmp_path, "scrambled.jp2")


if __name__ == "__main__":
    write_fixtures()
