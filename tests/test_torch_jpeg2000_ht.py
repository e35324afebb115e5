"""High-throughput JPEG 2000 (ITU-T T.814 / ISO/IEC 15444-15): the host
library's decoder (`native/j2k_host.cpp`'s tier-2, `native/j2k_ht_host.cpp`'s
block decoder) against the JAX package's loader, which hands HTJ2K files
to `cv2.imread(path, IMREAD_COLOR)` (cv2 5.0, OpenJPEG 2.5.3).

`tools.ht_vlc_table` regenerates `native/j2k_ht_tables.h` from cv2's
binary byte for byte. The committed fixtures (`j2kh_*`, written by
`tools.raw_formats`' HT block coder, with `formats.json`) are regenerated
byte for byte; cv2 reads each lossless one back to its picture (the
witness that the writer's HT coder is right), and the port decodes each to
its stored cv2 pixels, to live cv2 and to the JAX loader's at max abs 0:
the cleanup pass alone, with SigProp, with SigProp and MagRef, two layers,
TERMALL, lossy cleanups at plane 1 and 2, the 9/7 wavelet, every other
style bit (VSC among them), code-blocks from 4x4 to 64x64 over band edges
of any size, tiles and precincts, gray, 12- and 16-bit, RGBA, JP2, JPH and
raw codestreams, with and without CAP, with CPF. What cv2 refuses (the
mixed style, ROI, more than 3 passes) raises saying so; the damaged copies
(Scup and Lcup that lie, bit-planes that lie, significance outside the
block, truncation at each marker) decode as cv2 does or raise as it
raises, and the blocks OpenJPEG cuts to their cleanup pass give cv2's
picture. A seeded grid of 24 writer streams is held to cv2; the JAX loader
and the port's loaders agree on a COCO folder of HTJ2K files.

`python tests/test_torch_jpeg2000_ht.py` rewrites the fixtures and their
cv2 references, and their `formats.json` entries.
"""
import functools
import json
import os

import numpy as np
import pytest

from _format_checks import check_against_cv2, check_fixture, fixture_params
from format_writers import committed, cv2_rgb, jax_load_images
from semi_detr_tpu_torch import native
from semi_detr_tpu_torch.tools import ht_vlc_table, raw_formats

PREFIXES = ("j2kh_",)
ROUTE = "jpeg2000"


def write_fixtures(root: str = native.FIXTURES):
    import cv2
    with open(os.path.join(root, "formats.json")) as f:
        index = json.load(f)
    for name, (data, fmt, variant, expect) in \
            raw_formats.jpeg2000_ht_files().items():
        path = os.path.join(root, name)
        with open(path, "wb") as f:
            f.write(data)
        ref = cv2.imread(path, cv2.IMREAD_COLOR)
        assert (ref is not None) == (expect == "pixels"), name
        if ref is not None:
            cv2.imwrite(path.rsplit(".", 1)[0] + ".ref.png", ref)
        index[name] = {"format": fmt, "variant": variant, "expect": expect,
                       "route": ROUTE if expect == "pixels" else None}
    with open(os.path.join(root, "formats.json"), "w") as f:
        json.dump(index, f, indent=1, sort_keys=True)


def _read(name):
    with open(os.path.join(native.FIXTURES, name), "rb") as f:
        return f.read()


@functools.lru_cache(maxsize=1)
def _written():
    """The writer's fixtures and the pictures its lossless ones hold."""
    sources = {}
    return raw_formats.jpeg2000_ht_files(sources), sources


def test_table_tool_regenerates_the_header(tmp_path):
    """The tables found in cv2's binary by their structure alone (at the
    offset cv2 5.0.0.93 keeps them: the cross-check), their order learned
    by decoding, written to the committed header byte for byte."""
    pytest.importorskip("cv2")
    out = tmp_path / "j2k_ht_tables.h"
    at, mel_at = ht_vlc_table.main(["--out", str(out)])
    assert at == ht_vlc_table.KNOWN_OFFSET and mel_at == at - 64
    with open(ht_vlc_table.OUT) as f:
        assert out.read_text() == f.read()


def test_writer_regenerates_its_fixtures():
    index = committed(PREFIXES)
    files = _written()[0]
    assert sorted(files) == sorted(index)
    for name, (data, fmt, variant, expect) in files.items():
        assert data == _read(name), name
        assert (index[name]["format"], index[name]["variant"],
                index[name]["expect"]) == (fmt, variant, expect), name


def test_cv2_reads_the_lossless_fixtures_back(tmp_path):
    """cv2 reads every lossless fixture to the picture it was written from:
    the witness that the writer's HT block coder (its VLC codewords from
    the committed tables inverted) is right."""
    pytest.importorskip("cv2")
    sources = _written()[1]
    assert len(sources) >= 17
    for name, want in sources.items():
        got = cv2_rgb(_read(name), str(tmp_path), name)
        assert got is not None and np.array_equal(got, want), name


@pytest.mark.parametrize("name,entry", fixture_params(PREFIXES))
def test_fixture(name, entry):
    check_fixture(name, entry)
    if entry["expect"] == "pixels":
        assert entry["route"] == ROUTE


@pytest.mark.parametrize("name,entry", fixture_params(PREFIXES))
def test_fixture_against_live_cv2(name, entry, tmp_path):
    pytest.importorskip("cv2")
    assert check_against_cv2(_read(name), tmp_path, name) == (
        entry["expect"] == "pixels")


@pytest.mark.parametrize("name,words", [
    ("j2kh_mixed.j2k", "mixed high-throughput"),
    ("j2kh_roi.j2k", "ROI"),
    ("j2kh_passes4.j2k", "4 coding passes"),
    ("j2kh_placeholders.j2k", "6 coding passes")])
def test_refusals_say_so(name, words):
    with pytest.raises(native.ImageDecodeError) as err:
        native.decode_image(_read(name), name)
    msg = str(err.value)
    assert name in msg and words in msg and "cv2 refuses it too" in msg, msg


def _damaged(kind):
    a = raw_formats._picture(13, 19 if kind != "outside" else 15, 51, 60)
    kw = dict(ht=True, ht_passes=3, ht_damage=kind, cblk=(4, 4))
    if kind == "outside":
        kw.update(levels=0, cblk=(5, 5))
    return raw_formats.j2k_codestream([a[..., c] for c in range(3)], **kw)


@pytest.mark.parametrize("kind", raw_formats.HT_DAMAGE)
def test_damaged_blocks_as_cv2(kind, tmp_path):
    """Each damage decodes to cv2's pixels where OpenJPEG keeps the picture
    (a second segment of no bytes, passes below plane 0: the cleanup
    alone; a bit-plane too many where no quad's exponent bound overruns
    it), and raises naming the file where it fails the block, not saying
    "cv2 refuses it too" (the stream is damaged)."""
    pytest.importorskip("cv2")
    data = _damaged(kind)
    name = f"damaged_{kind}.j2k"
    read = check_against_cv2(data, tmp_path, name)
    if kind != "planes_overstated":  # read where no exponent bound overruns
        assert read == (kind in ("empty_refinement", "below_plane_0")), kind
    if not read:
        with pytest.raises(native.ImageDecodeError) as err:
            native.decode_image(data, name)
        assert "cv2 refuses it too" not in str(err.value), err.value


def _markers(data: bytes):
    """The offsets of a codestream's marker segments, half-way into each
    tile-part's data, and into its last bytes."""
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
            cuts += [pos + psot // 2, pos + psot - 3]
            pos += psot
            continue
        pos += 2 + seg
    return cuts


@pytest.mark.parametrize("name", ["j2kh_magref.j2k", "j2kh_jph.jph",
                                  "j2kh_tiles_rpcl.j2k"])
def test_truncated_at_each_marker(name, tmp_path):
    pytest.importorskip("cv2")
    data = _read(name)
    cuts = sorted(set(_markers(data) + [len(data) - 2, 8, 40]))
    stem, ext = name.rsplit(".", 1)
    for n in cuts:
        check_against_cv2(data[:n], tmp_path, f"{stem}_{n}.{ext}")


def _grid():
    """24 seeded option sets of the writer's HT coder at 40x40 or less."""
    rng = np.random.default_rng(61)
    cases = []
    for i in range(24):
        h, w = int(rng.integers(1, 41)), int(rng.integers(1, 41))
        levels = int(rng.integers(0, 4))
        cbw, cbh = int(rng.integers(2, 7)), int(rng.integers(2, 7))
        nc = int(rng.choice([1, 3, 3, 4]))
        kw = dict(levels=levels, cblk=(min(cbw, 12 - cbh), cbh),
                  ht_passes=int(rng.integers(1, 4)),
                  style=int(rng.choice([0, 0, 8, 0x3F])),
                  ht_drop=int(rng.choice([0, 0, 0, 1, 2])),
                  irreversible=bool(rng.random() < 0.3),
                  progression=int(rng.integers(0, 5)),
                  mct=bool(rng.random() < 0.7) and nc >= 3)
        if rng.random() < 0.3:
            kw["tile"] = (int(rng.integers(4, 20)), int(rng.integers(4, 20)))
        if rng.random() < 0.3:
            kw["precincts"] = [(int(rng.integers(1, 6)),
                                int(rng.integers(1, 6)))
                               for _ in range(levels + 1)]
        if kw["ht_passes"] == 3 and rng.random() < 0.4:
            kw.update(layers=2, ht_layers=[2, 1])
        cases.append(pytest.param(i, h, w, nc, kw, id=str(i)))
    return cases


@pytest.mark.parametrize("i,h,w,nc,kw", _grid())
def test_seeded_writer_grid(i, h, w, nc, kw, tmp_path):
    """Each stream decodes to cv2.imread's pixels; a lossless one (the
    cleanup alone at plane 0, 5/3) to its picture."""
    pytest.importorskip("cv2")
    a = raw_formats._picture(h, w, 300 + i, 40)
    planes = [a[..., c] for c in range(min(nc, 3))] + [a[..., 0] // 2] * (
        nc - 3)
    data = raw_formats.j2k_codestream(planes, ht=True, **kw)
    if nc == 1:
        data = raw_formats.jp2_file(data, colour=17)
    assert check_against_cv2(data, tmp_path, f"grid_{i}.jp2")
    if not kw["irreversible"] and kw["ht_drop"] == 0 and \
            kw["ht_passes"] == 1:
        want = np.repeat(a[..., :1], 3, 2) if nc == 1 else a
        np.testing.assert_array_equal(native.decode_image(data), want)


def test_jax_loader_and_load_image_on_a_coco_folder(tmp_path):
    """A COCO folder of HTJ2K files: the JAX package's
    CocoDataset.load_image (cv2.imread) and the port's, and the port's
    prefetch loader, give the same pixels."""
    from semi_detr_tpu_torch.data.coco import CocoDataset
    names = ["j2kh_magref.j2k", "j2kh_irreversible.j2k", "j2kh_gray16.jp2",
             "j2kh_rgba.jp2", "j2kh_jph.jph", "j2kh_tiles_rpcl.j2k"]
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


def test_the_route_is_the_host_decoder():
    """decoders() names the HT block decoder in the JPEG 2000 route; no
    part of the JPEG 2000 decoder says Part 15 is not ported any more."""
    assert "high-throughput" in native.decoders()[ROUTE]
    src = os.path.join(os.path.dirname(native.__file__), "j2k_host.cpp")
    with open(src) as f:
        assert "not_ported" not in f.read()


if __name__ == "__main__":
    write_fixtures()
