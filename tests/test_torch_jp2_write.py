"""`native.encode_jp2` and `data.image_io.write_image` for .jp2 against
`cv2.imwrite`: cv2 5.0 writes a colour picture through OpenJPEG 2.5.3's
reversible 5/3 encoder, one quality layer cut to rate 4 by its rate
allocation, and the port's encoder (`native/j2k_encode_host.cpp`) writes
the same bytes.

* seeded noise at 32x32, 32x100, 100x32 and 48x64, a smooth picture that
  fits the budget whole (it reads back exact), the 75x101
  `colour_420.png`, a flat picture, and a picture whose whole stream (cv2's
  lossless file) lands just over the budget, so a few passes are cut;
* the JAX package's `save_result` and the port's with a .jp2 `out_file`:
  the same file;
* below 32 pixels on a side cv2 refuses: `write_image` returns None,
  leaves cv2's 77-byte file and prints cv2's reason;
* the port's decoder reads the port's file to cv2.imread's pixels of
  cv2's file;
* the committed fixtures `chip_smoke.py` phase 7a holds the card's host
  to (`native/fixtures/jp2w_*` and `jp2_writes.json`) are cv2's.

Run as a script to rewrite those fixtures:

    PYTHONPATH=. python tests/test_torch_jp2_write.py
"""
import hashlib
import json
import os

import cv2
import numpy as np
import pytest

from semi_detr_tpu_torch import native
from semi_detr_tpu_torch.data import image_io

# the byte budget of the one layer: float(24 w h / 32) less the 210 bytes
# before the tile-part, rounded up; and the bytes around the packets (the
# JP2 boxes, the main header, SOT, SOD and EOC)
HEADER_BYTES = 210
FRAMING_BYTES = HEADER_BYTES + 16
REASON = ("OpenJPEG2000: Number of resolutions is too high in comparison "
          "to the size of tiles")
FIXTURE_JSON = os.path.join(native.FIXTURES, "jp2_writes.json")
# phase 7a's pictures at a photo's size: only cv2's length and sha256 are
# committed
HOST_PICTURES = ((480, 640, 0), (800, 1344, 0))


def host_picture(h, w, seed):
    """chip_smoke.host_picture: seeded noise over gradients."""
    rs = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    base = (xs // 3 + ys // 2)[..., None] + 60 * np.arange(3)
    return ((base + rs.randint(0, 40, (h, w, 3))) % 256).astype(np.uint8)


def budget(h, w):
    return int(np.ceil(np.float32(24 * h * w / 32.0) -
                       np.float32(HEADER_BYTES)))


def over_budget_64x64():
    """Gradients with a few seeded spikes: the whole stream runs 108 bytes
    over the 2,862-byte budget, so the allocation cuts a few passes."""
    rs = np.random.RandomState(7)
    ys, xs = np.mgrid[0:64, 0:64]
    base = np.stack([xs * 2, ys * 3, xs + ys], -1)
    spikes = (rs.rand(64, 64, 3) < 0.026) * rs.randint(-20, 21, (64, 64, 3))
    return np.clip(base + spikes, 0, 255).astype(np.uint8)


def picture(name):
    if name == "colour_420":
        return image_io.read_image(os.path.join(native.FIXTURES,
                                                "colour_420.png"))
    if name == "over_budget_64x64":
        return over_budget_64x64()
    h, w = map(int, name.rsplit("_", 1)[1].split("x"))
    if name.startswith("flat"):
        return np.full((h, w, 3), (18, 154, 42), np.uint8)
    if name.startswith("smooth"):
        ys, xs = np.mgrid[0:h, 0:w]
        return np.stack([xs * 3, ys * 4, (xs + ys) * 2], -1).astype(np.uint8)
    rs = np.random.RandomState(sum(map(ord, name)))
    return rs.randint(0, 256, (h, w, 3)).astype(np.uint8)


PICTURES = ("noise_32x32", "noise_32x100", "noise_100x32", "noise_48x64",
            "smooth_48x64", "colour_420", "flat_40x56", "over_budget_64x64")
# the pictures committed for phase 7a, PNG beside cv2's .jp2
FIXTURE_PICTURES = ("noise_48x64", "smooth_48x64", "over_budget_64x64")


def cv2_bytes(img, tmp_path, x1000=None, name="cv2.jp2"):
    path = str(tmp_path / name)
    params = [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, x1000] if x1000 else []
    assert cv2.imwrite(path, np.ascontiguousarray(img[..., ::-1]), params)
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", PICTURES)
def test_bytes_are_cv2s(tmp_path, name):
    img = picture(name)
    want = cv2_bytes(img, tmp_path)
    assert native.encode_jp2(img) == want
    path = str(tmp_path / "port.jp2")
    assert image_io.write_image(path, img) == path
    with open(path, "rb") as f:
        assert f.read() == want


def test_budget_rules(tmp_path):
    """The whole stream is cv2's lossless file (every pass kept, at
    IMWRITE_JPEG2000_COMPRESSION_X1000 1000). The smooth picture's fits the
    budget: its rate-4 file reads back exact, leaving out only trailing
    passes that add neither bytes nor distortion, so it is not the
    lossless file. The over-budget picture's runs past the budget; its
    rate-4 packets stay within it, and it reads back changed."""
    smooth = picture("smooth_48x64")
    whole = cv2_bytes(smooth, tmp_path, 1000)
    assert len(whole) - FRAMING_BYTES <= budget(48, 64)
    np.testing.assert_array_equal(native.decode_image(whole), smooth)
    fitted = native.encode_jp2(smooth)
    assert fitted != whole and len(fitted) <= len(whole)
    np.testing.assert_array_equal(native.decode_image(fitted), smooth)
    img = over_budget_64x64()
    whole = cv2_bytes(img, tmp_path, 1000)
    cut = native.encode_jp2(img)
    assert budget(64, 64) < len(whole) - FRAMING_BYTES < budget(64, 64) + 120
    assert len(cut) - FRAMING_BYTES <= budget(64, 64)
    back = native.decode_image(cut)
    assert 0 < np.abs(back.astype(int) - img).max() <= 2


@pytest.mark.parametrize("name", ["noise_48x64", "over_budget_64x64",
                                  "colour_420"])
def test_round_trip(tmp_path, name):
    img = picture(name)
    path = str(tmp_path / "port.jp2")
    image_io.write_image(path, img)
    cv2_bytes(img, tmp_path)
    want = cv2.imread(str(tmp_path / "cv2.jp2"), cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(image_io.read_image(path), want)


@pytest.mark.parametrize("hw", [(31, 33), (32, 31), (31, 32)])
def test_refusal_below_32(tmp_path, capsys, hw):
    img = np.random.RandomState(hw[0] * hw[1]).randint(
        0, 256, hw + (3,)).astype(np.uint8)
    path = str(tmp_path / "port.jp2")
    assert image_io.write_image(path, img) is None
    assert REASON in capsys.readouterr().err
    theirs = str(tmp_path / "cv2.jp2")
    assert not cv2.imwrite(theirs, img[..., ::-1].copy())
    with open(path, "rb") as f, open(theirs, "rb") as g:
        a, b = f.read(), g.read()
    assert len(a) == 77 and a == b
    with pytest.raises(native.EncodeRefused, match="Number of resolutions"):
        native.encode_jp2(img)


def test_save_result_is_the_jax_file(tmp_path):
    """The JAX save_result (cv2's render and cv2.imwrite) and the port's,
    with a .jp2 out_file, on the same picture and detections."""
    from semi_detr_tpu.api import save_result as jax_save_result
    from semi_detr_tpu_torch.api import save_result

    img = host_picture(120, 160, 3)
    result = (np.array([[10, 20, 90, 100], [40, 5, 150, 70]], np.float32),
              np.array([0.9, 0.45], np.float32), np.array([0, 2], np.int64))
    classes = ("person", "bicycle", "car")
    ours = save_result(img, result, classes, str(tmp_path / "a" / "r.jp2"))
    theirs = jax_save_result(img, result, classes,
                             str(tmp_path / "b" / "r.jp2"))
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    # below 32 pixels both leave the 77-byte file and return the path
    small = img[:20, :40]
    ours = save_result(small, result, classes, str(tmp_path / "a" / "s.jp2"))
    theirs = jax_save_result(small, result, classes,
                             str(tmp_path / "b" / "s.jp2"))
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        a, b = f.read(), g.read()
    assert len(a) == 77 and a == b


def test_committed_fixtures_are_cv2s(tmp_path):
    """Phase 7a's fixtures: each PNG's committed .jp2 is cv2's file and
    the port's encode; the 480x640 and 800x1344 host pictures' lengths and
    sha256 are cv2's."""
    with open(FIXTURE_JSON) as f:
        spec = json.load(f)
    assert sorted(spec["pictures"]) == sorted(FIXTURE_PICTURES)
    for name, files in spec["pictures"].items():
        img = image_io.read_image(os.path.join(native.FIXTURES, files["png"]))
        np.testing.assert_array_equal(img, picture(name))
        with open(os.path.join(native.FIXTURES, files["jp2"]), "rb") as f:
            committed = f.read()
        assert committed == cv2_bytes(img, tmp_path) == native.encode_jp2(img)
    for row in spec["host_pictures"]:
        img = host_picture(row["h"], row["w"], row["seed"])
        want = cv2_bytes(img, tmp_path)
        assert (len(want), hashlib.sha256(want).hexdigest()) == (
            row["bytes"], row["sha256"])
        assert hashlib.sha256(native.encode_jp2(img)).hexdigest() == \
            row["sha256"]


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(8))
def test_sweep_against_cv2(tmp_path, seed):
    """Random sizes from 32 to 700 and kinds of picture."""
    rs = np.random.RandomState(seed)
    for i in range(40):
        h, w = rs.randint(32, 701, 2)
        kind = rs.randint(5)
        if kind == 0:
            img = rs.randint(0, 256, (h, w, 3))
        elif kind == 1:
            img = cv2.GaussianBlur(rs.randint(0, 256, (h, w, 3)).astype(
                np.uint8), (9, 9), 3)
        elif kind == 2:
            img = 128 + rs.rand() * 40 * rs.randn(h, w, 3)
        elif kind == 3:
            img = np.where(rs.rand(h, w, 1) < 0.02,
                           rs.randint(0, 256, (h, w, 3)), 0)
        else:
            img = host_picture(h, w, i)
        img = np.clip(img, 0, 255).astype(np.uint8)
        assert native.encode_jp2(img) == cv2_bytes(img, tmp_path), (
            i, h, w, kind)


def write_fixtures():
    """The phase-7a fixtures: FIXTURE_PICTURES as PNG and cv2's .jp2, and
    jp2_writes.json with cv2's length and sha256 for HOST_PICTURES."""
    import tempfile
    spec = {"encoder": "cv2.imwrite(path, bgr) of cv2 5.0 (OpenJPEG 2.5.3), "
                       "no parameters",
            "pictures": {}, "host_pictures": []}
    with tempfile.TemporaryDirectory() as tmp:
        for name in FIXTURE_PICTURES:
            img = picture(name)
            png, jp2 = f"jp2w_{name}.png", f"jp2w_{name}.jp2"
            image_io.write_image(os.path.join(native.FIXTURES, png), img)
            assert cv2.imwrite(os.path.join(native.FIXTURES, jp2),
                               np.ascontiguousarray(img[..., ::-1]))
            spec["pictures"][name] = {"png": png, "jp2": jp2}
        for h, w, seed in HOST_PICTURES:
            path = os.path.join(tmp, "p.jp2")
            assert cv2.imwrite(path, np.ascontiguousarray(
                host_picture(h, w, seed)[..., ::-1]))
            with open(path, "rb") as f:
                buf = f.read()
            spec["host_pictures"].append(dict(
                h=h, w=w, seed=seed, bytes=len(buf),
                sha256=hashlib.sha256(buf).hexdigest()))
    with open(FIXTURE_JSON, "w") as f:
        json.dump(spec, f, indent=1, sort_keys=True)


if __name__ == "__main__":
    write_fixtures()
