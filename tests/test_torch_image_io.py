"""The port's image files (`data/image_io.py`) against cv2.

The PNG reader must give `cv2.imread(path, IMREAD_COLOR)` (converted to
RGB, as the JAX package's `CocoDataset.load_image` does) bit for bit: on
files cv2 writes with each of the five row filters, in gray, RGB and RGBA,
and on files the port writes. A JPEG without cv2 raises, naming the file.
"""
import builtins
import os

import cv2
import numpy as np
import pytest

from semi_detr_tpu_torch.data import image_io

FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE,
           "sub": cv2.IMWRITE_PNG_FILTER_SUB,
           "up": cv2.IMWRITE_PNG_FILTER_UP,
           "average": cv2.IMWRITE_PNG_FILTER_AVG,
           "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
           "adaptive": cv2.IMWRITE_PNG_ALL_FILTERS}
CHANNELS = {"gray": 1, "rgb": 3, "rgba": 4}


def _picture(seed, h=23, w=37, channels=3):
    """Noise over smooth gradients: every filter has work to do."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    base = (3 * xs + 5 * ys)[..., None] + 40 * np.arange(channels)
    img = base + rng.randint(0, 12, (h, w, channels))
    return (img % 256).astype(np.uint8)


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("kind", sorted(CHANNELS))
@pytest.mark.parametrize("flt", sorted(FILTERS))
def test_png_reader_matches_cv2_on_cv2_files(tmp_path, flt, kind):
    ch = CHANNELS[kind]
    img = _picture(len(flt) + ch, channels=ch)
    path = str(tmp_path / f"{flt}_{kind}.png")
    assert cv2.imwrite(path, img if ch > 1 else img[..., 0],
                       [cv2.IMWRITE_PNG_FILTER, FILTERS[flt]])
    got = image_io.read_image(path)
    assert got.dtype == np.uint8 and got.shape == img.shape[:2] + (3,)
    np.testing.assert_array_equal(got, _cv2_rgb(path))


def test_png_round_trip_and_cv2_reads_the_port_file(tmp_path):
    img = _picture(7, h=41, w=29)
    path = image_io.write_png(str(tmp_path / "port.png"), img)
    np.testing.assert_array_equal(image_io.read_image(path), img)
    np.testing.assert_array_equal(_cv2_rgb(path), img)
    with pytest.raises(ValueError):
        image_io.encode_png(img.astype(np.float32))


def test_png_reader_rejects_what_it_cannot_read(tmp_path):
    path = str(tmp_path / "deep.png")
    cv2.imwrite(path, _picture(1).astype(np.uint16) * 257)
    with pytest.raises(ValueError, match="bit depth 16"):
        image_io.read_image(path)
    buf = bytearray(image_io.encode_png(_picture(2)))
    buf[40] ^= 0xFF                                  # inside IDAT
    with pytest.raises(ValueError, match="CRC"):
        image_io.decode_png(bytes(buf))


def test_jpeg_without_cv2_raises_naming_the_file(tmp_path, monkeypatch):
    path = str(tmp_path / "photo.jpg")
    cv2.imwrite(path, _picture(3))
    # with cv2 the JPEG decodes as cv2.imread does
    np.testing.assert_array_equal(image_io.read_image(path), _cv2_rgb(path))
    real_import = builtins.__import__

    def no_cv2(name, *args, **kw):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(RuntimeError) as err:
        image_io.read_image(path)
    assert os.path.basename(path) in str(err.value)
    assert "JPEG" in str(err.value) and "cv2" in str(err.value)
