"""`data.image_io.write_image` for the formats the port reads and the JAX
demo writes with `cv2.imwrite` (its render under the input's name): PFM,
Sun raster (.ras / .sr), PAM, Radiance HDR (.hdr / .pic) and GIF, each
against cv2.imwrite's bytes for the same colour picture.

* PFM, PAM, HDR and GIF: the bytes are cv2's (GIF: cv2 5.0's fixed 3-3-2
  table and Floyd-Steinberg dithering, LZW with a clear code as the table
  fills); a GIF reads back, by cv2 and by the host library, to the pixels
  of cv2's file;
* Sun raster: cv2's bytes, but for a picture of odd width the last row's
  pad byte, which cv2 takes from past its buffer;
* .avif is written by the host library's encoder (.jp2, which the port
  writes to cv2's bytes: test_torch_jp2_write.py).

The demo's renders of inputs of these formats: test_torch_image_write.py.
"""
import os

import cv2
import numpy as np
import pytest

from semi_detr_tpu_torch import native
from semi_detr_tpu_torch.data import image_io

EXTS = ("pfm", "ras", "sr", "pam", "hdr", "pic", "gif")
PICTURES = {"noise_4x5": (4, 5), "noise_3x7": (3, 7), "flat_1x1": (1, 1),
            "noise_31x40": (31, 40), "smooth_48x64": (48, 64),
            "ramp_120x160": (120, 160), "noise_200x300": (200, 300)}


def picture(name):
    h, w = PICTURES[name]
    rs = np.random.RandomState(sum(map(ord, name)))
    if name.startswith("flat"):
        return np.full((h, w, 3), (18, 54, 42), np.uint8)
    if name.startswith("ramp"):
        ys, xs = np.mgrid[0:h, 0:w]
        return np.stack([xs, ys * 2, (xs + ys) % 256], -1).astype(np.uint8)
    img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    if name.startswith("smooth"):
        img = cv2.GaussianBlur(img, (9, 9), 3)
    return img


@pytest.mark.parametrize("ext", EXTS)
@pytest.mark.parametrize("pic", sorted(PICTURES))
def test_bytes_are_cv2s(tmp_path, ext, pic):
    img = picture(pic)
    ours = image_io.write_image(str(tmp_path / f"a.{ext}"), img)
    theirs = str(tmp_path / f"b.{ext}")
    assert cv2.imwrite(theirs, np.ascontiguousarray(img[..., ::-1]))
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        a, b = f.read(), g.read()
    if ext in ("ras", "sr") and img.shape[1] % 2:
        assert len(a) == len(b) and a[:-1] == b[:-1]
    else:
        assert a == b
    want = cv2.imread(theirs, cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(image_io.read_image(ours), want)
    np.testing.assert_array_equal(
        cv2.imread(ours, cv2.IMREAD_COLOR)[..., ::-1], want)


def test_gif_full_table_and_ties(tmp_path):
    """A 480x640 noise picture (the LZW table fills and clears many times)
    and flat pictures at every value whose error diffusion ties between
    two steps: cv2's bytes."""
    rs = np.random.RandomState(5)
    pics = [rs.randint(0, 256, (480, 640, 3)).astype(np.uint8)]
    pics += [np.full((6, 9, 3), v, np.uint8) for v in (18, 54, 90, 126,
                                                        162, 198, 234)]
    for i, img in enumerate(pics):
        path = str(tmp_path / f"c{i}.gif")
        cv2.imwrite(path, np.ascontiguousarray(img[..., ::-1]))
        with open(path, "rb") as f:
            assert native.encode_gif(img) == f.read(), i


@pytest.mark.parametrize("name,fmt", [("a.AVIF", "AVIF")])
def test_jp2_and_avif_not_ported(tmp_path, name, fmt):
    """.avif is written (the host library's encoder, cv2.imwrite's
    defaults) and reads back through the port's decoder and cv2 to the
    same pixels (test_torch_avif_write.py holds the rest)."""
    path = str(tmp_path / name)
    img = picture("flat_1x1")
    assert image_io.write_image(path, img) == path
    with open(path, "rb") as f:
        data = f.read()
    assert data[4:12] == b"ftypavif", data[:16]
    got = image_io.read_image(path)
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert got.shape == img.shape and np.array_equal(got, ref[..., ::-1])
