"""Checks shared by the per-format decoder tests (test_torch_bmp_pnm,
test_torch_tiff, test_torch_tiff_variants, test_torch_webp,
test_torch_jpeg12_lossless, test_torch_gif, test_torch_raster_pam,
test_torch_float_formats)."""
import os

import numpy as np
import pytest

from format_writers import committed, cv2_rgb, jax_load_images
from semi_detr_tpu_torch import native
from semi_detr_tpu_torch.data import image_io


def read(name: str) -> bytes:
    with open(os.path.join(native.FIXTURES, name), "rb") as f:
        return f.read()


def check_fixture(name: str, entry: dict):
    """A committed fixture: what the JAX loader and cv2 give it, and the
    library's decode of it (held at max abs 0 to its stored cv2 pixels, or
    raising as the JAX loader raises)."""
    path = os.path.join(native.FIXTURES, name)
    jax = jax_load_images(native.FIXTURES, [name])[name]
    if entry["expect"] == "pixels":
        ref = image_io.read_image(os.path.join(
            native.FIXTURES, name.rsplit(".", 1)[0] + ".ref.png"))
        got = image_io.read_image(path)
        assert got.shape == ref.shape and np.array_equal(got, ref), name
        assert isinstance(jax, np.ndarray) and np.array_equal(got, jax)
        assert native.image_size(read(name)) == got.shape[:2]
        assert entry["route"] in native.decoders()
        return
    if entry["expect"] == "not ported":  # cv2, so the JAX loader, reads it
        assert isinstance(jax, np.ndarray), (name, jax)
    else:
        assert isinstance(jax, Exception), (name, "the JAX loader reads it")
    with pytest.raises(native.ImageDecodeError) as err:
        image_io.read_image(path)
    msg = str(err.value)
    assert path in msg, msg
    if entry["expect"] == "not ported":
        assert "not ported" in msg and entry["format"] in msg, msg
    else:
        assert "cv2 refuses it too" in msg, msg


def check_against_cv2(data: bytes, tmp_path, name: str):
    """The library's decode of `data` equals cv2.imread's pixels (max abs
    0), or both refuse it; returns whether cv2 read it."""
    ref = cv2_rgb(data, str(tmp_path), name)
    if ref is None:
        with pytest.raises(native.ImageDecodeError, match=name):
            native.decode_image(data, name)
        return False
    got = native.decode_image(data, name)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() == 0, (name, diff.max(), (diff > 0).mean())
    return True


def check_against_loaders(data: bytes, tmp_path, name: str):
    """check_against_cv2, and the JAX package's loader (its native decoder,
    else cv2.imread) on the same file gives the same pixels, or raises
    where the library raises; returns whether cv2 read it."""
    read_it = check_against_cv2(data, tmp_path, name)
    jax = jax_load_images(str(tmp_path), [name])[name]
    if not read_it:
        assert isinstance(jax, Exception), (name, "the JAX loader reads it")
        return False
    got = native.decode_image(data, name)
    assert isinstance(jax, np.ndarray) and np.array_equal(got, jax), name
    assert native.image_size(data, name) == got.shape[:2]
    return True


def check_damaged(data: bytes, name: str, fault: str = ""):
    """A damaged stream raises ImageDecodeError naming the file (and the
    fault, where given); it never decodes to a blank image."""
    with pytest.raises(native.ImageDecodeError) as err:
        native.decode_image(data, name)
    assert name in str(err.value) and fault in str(err.value), err.value


def fixture_params(prefixes):
    return [pytest.param(n, e, id=n) for n, e in committed(prefixes).items()]
