"""PNG at every bit depth and colour type, non-interlaced and Adam7: the
port's decoders against libpng through the JAX package.

The JAX package reads PNG with libpng (`semi_detr_tpu.native.decode_image`:
`png_set_expand`, `png_set_strip_16`, `png_set_strip_alpha`,
`png_set_gray_to_rgb`). Three decoders of the port are held to it bit for
bit (max abs 0): the host library's C++ decoder called directly
(`native.decode_image`), the prefetch loader's path through a file, and
the numpy plain version `image_io.decode_png`. The streams come from
`write_png` below, a numpy writer of any depth, colour type and Adam7, with
seeded row filters and seeded padding bits after sub-byte rows. The
committed fixtures under `semi_detr_tpu_torch/native/fixtures/` (which
`chip_smoke.py` phase 7a decodes on the card, where neither libpng nor cv2
is) are regenerated here and compared byte for byte.

Regenerate the fixtures with `PYTHONPATH=. python
tests/test_torch_png_formats.py` from the repo root.
"""
import os
import struct
import sys
import zlib

import numpy as np
import pytest

from semi_detr_tpu_torch import native
from semi_detr_tpu_torch.data import image_io

# colour type -> (samples per pixel, bit depths)
LAYOUTS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
           4: (2, (8, 16)), 6: (4, (8, 16))}
CASES = [(c, d) for c, (_, depths) in LAYOUTS.items() for d in depths]
SIZES = ((1, 1), (2, 3), (5, 9), (13, 29))

from format_writers import jax_native, jax_native_fixture

# the JAX package's host library, loaded under the shared lock
jax_native_loaded = jax_native_fixture()


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _pack(samples: np.ndarray, depth: int, rng) -> np.ndarray:
    """(h, n) samples -> (h, row_bytes) bytes: sub-byte samples most
    significant bits first with seeded padding bits, 16-bit big-endian."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = ((samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(
        h, n * depth)
    pad = (-bits.shape[1]) % 8
    bits = np.concatenate([bits, rng.randint(0, 2, (h, pad))], 1)
    return np.packbits(bits.astype(np.uint8), axis=1)


def _filter(rows: np.ndarray, bpp: int, types) -> bytes:
    """The rows filtered with the given filter type per row."""
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for row, t in zip(rows.astype(np.int32), types):
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])[
            :len(row)]
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])[
            :len(row)]
        if t == 0:
            f = row
        elif t == 1:
            f = row - left
        elif t == 2:
            f = row - prev
        elif t == 3:
            f = row - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            f = row - np.where((pa <= pb) & (pa <= pc), left,
                               np.where(pb <= pc, prev, upleft))
        out.append(bytes([t]) + (f % 256).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def write_png(samples: np.ndarray, ctype: int, depth: int, interlace=0,
              palette=None, trns=None, seed=0) -> bytes:
    """(h, w, channels) integer samples -> a PNG stream of that colour type,
    depth and interlace, with seeded row filters (and padding bits)."""
    rng = np.random.RandomState(seed)
    h, w, ch = samples.shape
    bits = ch * depth
    bpp = max(1, bits // 8)
    passes = image_io.ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack(sub.reshape(sub.shape[0], -1), depth, rng)
        raw += _filter(rows, bpp, rng.randint(0, 5, len(rows)))
    out = image_io.PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND",
                                                                 b"")


def picture(ctype: int, depth: int, h: int, w: int, seed: int):
    """Seeded samples over gradients, a palette (colour type 3) and a tRNS
    chunk for the types that take one: (samples, palette, trns)."""
    rng = np.random.RandomState(seed)
    ch = LAYOUTS[ctype][0]
    top = (1 << depth) - 1
    ys, xs = np.mgrid[0:h, 0:w]
    base = ((xs * 7 + ys * 5) * top // max(1, 7 * w + 5 * h))[..., None]
    noise = rng.randint(0, top // 8 + 2, (h, w, ch))
    samples = (base + noise + np.arange(ch) * (top // 3)) % (top + 1)
    palette = trns = None
    if ctype == 3:
        n = 1 << depth
        palette = rng.randint(0, 256, (n, 3))
        trns = bytes(rng.randint(0, 256, n // 2 + 1).astype(np.uint8))
    elif ctype in (0, 2):
        value = rng.randint(0, top + 1, ch)
        trns = b"".join(struct.pack(">H", int(v)) for v in value)
    return samples, palette, trns


def _decode_all(buf: bytes, tmp_path):
    """The port's three decodes of buf: C++, the loader through a file,
    numpy."""
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(buf)
    loader = native.PrefetchLoader(1)
    try:
        loader.submit(0, path)
        loaded = loader.next().image
    finally:
        loader.close()
    return native.decode_image(buf), loaded, image_io.decode_png(buf)


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("ctype,depth", CASES)
def test_png_equals_libpng(ctype, depth, interlace, tmp_path):
    """Each depth x colour type x interlace, at sizes where Adam7's passes
    are empty (1x1, 2x3) and not, bit-equal to libpng's decode."""
    for i, (h, w) in enumerate(SIZES):
        samples, palette, trns = picture(ctype, depth, h, w, seed=i + depth)
        for with_trns in (False, True):
            buf = write_png(samples, ctype, depth, interlace, palette,
                            trns if with_trns else None, seed=i)
            ref = jax_native.decode_image(buf)
            assert ref is not None and ref.shape == (h, w, 3)
            for got in _decode_all(buf, tmp_path):
                np.testing.assert_array_equal(got, ref, err_msg=f"{h}x{w}")


# ---------------------------------------------------------------- fixtures

# name -> (colour type, depth, interlace, size, seed, with tRNS)
FIXTURES = {"png_gray1": (0, 1, 0, (37, 53), 1, False),
            "png_gray2": (0, 2, 0, (37, 53), 2, False),
            "png_gray4": (0, 4, 0, (37, 53), 3, False),
            "png_palette2_trns": (3, 2, 0, (37, 53), 4, True),
            "png_rgba16": (6, 16, 0, (37, 53), 5, False),
            "png_rgb_adam7": (2, 8, 1, (37, 53), 6, False)}


def fixture_bytes(name: str) -> bytes:
    ctype, depth, interlace, (h, w), seed, with_trns = FIXTURES[name]
    samples, palette, trns = picture(ctype, depth, h, w, seed)
    return write_png(samples, ctype, depth, interlace, palette,
                     trns if with_trns else None, seed)


def write_fixtures(root: str = native.FIXTURES):
    """Each fixture and its libpng decode as an 8-bit RGB PNG."""
    for name in FIXTURES:
        buf = fixture_bytes(name)
        with open(os.path.join(root, f"{name}.png"), "wb") as f:
            f.write(buf)
        image_io.write_png(os.path.join(root, f"{name}.ref.png"),
                           jax_native.decode_image(buf))


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_committed_png_fixtures(name):
    """The committed fixture is this file's stream, and its committed
    reference pixels are libpng's; the port reads both to them."""
    with open(os.path.join(native.FIXTURES, f"{name}.png"), "rb") as f:
        buf = f.read()
    assert buf == fixture_bytes(name)
    ref = image_io.read_image(os.path.join(native.FIXTURES,
                                           f"{name}.ref.png"))
    np.testing.assert_array_equal(ref, jax_native.decode_image(buf))
    np.testing.assert_array_equal(native.decode_image(buf), ref)
    np.testing.assert_array_equal(image_io.decode_png(buf), ref)


# ------------------------------------------------------------------ damage

def _damaged():
    samples, palette, _ = picture(3, 4, 13, 29, 0)
    good = write_png(samples, 3, 4, 1, palette, seed=0)
    idat = good.index(b"IDAT")
    n = struct.unpack(">I", good[idat - 4:idat])[0]
    body = good[idat + 4:idat + 4 + n]

    def with_idat(data: bytes) -> bytes:
        return good[:idat - 4] + _chunk(b"IDAT", data) + good[
            idat + 8 + n:]

    raw = bytearray(zlib.decompress(body))
    unknown_filter = bytearray(raw)
    unknown_filter[0] = 7
    small_palette = write_png(samples, 3, 4, 0, palette[:3], seed=0)
    bad_depth = bytearray(good)
    bad_depth[24] = 16                                 # palette at 16 bits
    ihdr = good.index(b"IHDR")
    bad_depth[29:33] = struct.pack(">I", zlib.crc32(bytes(bad_depth[
        ihdr:ihdr + 17])))
    crc = bytearray(good)
    crc[idat + 10] ^= 0xFF
    return {"truncated": (with_idat(body[:len(body) // 2]), "damaged"),
            "crc": (bytes(crc), "bad CRC"),
            "unknown_filter": (with_idat(zlib.compress(bytes(
                unknown_filter))), "unknown filter type 7"),
            "palette_index": (small_palette, "outside its 3 entries"),
            "bad_depth": (bytes(bad_depth), "bit depth 16, colour type 3"),
            "short": (with_idat(zlib.compress(bytes(raw[:-5]))),
                      "expected")}


@pytest.mark.parametrize("case", sorted(_damaged()))
def test_damaged_png_raises_naming_the_fault(case, tmp_path):
    """A damaged stream raises on both decoders, naming the fault and (the
    library) the file; it never comes back blank."""
    buf, fault = _damaged()[case]
    path = str(tmp_path / f"{case}.png")
    with open(path, "wb") as f:
        f.write(buf)
    with pytest.raises(native.ImageDecodeError) as err:
        image_io.read_image(path)
    assert f"{case}.png" in str(err.value)
    if case != "truncated":
        assert fault in str(err.value), err.value
    with pytest.raises(ValueError):
        image_io.decode_png(buf)


if __name__ == "__main__":
    sys.exit(write_fixtures())
