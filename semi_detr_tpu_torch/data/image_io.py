"""Image files without cv2 or PIL.

Stands in for `CocoDataset.load_image` of `semi_detr_tpu/data/coco.py`
(the native libjpeg/libpng loader, or else `cv2.imread`): `read_image`
decodes, through the port's host library (`native/`), JPEG and PNG as the
native loader does and every file it hands to cv2 as `cv2.imread(path,
IMREAD_COLOR)` does (BGR turned to RGB): BMP, PNM (P1-P6), PAM, TIFF
(every variant cv2 reads: CCITT, BigTIFF, CMYK, YCbCr, CIELab, SGILog and
ThunderScan among them), WebP, GIF, Sun raster, PFM,
Radiance HDR, JPEG 2000 (JP2, JPH and raw codestreams, Part 1 and high-
throughput code-blocks), the lossless JPEG streams cv2 reads and lossless
AVIF (what cv2.imwrite writes at quality 100); on the card's machine too,
which has neither cv2 nor PIL. A file it cannot decode raises an error
that names it, and for what cv2 reads that the port does not (lossy AVIF)
names it with "not ported"; it never returns a blank or substitute image.
`write_image` encodes by the file's extension as cv2.imwrite does for a
colour image: JPEG, TIFF, WebP, GIF, Radiance HDR and JPEG 2000 through
the library, PNG, BMP, PNM, PFM, Sun raster and PAM here; .pgm and .pbm
are refused as cv2 refuses them, and .avif, which cv2 writes, raises "not
ported".

The PNG reader and writer here, in numpy and zlib, are the plain versions
the library's PNG decoder is held to. The reader gives what libpng gives
the JAX package's loader (`png_set_expand`, `png_set_strip_16`,
`png_set_strip_alpha`, `png_set_gray_to_rgb`): every bit depth and colour
type (gray at 1, 2, 4, 8 and 16 bits, palette at 1, 2, 4 and 8, gray +
alpha, RGB and RGBA at 8 and 16), non-interlaced or Adam7, with all five
row filters (None, Sub, Up, Average, Paeth) on each pass's rows. Gray
below 8 bits is scaled to 8 (x255, x85, x17), 16-bit samples keep their
high byte, alpha (and tRNS) is dropped, and gray is repeated over three
channels. Sub and Up rows decode as numpy operations; Average and Paeth
rows depend on the pixel to their left, so they decode pixel by pixel in
Python.
"""
from __future__ import annotations

import os
import struct
import sys
import zlib
from typing import Optional

import numpy as np

from .. import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (PNG spec 11.2.2)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# colour type -> the bit depths the specification allows
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7's passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unfilter(raw: bytes, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of h rows (a non-interlaced image, or one
    Adam7 pass); bpp is the bytes of a complete pixel, at least 1. Returns
    (h, row_bytes) uint8."""
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (row_bytes + 1):
        raise ValueError(f"PNG data holds {data.size} bytes, expected "
                         f"{h * (row_bytes + 1)}")
    rows = data.reshape(h, row_bytes + 1)
    out = np.zeros((h, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:            # Sub: running sum per byte of a pixel
            pad = (-row_bytes) % bpp
            px = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(
                -1, bpp)
            cur = (np.cumsum(px, 0, dtype=np.uint64) % 256).astype(
                np.uint8).reshape(-1)[:row_bytes]
        elif ftype == 2:            # Up
            cur = line + prev
        elif ftype in (3, 4):       # Average, Paeth: sequential in x
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for x in range(row_bytes):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    cur[x] = (cur[x] + ((a + b) >> 1)) & 0xFF
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                    cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(buf: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB."""
    if not buf.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG stream")
    pos, idat, palette, header = 8, [], None, None
    while pos < len(buf):
        length, ctype = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", buf[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"PNG chunk {ctype!r}: bad CRC")
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, compression, filt, interlace = header
    if depth not in _DEPTHS.get(ctype, ()) or compression or filt \
            or interlace > 1:
        raise ValueError(f"PNG of bit depth {depth}, colour type {ctype}, "
                         f"compression {compression}, filter {filt}, "
                         f"interlace {interlace}: not a combination the PNG "
                         "specification defines")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    ch = _CHANNELS[ctype]
    bits = ch * depth
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as err:
        raise ValueError(f"PNG data damaged or truncated: {err}") from None
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = [(-(-(h - y0) // dy), -(-(w - x0) // dx))
             for x0, y0, dx, dy in passes]
    # an empty pass has no bytes, not even filter bytes
    need = sum(ph * ((pw * bits + 7) // 8 + 1) for ph, pw in sizes
               if ph > 0 and pw > 0)
    if len(raw) != need:
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected {need}")
    out = np.zeros((h, w, 3), np.uint8)
    pos = 0
    for (x0, y0, dx, dy), (ph, pw) in zip(passes, sizes):
        if ph <= 0 or pw <= 0:
            continue
        row_bytes = (pw * bits + 7) // 8
        size = ph * (row_bytes + 1)
        rows = _unfilter(raw[pos:pos + size], ph, row_bytes, max(1, bits // 8))
        pos += size
        out[y0::dy, x0::dx] = _to_rgb(_samples(rows, pw * ch, depth).reshape(
            ph, pw, ch), ctype, depth, palette)
    return out


def _samples(rows: np.ndarray, n: int, depth: int) -> np.ndarray:
    """The first n samples of each of the unfiltered rows, at 8 bits or
    fewer: sub-byte samples unpacked most significant bits first, 16-bit
    samples reduced to their high byte (png_set_strip_16)."""
    if depth == 8:
        return rows[:, :n]
    if depth == 16:
        return rows[:, 0:2 * n:2]
    bits = np.unpackbits(rows, axis=1)[:, :n * depth].reshape(
        rows.shape[0], n, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)


def _to_rgb(px: np.ndarray, ctype: int, depth: int,
            palette) -> np.ndarray:
    """(h, w, channels) samples -> (h, w, 3) uint8 RGB as libpng's expand,
    strip-alpha and gray-to-RGB transforms give them."""
    if ctype == 3:
        if int(px.max()) >= len(palette):
            raise ValueError(f"PNG palette index {int(px.max())} outside its "
                             f"{len(palette)} entries")
        return palette[px[..., 0]]
    if ctype in (0, 4):               # gray (+ alpha), scaled to 8 bits
        scale = {1: 255, 2: 85, 4: 17}.get(depth, 1)
        return np.repeat(px[..., :1] * np.uint8(scale), 3, axis=2)
    return px[..., :3]


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG bytes (filter 0 on every row)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    raw = np.zeros((h, w * 3 + 1), np.uint8)
    raw[:, 1:] = img.reshape(h, w * 3)

    def chunk(ctype, body):
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> str:
    with open(path, "wb") as f:
        f.write(encode_png(img))
    return path


def read_image(path: str) -> np.ndarray:
    """An image file (JPEG, PNG, BMP, PNM, PAM, TIFF, WebP, GIF, Sun
    raster, PFM, HDR, JPEG 2000) -> (H, W, 3) uint8 RGB, by the host
    library (`native.decode_image`); `ImageDecodeError` naming the file
    for anything it cannot decode."""
    with open(path, "rb") as f:
        buf = f.read()
    return native.decode_image(buf, path)


def encode_bmp(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> the BMP cv2.imwrite writes: a 40-byte info
    header, 24 bits, rows bottom-up in BGR, each padded with zeros to 4
    bytes, no resolution."""
    img = _rgb(img, "encode_bmp")
    h, w = img.shape[:2]
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = img[::-1, :, ::-1].reshape(h, w * 3)
    size = 54 + rows.size
    return (b"BM" + struct.pack("<IHHI", size, 0, 0, 54)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, 0, 0, 0, 0, 0)
            + rows.tobytes())


def encode_ppm(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> the binary PPM (P6, maxval 255) cv2.imwrite
    writes for .ppm and .pnm."""
    img = _rgb(img, "encode_ppm")
    h, w = img.shape[:2]
    return f"P6\n{w} {h}\n255\n".encode() + img.tobytes()


def encode_pfm(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> the PFM cv2.imwrite writes: little-endian
    (scale -1), the values as float32 in R, G, B order, rows bottom-up."""
    img = _rgb(img, "encode_pfm")
    h, w = img.shape[:2]
    return f"PF\n{w} {h}\n-1\n".encode() + img[::-1].astype("<f4").tobytes()


def encode_sun_raster(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> the Sun raster cv2.imwrite writes: the
    standard type, 24 bits, B, G, R per pixel, rows padded to 16 bits. cv2
    pads a row with the byte that follows it in memory: the next row's
    first, and after the last row a byte past its buffer (written 0
    here)."""
    img = _rgb(img, "encode_sun_raster")
    h, w = img.shape[:2]
    flat = img[..., ::-1].reshape(-1)
    stride = (3 * w + 1) & ~1
    if stride == 3 * w:
        rows = flat
    else:
        rows = np.zeros((h, stride), np.uint8)
        rows[:, :3 * w] = flat.reshape(h, 3 * w)
        rows[:-1, 3 * w] = flat.reshape(h, 3 * w)[1:, 0]
    return struct.pack(">8I", 0x59A66A95, w, h, 24, h * stride, 1, 0, 0) + \
        rows.tobytes()


def encode_pam(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> the PAM cv2.imwrite writes: depth 3, maxval
    255, no TUPLTYPE, the samples in cv2's B, G, R order (cv2 reads them
    back unswapped, so to the same picture)."""
    img = _rgb(img, "encode_pam")
    h, w = img.shape[:2]
    return (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH 3\nMAXVAL 255\nENDHDR\n"
            .encode() + img[..., ::-1].tobytes())


def _rgb(img: np.ndarray, what: str) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{what} takes (H, W, 3) uint8, got {img.shape} "
                         f"{img.dtype}")
    return img


# what cv2.imwrite says and does for a colour image of each extension it
# refuses it for (it writes no file and returns False)
REFUSED = {"pgm": "Portable bitmap(.pgm) expects gray image",
           "pbm": "For portable bitmap(.pbm) type must be CV_8UC1"}
# the encoder of each extension, as cv2.imwrite picks it
ENCODERS = {"jpg": native.encode_jpeg, "jpeg": native.encode_jpeg,
            "png": encode_png, "bmp": encode_bmp, "ppm": encode_ppm,
            "pnm": encode_ppm, "tif": native.encode_tiff,
            "tiff": native.encode_tiff, "webp": native.encode_webp,
            "pfm": encode_pfm, "ras": encode_sun_raster,
            "sr": encode_sun_raster, "pam": encode_pam,
            "hdr": native.encode_hdr, "pic": native.encode_hdr,
            "gif": native.encode_gif, "jp2": native.encode_jp2,
            "avif": native.encode_avif}


def write_image(path: str, img: np.ndarray) -> Optional[str]:
    """(H, W, 3) uint8 RGB -> a file encoded by its extension, as
    cv2.imwrite writes a colour image: .jpg / .jpeg through the host
    library (quality 95, cv2's bytes), .png here, .bmp and .ppm / .pnm
    here (cv2's bytes), .tif / .tiff and .webp by the host library's
    encoders (cv2's TIFF tags; lossless WebP), each reading back to the
    image's pixels; .pfm, .ras / .sr and .pam here and .hdr / .pic by the
    host library, cv2's bytes (a Sun raster of odd width but its last pad
    byte, which cv2 takes from past its buffer); .gif by the host library,
    cv2's bytes (its 3-3-2 table and Floyd-Steinberg dithering); .jp2 by
    the host library, cv2's bytes (OpenJPEG's reversible encoder cut to
    rate 4). For .pgm and .pbm cv2 refuses a colour image: nothing is
    written, its reason goes to stderr and None comes back, as cv2 returns
    False. Below 32 pixels on a side cv2 refuses a .jp2 too, but leaves
    the 77 bytes of its JP2 boxes: those are written, the reason goes to
    stderr and None comes back. .avif by the host library as cv2.imwrite
    writes it with no parameters (what its IMWRITE_AVIF_QUALITY 50
    writes, not 95: 4:2:0 at base_q_idx 148 with cv2's chroma delta q,
    quantizer matrices, deblocking and CDEF): cv2's boxes and sequence
    header, a tile of the library's own encoder that cv2 reads to the
    port's pixels. Any other extension raises."""
    ext = path.lower().rsplit(".", 1)[-1] if "." in os.path.basename(
        path) else ""
    if ext in REFUSED:
        print(f"write_image({path!r}): nothing written: {REFUSED[ext]} "
              "(as cv2.imwrite refuses a colour image)", file=sys.stderr)
        return None
    if ext not in ENCODERS:
        raise ValueError(f"{path}: no encoder for .{ext}; the port writes "
                         f"{', '.join('.' + e for e in ENCODERS)}")
    try:
        buf = ENCODERS[ext](img)
    except native.EncodeRefused as err:
        with open(path, "wb") as f:
            f.write(err.partial)
        print(f"write_image({path!r}): {err.reason}; {len(err.partial)} "
              "bytes left (as cv2.imwrite leaves them and returns False)",
              file=sys.stderr)
        return None
    with open(path, "wb") as f:
        f.write(buf)
    return path
