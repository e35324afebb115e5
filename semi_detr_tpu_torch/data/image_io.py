"""Image files without cv2 or PIL: a PNG reader and writer in numpy and
zlib, and JPEG through cv2 where it can be imported.

Stands in for `CocoDataset.load_image` of `semi_detr_tpu/data/coco.py`
(the native libjpeg/libpng loader, or else `cv2.imread`), which the card's
machine cannot run: it has neither cv2 nor PIL.

PNG: 8-bit gray, gray + alpha, RGB, RGBA and palette images,
non-interlaced, with all five row filters (None, Sub, Up, Average, Paeth).
Alpha is dropped, as `cv2.imread(path, cv2.IMREAD_COLOR)` drops it, and
gray is repeated over three channels. Sub and Up rows decode as numpy
operations; Average and Paeth rows depend on the pixel to their left, so
they decode pixel by pixel in Python (slow on large images; the writer
here uses filter 0 only, so the port's own files never take that path).

JPEG: decoded by cv2 when it is importable, else `read_image` raises an
error that names the file and the missing decoder; it never returns a
blank or substitute image.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# colour type -> samples per pixel (PNG spec 11.2.2)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(raw: bytes, h: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of a non-interlaced image. Returns (h,
    row_bytes) uint8."""
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
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace} (8-bit, "
                         "non-interlaced only)")
    ch = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    px = px.reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        return palette[px[..., 0]]
    if ch <= 2:                       # gray (+ alpha)
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


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
    """An image file -> (H, W, 3) uint8 RGB. PNG is decoded here; any other
    format goes to cv2, and raises when cv2 cannot be imported."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf.startswith(PNG_SIGNATURE):
        return decode_png(buf)
    kind = "JPEG" if buf.startswith(JPEG_SIGNATURE) else "non-PNG"
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            f"{path}: {kind} image, and no decoder for it: the port decodes "
            "PNG itself and needs cv2 (not importable here) for "
            "anything else") from None
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError(f"{path}: cv2 could not decode this {kind} image")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
