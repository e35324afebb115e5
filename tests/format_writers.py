"""Writers of the image formats the JAX loader hands to cv2, in numpy and
the standard library, for the port's decoder tests and fixtures: TIFF (any
byte order, classic or BigTIFF, strips or tiles, planar 1 or 2, none /
PackBits / LZW in both bit orders / Deflate / JPEG / LZMA compression,
predictor 2, FillOrder 2, 1-32 bits, signed and float samples, every
photometric the host library reads with CMYK and YCbCr data units, the
Orientation tag; CCITT through Pillow's libtiff, `pil_tiff`), BMP (every
bit depth, RLE4 / RLE8 / BI_BITFIELDS, bottom-up and top-down, the OS/2
and V4 / V5 headers), PNM (P1-P6 at any maxval), PAM (P7), Sun raster
(every depth and type, colour maps, the byte encoding), GIF (LZW at any
minimum code size, clears deferred or not, interlace, local and global
tables, offsets, transparency, extensions, frames), PFM, Radiance HDR
(new-style run-length, flat and old-style run-length scanlines) and JPEG
of 12 bits (sequential and progressive Huffman) or lossless (SOF3,
predictors 1-7, point transform). cv2 decodes what they write for the
reference pixels; the tests hold the host library's decode to it.
"""
import struct
import zlib

import numpy as np

# ------------------------------------------------------------------- TIFF


def packbits(data: bytes) -> bytes:
    """Apple PackBits: literal runs and repeats of up to 128 bytes."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1)]) + data[i:i + 1]
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 1 < n and data[j + 1] == data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def thunderscan(rows, run_to_end: bool = False) -> bytes:
    """(rows, w) 4-bit pixels -> ThunderScan codes (tif_thunder.c's
    decoder; libtiff has no encoder): per row from a last pixel of 0, runs
    of the last pixel (up to 63), three 2-bit deltas (0, 1, -1; a skip code
    where the row has fewer left), two 3-bit deltas (-3..3) or a raw pixel,
    whichever codes most pixels. A run reaches a row's end only where
    run_to_end is set."""
    d2 = {0: 0, 1: 1, -1: 3}
    d3 = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    out = bytearray()
    for row in np.asarray(rows, np.int64):
        w, last, i = len(row), 0, 0
        while i < w:
            run = 0
            while i + run < w and row[i + run] == last and run < 63:
                run += 1
            if run >= 2 and (i + run < w or run_to_end):
                out.append(run)
                i += run
                continue
            deltas = [int(v) - p for v, p in zip(row[i:i + 3],
                                                 [last] + list(row[i:i + 2]))]
            n2 = next((k for k, v in enumerate(deltas) if v not in d2),
                      len(deltas))
            if n2 == 3 or (n2 == len(deltas) and n2 > 0):
                codes = [d2[v] for v in deltas] + [2] * (3 - n2)
                out.append(0x40 | codes[0] << 4 | codes[1] << 2 | codes[2])
                i, last = i + n2, int(row[i + n2 - 1])
                continue
            n3 = next((k for k, v in enumerate(deltas[:2]) if v not in d3),
                      len(deltas[:2]))
            if n3 == 2 or (n3 == len(deltas[:2]) and n3 > 0):
                codes = [d3[v] for v in deltas[:2]] + [4] * (2 - n3)
                out.append(0x80 | codes[0] << 3 | codes[1])
                i, last = i + n3, int(row[i + n3 - 1])
                continue
            out.append(0xC0 | int(row[i]))
            i, last = i + 1, int(row[i])
    return bytes(out)


def lzw(data: bytes, old_style: bool = False) -> bytes:
    """TIFF LZW as libtiff writes it (MSB first, the code width growing one
    code early, a clear code when the table fills), or in the old style
    libtiff still reads (LSB first, the width growing on time)."""
    out, acc, nbits, width = bytearray(), 0, 0, 9

    def put(code):
        nonlocal acc, nbits
        if old_style:
            acc |= code << nbits
            nbits += width
            while nbits >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nbits -= 8
        else:
            acc = (acc << width) | code
            nbits += width
            while nbits >= 8:
                out.append((acc >> (nbits - 8)) & 0xFF)
                nbits -= 8
                acc &= (1 << nbits) - 1

    def grow():
        nonlocal nxt, width, table
        nxt += 1
        if nxt == 4094:
            put(256)
            table, nxt, width = {bytes([i]): i for i in range(256)}, 258, 9
        elif nxt >= (1 << width) + (1 if old_style else 0):
            width += 1

    table, nxt = {bytes([i]): i for i in range(256)}, 258
    put(256)
    w = data[:1]
    for b in data[1:]:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        put(table[w])
        table[wc] = nxt
        grow()
        w = bytes([b])
    if w:
        put(table[w])
        grow()
    put(257)
    if nbits:
        out.append((acc << (8 - nbits)) & 0xFF if not old_style
                   else acc & 0xFF)
    return bytes(out)


def _pack_rows(samples: np.ndarray, bits: int, order: str) -> bytes:
    """(rows, n) samples -> rows packed to whole bytes: below 8 bits most
    significant first, 16 bits in the byte order `order` ('<' or '>')."""
    if bits in (16, 32):
        return samples.astype(f"{order}u{bits // 8}").tobytes()
    if bits == 8:
        return samples.astype(np.uint8).tobytes()
    rows, n = samples.shape
    bit = ((samples[..., None] >> np.arange(bits - 1, -1, -1)) & 1).reshape(
        rows, n * bits)
    return np.packbits(bit.astype(np.uint8), axis=1).tobytes()


def _predict(samples: np.ndarray, stride: int, bits: int) -> np.ndarray:
    """Predictor 2 on (rows, n) samples: each minus the one `stride`
    before it in its row, modulo 2 ** bits."""
    out = samples.astype(np.int64).copy()
    out[:, stride:] -= samples[:, :-stride].astype(np.int64)
    return out % (1 << bits)


def jpeg_split(stream: bytes):
    """A JPEG stream -> (its DQT and DHT segments as a tables-only stream,
    the stream without them), as TIFF's JPEGTables and an abbreviated
    strip hold them."""
    tables, rest, i = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while True:
        m = stream[i + 1]
        if m == 0xDA:
            rest += stream[i:]
            break
        n = struct.unpack(">H", stream[i + 2:i + 4])[0]
        (tables if m in (0xDB, 0xC4) else rest).extend(stream[i:i + 2 + n])
        i += 2 + n
    return bytes(tables) + b"\xff\xd9", bytes(rest)


def write_tiff(img: np.ndarray, bits: int = 8, photometric: int = None,
               compression: int = 1, predictor: int = 1, planar: int = 1,
               rows_per_strip: int = None, tile=None, colormap=None,
               extra: int = None, orientation: int = None,
               order: str = "<", jpeg=None, jpeg_tables: bool = False,
               subsampling=None, sample_format: int = None,
               fill_order: int = None, old_lzw: bool = False,
               bigtiff: bool = False, inkset: int = None,
               ref_black_white=None, ycbcr_coefficients=None,
               lzma_filters=None, white_point=None) -> bytes:
    """(h, w, spp) samples -> a TIFF file of one page.

    compression: 1 none, 5 LZW (old_lzw: the old bit order), 8 Deflate,
    32773 PackBits, 7 JPEG (jpeg(block) -> the stream of one (rows, cols,
    spp) uint8 block; jpeg_tables moves its tables into JPEGTables).
    34925 LZMA (the .xz stream libtiff's codec writes; lzma_filters a
    filter chain for the stdlib's encoder).
    tile: (tile_h, tile_w), else strips of rows_per_strip rows (default:
    all). colormap: (3, 2 ** bits) uint16. extra: ExtraSamples' value for
    the samples past the colour ones. Photometric 6 outside JPEG packs
    (h, w, 3) YCbCr samples into libtiff's data units of `subsampling`
    (h * v luma samples, then the means of Cb and Cr, rounded down).
    fill_order 2 reverses the bits of every coded byte (not under JPEG).
    white_point: WhitePoint's ((num, den), (num, den)) for CIELab.
    compression 32809 codes 4-bit rows by `thunderscan`.
    bigtiff writes version 43 with 8-byte counts and offsets."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, spp = img.shape
    if photometric is None:
        photometric = 3 if colormap is not None else (2 if spp >= 3 else 1)
    ncolour = {2: 3, 6: 3, 8: 3, 5: 4}.get(photometric, 1)
    if tile:
        th, tw = tile
        ph, pw = -(-h // th) * th, -(-w // tw) * tw
        padded = np.zeros((ph, pw, spp), img.dtype)
        padded[:h, :w] = img
        blocks = [(y, x, th, tw) for y in range(0, h, th)
                  for x in range(0, w, tw)]
        src = padded
    else:
        rps = rows_per_strip or h
        blocks = [(y, 0, min(rps, h - y), w) for y in range(0, h, rps)]
        src = img
    planes = [src] if planar == 1 else [src[..., k:k + 1]
                                        for k in range(spp)]
    segments, tables = [], None
    for plane in planes:
        for y, x, bh, bw in blocks:
            block = plane[y:y + bh, x:x + bw]
            if compression == 7:
                seg = jpeg(block.astype(np.uint8))
                if jpeg_tables:
                    tables, seg = jpeg_split(seg)
                segments.append(seg)
                continue
            units = photometric == 6 and subsampling and planar == 1
            if units:
                rows = _ycbcr_units(block, *subsampling)
                bh = rows.shape[0]
            else:
                rows = block.reshape(bh, -1)
            if predictor == 2 and units:
                # libtiff differences data units in rows of its scanline
                # size (a row of units / v) in strips, of 3 * tile width
                # bytes in tiles, whatever the units
                size = tile[1] * 3 if tile else rows.shape[1] // \
                    subsampling[1]
                flat = rows.reshape(-1)
                n = -(-flat.size // size) * size
                chunks = np.pad(flat, (0, n - flat.size)).reshape(-1, size)
                rows = _predict(chunks, 3, 8).reshape(-1)[:flat.size] \
                    .reshape(rows.shape)
            elif predictor == 2:
                rows = _predict(rows, block.shape[2], bits)
            raw = thunderscan(rows) if compression == 32809 else \
                _pack_rows(rows, bits, order)
            if compression == 5:
                raw = lzw(raw, old_lzw)
            elif compression in (8, 32946):
                raw = zlib.compress(raw)
            elif compression == 32773:
                raw = b"".join(packbits(raw[r * len(raw) // bh:
                                            (r + 1) * len(raw) // bh])
                               for r in range(bh))
            elif compression == 34925:
                import lzma
                raw = lzma.compress(raw, format=lzma.FORMAT_XZ,
                                    check=lzma.CHECK_NONE,
                                    filters=lzma_filters)
            if fill_order == 2:
                raw = bytes(_REVERSED[np.frombuffer(raw, np.uint8)])
            segments.append(raw)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar])}
    if tile:
        tags[322] = (4, [tile[1]])
        tags[323] = (4, [tile[0]])
    else:
        tags[278] = (4, [rows_per_strip or h])
    if predictor != 1:
        tags[317] = (3, [predictor])
    if colormap is not None:
        tags[320] = (3, list(np.asarray(colormap).reshape(-1)))
    if spp > ncolour:
        tags[338] = (3, [extra if extra is not None else 0] * (spp - ncolour))
    if orientation is not None:
        tags[274] = (3, [orientation])
    if subsampling is not None:
        tags[530] = (3, list(subsampling))
    if sample_format is not None:
        tags[339] = (3, [sample_format] * spp)
    if fill_order is not None:
        tags[266] = (3, [fill_order])
    if inkset is not None:
        tags[332] = (3, [inkset])
    if ycbcr_coefficients is not None:
        tags[529] = (5, [v for x in ycbcr_coefficients
                         for v in (int(round(x * 10000)), 10000)])
    if ref_black_white is not None:
        tags[532] = (5, [v for x in ref_black_white
                         for v in (int(round(x * 1000)), 1000)])
    if tables is not None:
        tags[347] = (7, list(tables))
    if white_point is not None:
        tags[318] = (5, [v for pair in white_point for v in pair])
    # layout: header, the segments, then the IFD and its out-of-line values
    data = bytearray(8)
    offsets = []
    for seg in segments:
        offsets.append(len(data))
        data += seg
        if len(data) % 2:
            data += b"\0"
    off_tag, cnt_tag = (324, 325) if tile else (273, 279)
    tags[off_tag] = (4, offsets)
    tags[cnt_tag] = (4, [len(s) for s in segments])
    fmt = {1: "B", 3: "H", 4: "I", 5: "I", 7: "B", 16: "Q"}
    if bigtiff:  # offsets and counts as LONG8, after a 16-byte header
        data[8:8] = bytes(8)
        offsets = [o + 8 for o in offsets]
        tags[off_tag] = (16, offsets)
        tags[cnt_tag] = (16, [len(s) for s in segments])
    ifd_at = len(data)
    n = len(tags)
    count, entry, word = ("Q", 20, 8) if bigtiff else ("H", 12, 4)
    ptr = "Q" if bigtiff else "I"
    extra_at = ifd_at + struct.calcsize(count) + entry * n + word
    ifd = bytearray(struct.pack(order + count, n))
    tail = bytearray()
    for tag in sorted(tags):
        typ, vals = tags[tag]
        body = struct.pack(order + fmt[typ] * len(vals), *vals)
        if len(body) <= word:
            field = body.ljust(word, b"\0")
        else:
            field = struct.pack(order + ptr, extra_at + len(tail))
            tail += body + (b"\0" if len(body) % 2 else b"")
        nvals = len(vals) // (2 if typ == 5 else 1)
        ifd += struct.pack(order + "HH" + ("Q" if bigtiff else "I"), tag, typ,
                           nvals) + field
    ifd += struct.pack(order + ptr, 0)
    magic = (b"II" if order == "<" else b"MM") + struct.pack(
        order + "H", 43 if bigtiff else 42)
    head = magic + (struct.pack(order + "HHQ", 8, 0, ifd_at) if bigtiff
                    else struct.pack(order + "I", ifd_at))
    data[:len(head)] = head
    return bytes(data + ifd + tail)


def pil_tiff(img: np.ndarray, compression: str, tiffinfo=None) -> bytes:
    """A TIFF written by Pillow's libtiff (CCITT for a bool picture:
    "tiff_ccitt", "group3", "group4"; tiffinfo's tags, such as T4Options
    292, FillOrder 266 or RowsPerStrip 278, passed to libtiff)."""
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "TIFF", compression=compression,
                              tiffinfo=tiffinfo or {})
    return buf.getvalue()


def _tiff_entry(data: bytes, tag: int):
    """(byte order, the entry's position, its type, count) of a tag of a
    classic TIFF's first IFD."""
    order = "<" if data[:2] == b"II" else ">"
    ifd = struct.unpack(order + "I", data[4:8])[0]
    n = struct.unpack(order + "H", data[ifd:ifd + 2])[0]
    for e in range(n):
        p = ifd + 2 + 12 * e
        t, typ, count = struct.unpack(order + "HHI", data[p:p + 8])
        if t == tag:
            return order, p, typ, count
    raise KeyError(tag)


def set_tiff_tag(data: bytes, tag: int, value: int) -> bytes:
    """A classic TIFF with the first value of a SHORT or LONG tag of its
    first IFD set to `value`."""
    order, p, typ, _ = _tiff_entry(data, tag)
    out = bytearray(data)
    out[p + 8:p + 12] = struct.pack(
        order + ("H" if typ == 3 else "I"), value).ljust(4, b"\0")
    return bytes(out)


_REVERSED = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)],
                     np.uint8)


def _ycbcr_units(block: np.ndarray, sh: int, sv: int) -> np.ndarray:
    """(rows, cols, 3) YCbCr -> rows of libtiff's data units: for each
    (sv, sh) cell its sh * sv luma samples in raster order, then the
    cell's mean Cb and Cr (rounded down); the edges repeated."""
    rows, cols = block.shape[:2]
    ph, pw = -(-rows // sv) * sv, -(-cols // sh) * sh
    b = np.pad(block.astype(np.int64), ((0, ph - rows), (0, pw - cols),
                                        (0, 0)), "edge")
    cells = b.reshape(ph // sv, sv, pw // sh, sh, 3).transpose(0, 2, 1, 3, 4)
    y = cells[..., 0].reshape(ph // sv, pw // sh, sv * sh)
    c = cells[..., 1:].reshape(ph // sv, pw // sh, sv * sh, 2).mean(2)
    return np.concatenate([y, c.astype(np.int64)], 2).reshape(ph // sv, -1)


# -------------------------------------------------------------------- BMP

def rle_bmp_rows(idx: np.ndarray, bits: int, rng=None) -> bytes:
    """Index rows (bottom-up order already) -> RLE8 or RLE4 data: encoded
    runs where two or more equal pixels follow, absolute runs of at least
    three pixels otherwise (word-aligned), an end of line after each row and
    an end of bitmap. With rng, some runs are split at random."""
    out = bytearray()
    per = 2 if bits == 4 else 1

    def pair_val(seq):  # an RLE4 encoded run repeats two nibbles
        return seq[0] << 4 | (seq[1] if len(seq) > 1 else 0)

    for row in idx:
        x, w = 0, len(row)
        while x < w:
            j = x
            while j + 1 < w and row[j + 1] == row[x] and j - x < 254:
                j += 1
            run = j - x + 1
            if run >= 2 or w - x < 3:
                run = min(run, 255)
                out += bytes([run, row[x] * 17 if bits == 4 else row[x]])
                x += run
                continue
            j = x
            while j < w and j - x < 255 and not (
                    j + 1 < w and row[j + 1] == row[j]):
                j += 1
            n = max(3, j - x)
            n = min(n, w - x)
            if n < 3:
                out += bytes([n, row[x] * 17 if bits == 4 else row[x]])
                x += n
                continue
            seg = list(row[x:x + n])
            if bits == 4:
                body = bytes(pair_val(seg[k:k + 2]) for k in range(0, n, 2))
            else:
                body = bytes(seg)
            out += bytes([0, n]) + body + (b"\0" if len(body) % 2 else b"")
            x += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


def write_bmp(img: np.ndarray, bits: int = 24, palette=None,
              compression: int = 0, header: int = 40, top_down=False,
              masks=None, rle_data: bytes = None, colours_used=None) -> bytes:
    """(h, w) indices (bits 1, 4, 8 with palette (n, 3) RGB) or (h, w, 3 or
    4) RGB(A) samples -> a BMP file. compression 0 BI_RGB, 1 RLE8, 2 RLE4,
    3 BI_BITFIELDS (masks: red, green, blue[, alpha]); header 12 (OS/2 1.x
    core), 40, 108 (V4) or 124 (V5). 16 bits: 5-5-5 under BI_RGB, the
    masks' layout under BI_BITFIELDS."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    rows = img[::-1] if not top_down else img
    if compression in (1, 2):
        data = rle_data if rle_data is not None else rle_bmp_rows(
            rows, 8 if compression == 1 else 4)
    else:
        if bits <= 8:
            bit = ((rows[..., None].astype(np.int64) >> np.arange(
                bits - 1, -1, -1)) & 1).reshape(h, w * bits)
            raw = np.packbits(bit.astype(np.uint8), axis=1)
        elif bits == 16:
            r, g, b = (rows[..., k].astype(np.int64) for k in range(3))
            if masks is not None and masks[1] == 0x7E0:
                v = (r >> 3) << 11 | (g >> 2) << 5 | (b >> 3)
            else:
                v = (r >> 3) << 10 | (g >> 3) << 5 | (b >> 3)
            raw = v.astype("<u2").view(np.uint8).reshape(h, 2 * w)
        else:
            raw = rows[..., [2, 1, 0] + ([3] if bits == 32 else [])]
            if bits == 32 and rows.shape[2] == 3:
                raw = np.concatenate(
                    [rows[..., ::-1], np.zeros((h, w, 1), rows.dtype)], 2)
            raw = raw.astype(np.uint8).reshape(h, -1)
        pad = (-raw.shape[1]) % 4
        raw = np.concatenate([raw, np.zeros((h, pad), np.uint8)], 1)
        data = raw.tobytes()
    pal = b""
    if palette is not None:
        palette = np.asarray(palette, np.uint8)
        entry = palette[:, ::-1]
        if header != 12:
            entry = np.concatenate([entry, np.zeros((len(entry), 1),
                                                    np.uint8)], 1)
        pal = entry.tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        n_pal = len(palette) if palette is not None else 0
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bits, compression, len(data), 2835, 2835,
                           colours_used if colours_used is not None
                           else n_pal, 0)
        if header > 40:
            m = list(masks or (0, 0, 0, 0)) + [0] * 4
            info += struct.pack("<IIII", *m[:4])
            info += b"sRGB"[::-1] + b"\0" * (header - 60)
        elif compression == 3:
            pal = struct.pack("<III", *masks[:3]) + pal
    off = 14 + len(info) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + \
        info + pal + data


# ---------------------------------------------- JPEG of 12 bits, lossless

class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code: int, length: int):
        for k in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((code >> k) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _flat_table(tc: int, th: int, nsym: int, length: int):
    """A DHT segment body giving symbols 0..nsym-1 codes of `length` bits,
    and the (code, length) of each symbol."""
    counts = [0] * 16
    counts[length - 1] = min(nsym, 255)
    codes = {s: (s, length) for s in range(min(nsym, 255))}
    if nsym == 256:  # a length holds at most 255: the last one bit longer
        counts[length] = 1
        codes[255] = (255 << 1, length + 1)
    return (bytes([tc << 4 | th]) + bytes(counts) + bytes(range(nsym)),
            codes)


def _category(v: int) -> int:
    return 0 if v == 0 else int(abs(v)).bit_length()


def _put_value(bw, v: int, s: int):
    if s:
        bw.put(v if v > 0 else v + (1 << s) - 1, s)


_ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
                    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21,
                    28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30,
                    37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61,
                    54, 47, 55, 62, 63])


def _dct_matrix():
    k = np.arange(8)
    c = np.cos((2 * k[None] + 1) * k[:, None] * np.pi / 16)
    c[0] *= 1 / np.sqrt(2)
    return c / 2


def jpeg12(samples: np.ndarray, progressive: bool = False,
           colour: str = "ycbcr", factors=((1, 1), (1, 1), (1, 1)),
           quant: int = 4, precision: int = 12) -> bytes:
    """(h, w, c) samples of 12 bits (0-4095) -> a JPEG stream of precision
    12: sequential Huffman (SOF1) or progressive (SOF2: a DC scan, then one
    AC scan per component). colour 'ycbcr' (JFIF, component ids 1-3),
    'rgb' (Adobe transform 0) or 'gray'; factors (h, v) per component;
    every quantizer `quant`; flat Huffman tables that code every symbol."""
    h, w, nc = samples.shape
    factors = factors[:nc]
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    mcu_w, mcu_h = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    dct = _dct_matrix()
    blocks = []  # per component: (bh, bw, 64) quantized, zig-zag order
    for c in range(nc):
        fh, fv = factors[c]
        ph, pw = -(-h * fv // vmax), -(-w * fh // hmax)
        plane = samples[..., c].astype(np.float64)
        if (fh, fv) != (hmax, vmax):  # box downsampling
            sy, sx = vmax // fv, hmax // fh
            plane = np.pad(plane, ((0, (-h) % sy), (0, (-w) % sx)), "edge")
            plane = plane.reshape(plane.shape[0] // sy, sy,
                                  plane.shape[1] // sx, sx).mean((1, 3))
        bh, bw = mcu_h * fv, mcu_w * fh
        plane = np.pad(plane[:ph, :pw], ((0, bh * 8 - ph), (0, bw * 8 - pw)),
                       "edge") - (1 << (precision - 1))
        t = plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = np.einsum("ij,abjk,lk->abil", dct, t, dct)
        q = np.round(coef / quant).astype(np.int64).reshape(bh, bw, 64)
        blocks.append(q[..., _ZIGZAG])
    dc_body, dc_codes = _flat_table(0, 0, 16, 5)
    ac_body, ac_codes = _flat_table(1, 0, 256, 9)
    ids = ([1, 2, 3, 4] if colour != "rgb" or nc == 4
           else [ord("R"), ord("G"), ord("B")])
    out = bytearray(b"\xff\xd8")
    if colour == "ycbcr":
        out += _segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    elif colour == "rgb":
        out += _segment(0xEE, b"Adobe\0\x64\0\0\0\0\0")
    out += _segment(0xDB, bytes([0]) + bytes([quant] * 64))
    sof = bytes([precision]) + struct.pack(">HH", h, w) + bytes([nc])
    for c in range(nc):
        sof += bytes([ids[c], factors[c][0] << 4 | factors[c][1], 0])
    out += _segment(0xC2 if progressive else 0xC1, sof)
    out += _segment(0xC4, dc_body + ac_body)

    def mcu_blocks(c, my, mx):
        fh, fv = factors[c]
        for by in range(fv):
            for bx in range(fh):
                yield blocks[c][my * fv + by, mx * fh + bx]

    def scan(comps, ss, se):
        body = bytes([len(comps)])
        for c in comps:
            body += bytes([ids[c], 0])
        body += bytes([ss, se, 0])
        bw = _BitWriter()
        pred = {c: 0 for c in comps}
        if len(comps) == 1:
            c = comps[0]
            fh, fv = factors[c]
            ph, pw = -(-h * fv // vmax), -(-w * fh // hmax)
            units = [(by, bx) for by in range(-(-ph // 8))
                     for bx in range(-(-pw // 8))]
            seq = [(c, blocks[c][by, bx]) for by, bx in units]
        else:
            seq = [(c, b) for my in range(mcu_h) for mx in range(mcu_w)
                   for c in comps for b in mcu_blocks(c, my, mx)]
        for c, blk in seq:
            if ss == 0:
                diff = int(blk[0]) - pred[c]
                pred[c] = int(blk[0])
                s = _category(diff)
                bw.put(*dc_codes[s])
                _put_value(bw, diff, s)
            if se > 0:
                run = 0
                ac = blk[max(ss, 1):se + 1]
                last = np.nonzero(ac)[0]
                last = last[-1] if len(last) else -1
                for k, v in enumerate(ac[:last + 1]):
                    v = int(v)
                    if v == 0:
                        run += 1
                        continue
                    while run > 15:
                        bw.put(*ac_codes[0xF0])
                        run -= 16
                    s = _category(v)
                    bw.put(*ac_codes[run << 4 | s])
                    _put_value(bw, v, s)
                    run = 0
                if last + 1 < len(ac):
                    bw.put(*ac_codes[0x00])
        return _segment(0xDA, body) + bw.flush()

    if progressive:
        out += scan(list(range(nc)), 0, 0)
        for c in range(nc):
            out += scan([c], 1, 63)
    else:
        out += scan(list(range(nc)), 0, 63)
    return bytes(out + b"\xff\xd9")


def exif_app1(orientation: int) -> bytes:
    """An APP1 segment of EXIF holding IFD0's Orientation tag."""
    tiff = b"MM\0*" + struct.pack(">I", 8) + struct.pack(">H", 1) + \
        struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0) + b"\0" * 4
    return _segment(0xE1, b"Exif\0\0" + tiff)


def jpeg_lossless(samples: np.ndarray, precision: int, predictor: int,
                  point: int = 0, colour: str = "rgb",
                  restart: int = 0, orientation: int = 0) -> bytes:
    """(h, w, c) samples below 2 ** precision -> a lossless JPEG stream
    (SOF3) of one interleaved scan: predictor 1-7, point transform `point`
    (the samples' low bits dropped), colour 'rgb' (Adobe transform 0),
    'ycbcr' (JFIF) or 'gray'; a restart every `restart` MCUs (0: none)."""
    h, w, nc = samples.shape
    x = samples.astype(np.int64) >> point
    body, codes = _flat_table(0, 0, 17, 5)
    ids = ([1, 2, 3, 4] if colour != "rgb" or nc == 4
           else [ord("R"), ord("G"), ord("B")])
    out = bytearray(b"\xff\xd8")
    if colour == "ycbcr":
        out += _segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    elif colour == "rgb":
        out += _segment(0xEE, b"Adobe\0\x64\0\0\0\0\0")
    if orientation:
        out += exif_app1(orientation)
    sof = bytes([precision]) + struct.pack(">HH", h, w) + bytes([nc])
    for c in range(nc):
        sof += bytes([ids[c], 0x11, 0])
    out += _segment(0xC3, sof) + _segment(0xC4, body)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    sos = bytes([nc]) + b"".join(bytes([ids[c], 0]) for c in range(nc))
    out += _segment(0xDA, sos + bytes([predictor, 0, point]))
    bw, mcu, rst = _BitWriter(), 0, 0
    first_row = 0  # the row a restart made a first row
    for y in range(h):
        for xx in range(w):
            if restart and mcu and mcu % restart == 0:
                out += bw.flush() + bytes([0xFF, 0xD0 + rst % 8])
                rst += 1
                bw = _BitWriter()
                first_row = y
                # libjpeg restarts at row starts only when restart divides w
            for c in range(nc):
                ra = x[y, xx - 1, c] if xx else 0
                rb = x[y - 1, xx, c] if y else 0
                rc = x[y - 1, xx - 1, c] if y and xx else 0
                if y == first_row and xx == 0:
                    p = 1 << (precision - point - 1)
                elif y == first_row:
                    p = ra
                elif xx == 0:
                    p = rb
                else:
                    p = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                         5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                         7: (ra + rb) >> 1}[predictor]
                diff = (int(x[y, xx, c]) - int(p)) & 0xFFFF
                if diff >= 0x8000:
                    diff -= 0x10000
                s = 16 if diff == -0x8000 else _category(diff)
                bw.put(*codes[s])
                if s < 16:
                    _put_value(bw, diff, s)
            mcu += 1
    return bytes(out + bw.flush() + b"\xff\xd9")


# -------------------------------------------------------------------- GIF

def gif_lzw(indices, min_size: int, clear_every: int = None,
            deferred: bool = False) -> bytes:
    """Palette indices -> GIF's LZW codes, least significant bit first, in
    sub-blocks of up to 255 bytes ended by an empty one: a clear code first
    and whenever the table fills (or every `clear_every` codes), unless
    `deferred`, which goes on at 12 bits with the table full and no clear."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out, acc, nbits = bytearray(), 0, 0
    width = min_size + 1

    def put(code):  # the width grows once the decoder's table reaches it
        nonlocal acc, nbits, width
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
        if code not in (clear, end) and nxt >= 1 << width and width < 12:
            width += 1

    def reset():
        nonlocal table, nxt, width
        table = {(i,): i for i in range(clear)}
        nxt, width = end + 1, min_size + 1

    table, nxt = {}, 0
    reset()
    put(clear)
    data = [int(v) for v in np.asarray(indices).ravel()]
    w, emitted = (data[0],), 0
    for b in data[1:]:
        wc = w + (b,)
        if wc in table:
            w = wc
            continue
        put(table[w])
        emitted += 1
        if nxt < 4096:
            table[wc] = nxt
            nxt += 1
        if (nxt == 4096 and not deferred) or (
                clear_every and emitted % clear_every == 0):
            put(clear)
            reset()
        w = (b,)
    put(table[w])
    put(end)
    if nbits:
        out.append(acc & 0xFF)
    blocks = bytearray()
    for i in range(0, len(out), 255):
        chunk = out[i:i + 255]
        blocks += bytes([len(chunk)]) + chunk
    return bytes(blocks + b"\0")


def write_gif(indices, palette=None, screen=None, offset=(0, 0),
              local_palette=None, transparent: int = None,
              background: int = 0, interlace: bool = False,
              min_size: int = None, version: bytes = b"89a",
              extensions: bool = True, deferred: bool = False,
              clear_every: int = None, frames=(), disposal: int = 0) -> bytes:
    """(h, w) palette indices -> a GIF of one frame (plus `frames`, more
    index arrays drawn after it): palette (n, 3) the global colour table
    (None: none), screen (h, w) the logical screen (default the frame's),
    offset (top, left) of the frame on it, local_palette its own table,
    transparent the Graphic Control's transparent index (disposal its
    disposal method), background the screen's background index, interlace
    the four-pass row order."""
    idx = np.asarray(indices)
    h, w = idx.shape
    sh, sw = screen or (h, w)

    def table_bits(pal):
        n = len(pal)
        return max(1, int(np.ceil(np.log2(max(n, 2))))) - 1

    def table(pal):
        pal = np.asarray(pal, np.uint8)
        size = 2 << table_bits(pal)
        full = np.zeros((size, 3), np.uint8)
        full[:len(pal)] = pal
        return full.tobytes()

    out = bytearray(b"GIF" + version)
    flags = 0
    if palette is not None:
        flags = 0x80 | 0x70 | table_bits(palette)
    out += struct.pack("<HHBBB", sw, sh, flags, background, 0)
    if palette is not None:
        out += table(palette)
    if extensions:
        out += b"\x21\xfe" + bytes([7]) + b"comment" + b"\0"
        out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\0\0\0"
    for k, frame in enumerate([idx] + list(frames)):
        frame = np.asarray(frame)
        fh, fw = frame.shape
        if transparent is not None or extensions:
            gce = (1 if transparent is not None else 0) | disposal << 2
            out += b"\x21\xf9\x04" + bytes([gce]) + b"\x0a\0" + bytes(
                [transparent or 0]) + b"\0"
        fl = 0
        if local_palette is not None and k == 0:
            fl |= 0x80 | table_bits(local_palette)
        if interlace:
            fl |= 0x40
        top, left = offset if k == 0 else (0, 0)
        out += b"\x2c" + struct.pack("<HHHHB", left, top, fw, fh, fl)
        if local_palette is not None and k == 0:
            out += table(local_palette)
        rows = frame
        if interlace:
            order = (list(range(0, fh, 8)) + list(range(4, fh, 8)) +
                     list(range(2, fh, 4)) + list(range(1, fh, 2)))
            rows = frame[order]
        size = min_size or max(2, int(frame.max()).bit_length())
        out += bytes([size]) + gif_lzw(rows, size, clear_every, deferred)
    return bytes(out + b"\x3b")


# ------------------------------------------------------ Sun raster, PAM

def ras_rle(data: bytes) -> bytes:
    """Sun raster's byte encoding: a run of 3 or more bytes as 0x80, count
    - 1, value; a single 0x80 as 0x80 0x00; the rest literal."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 255:
            j += 1
        run = j - i + 1
        if run >= 3 or data[i] == 0x80:
            if run >= 2 or data[i] != 0x80:
                out += bytes([0x80, run - 1, data[i]])
            else:
                out += b"\x80\x00"
            i = j + 1
            continue
        out += bytes(data[i:i + run])
        i = j + 1
    return bytes(out)


def write_ras(samples, depth: int, colormap=None, rtype: int = 1,
              rows: str = "padded") -> bytes:
    """(h, w) indices or bits (depth 1, 8) or (h, w, 3) RGB (depth 24, 32)
    -> a Sun raster file: rtype 0 old, 1 standard, 2 byte-encoded (RLE), 3
    RGB order; colormap (n, 3) RGB as an equal-RGB map. 24-bit pixels are
    B, G, R (R, G, B under type 3); 32-bit ones a pad byte then those.
    Rows are padded to 16 bits; rows="unpadded" leaves that out (before the
    byte encoding)."""
    a = np.asarray(samples)
    h, w = a.shape[:2]
    if depth == 1:
        raw = np.packbits(a.astype(np.uint8), axis=1)
    elif depth == 8:
        raw = a.astype(np.uint8).reshape(h, w)
    else:
        px = a[..., ::-1] if rtype != 3 else a
        if depth == 32:
            px = np.concatenate([np.zeros((h, w, 1), px.dtype), px], 2)
        raw = px.astype(np.uint8).reshape(h, -1)
    if rows == "padded" and raw.shape[1] % 2:
        raw = np.concatenate([raw, np.zeros((h, 1), np.uint8)], 1)
    data = raw.tobytes()
    if rtype == 2:
        data = ras_rle(data)
    cmap = b""
    if colormap is not None:
        cmap = np.asarray(colormap, np.uint8).T.tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), rtype,
                       1 if colormap is not None else 0, len(cmap)) + \
        cmap + data


def write_pam(samples, maxval: int = 255, tupltype: str = None,
              comments: bool = False) -> bytes:
    """(h, w, depth) samples -> a PAM (P7) file, big-endian above 8 bits."""
    a = np.asarray(samples)
    h, w, depth = a.shape
    head = f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {depth}\nMAXVAL {maxval}\n"
    if comments:
        head = "P7\n# written by numpy\n" + head[3:]
    if tupltype:
        head += f"TUPLTYPE {tupltype}\n"
    body = a.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return (head + "ENDHDR\n").encode() + body


# ---------------------------------------------------------- PFM, HDR

def write_pfm(samples, scale: float = -1.0) -> bytes:
    """(h, w, 3) or (h, w) float32 samples -> a PFM file (PF, or Pf for
    gray): rows bottom-up, little-endian where `scale` is negative."""
    a = np.asarray(samples, np.float32)
    kind = "PF" if a.ndim == 3 else "Pf"
    h, w = a.shape[:2]
    order = "<" if scale < 0 else ">"
    return f"{kind}\n{w} {h}\n{scale}\n".encode() + \
        a[::-1].astype(order + "f4").tobytes()


def hdr_rle_scanline(row: np.ndarray) -> bytes:
    """One scanline of (w, 4) RGBE bytes in the new-style run-length
    encoding: 02 02 and the width, then each component's runs (a byte
    above 128 repeats the next one) and literals (up to 128 bytes)."""
    w = len(row)
    out = bytearray([2, 2, w >> 8, w & 0xFF])
    for c in range(4):
        v, i = row[:, c], 0
        while i < w:
            j = i
            while j + 1 < w and v[j + 1] == v[i] and j - i < 126:
                j += 1
            if j - i + 1 >= 3:
                out += bytes([128 + j - i + 1, v[i]])
                i = j + 1
                continue
            j = i
            while j < w and j - i < 128 and not (
                    j + 2 < w and v[j] == v[j + 1] == v[j + 2]):
                j += 1
            out += bytes([j - i]) + bytes(v[i:j].astype(np.uint8))
            i = j
    return bytes(out)


def write_hdr(rgbe, encoding: str = "rle", magic: bytes = b"#?RADIANCE",
              extra_lines=(b"EXPOSURE=1.0",)) -> bytes:
    """(h, w, 4) RGBE bytes -> a Radiance HDR file: encoding "rle" (the
    new-style run-length scanlines cv2.imwrite writes), "flat" (four bytes a
    pixel) or "old" (the old-style run-length code, a pixel of 1, 1, 1
    repeating the one before it count times, as flat pixels a reader
    without it sees)."""
    a = np.asarray(rgbe, np.uint8)
    h, w = a.shape[:2]
    head = magic + b"\n" + b"".join(line + b"\n" for line in extra_lines)
    head += b"FORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    if encoding == "rle":
        body = b"".join(hdr_rle_scanline(row) for row in a)
    elif encoding == "flat":
        body = a.tobytes()
    else:
        body = bytearray()
        for row in a:
            x = 0
            while x < w:
                body += bytes(row[x])
                j = x + 1
                while j < w and j - x < 255 and (row[j] == row[x]).all():
                    j += 1
                if j - x > 2:
                    body += bytes([1, 1, 1, j - x - 1])
                    x = j
                else:
                    x += 1
        body = bytes(body)
    return head + body


def rgbe(img: np.ndarray) -> np.ndarray:
    """(h, w, 3) float -> (h, w, 4) RGBE bytes, as Ward's float2rgbe."""
    img = np.asarray(img, np.float64)
    v = img.max(2)
    m, e = np.frexp(v)
    scale = np.where(v > 1e-32, m * 256.0 / np.where(v > 0, v, 1), 0)
    out = np.zeros(img.shape[:2] + (4,), np.uint8)
    out[..., :3] = np.floor(img * scale[..., None]).clip(0, 255)
    out[..., 3] = np.where(v > 1e-32, e + 128, 0)
    return out


# -------------------------------------------------------------- fixtures

def picture(h: int, w: int, seed: int, noise: int = 24) -> np.ndarray:
    """A seeded RGB picture: gradients, a disc and a bar, plus noise."""
    rs = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    img = np.stack([xs * 255 // max(w - 1, 1), ys * 255 // max(h - 1, 1),
                    (xs + ys) * 127 // max(h + w - 2, 1)], 2)
    disc = (ys - h * 0.45) ** 2 + (xs - w * 0.6) ** 2 < (min(h, w) * 0.3) ** 2
    img[disc] = (230, 60, 40)
    img[h // 5:h // 5 + max(h // 8, 1), :] = (20, 40, 200)
    if noise:
        img = img + rs.randint(-noise // 2, noise // 2 + 1, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil(img, fmt, **kw) -> bytes:
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt, **kw)
    return buf.getvalue()


def _webp_exif(orientation: int) -> bytes:
    from PIL import Image
    exif = Image.Exif()
    exif[274] = orientation
    return exif.tobytes()


def fixture_files():
    """{file name: (bytes, format, variant, expect)} of the committed
    fixtures: expect "pixels" (held to cv2.imread), "refused" (cv2 reads
    none of it either) or "not ported" (cv2 reads it, the port does not)."""
    import cv2
    rs = np.random.RandomState(12)
    a, b = picture(37, 53, 1), picture(45, 61, 2)
    out = {}

    def add(name, data, fmt, variant, expect="pixels"):
        out[name] = (data, fmt, variant, expect)

    pal = rs.randint(0, 256, (256, 3))
    idx = (a.astype(int).sum(2) // 3).astype(np.int64)
    add("bmp_pal1.bmp", write_bmp(idx >> 7, 1, pal[:2]), "BMP", "1-bit")
    add("bmp_pal4.bmp", write_bmp(idx >> 4, 4, pal[:16]), "BMP", "4-bit")
    add("bmp_pal8_topdown.bmp", write_bmp(idx, 8, pal, top_down=True), "BMP",
        "8-bit, top-down")
    add("bmp_os2_pal8.bmp", write_bmp(idx, 8, pal, header=12), "BMP",
        "8-bit, OS/2 core header")
    runs = np.repeat(idx[:, ::4], 4, 1)[:, :53]
    add("bmp_rle8.bmp", write_bmp(runs, 8, pal, compression=1), "BMP", "RLE8")
    add("bmp_rle4.bmp", write_bmp(runs >> 4, 4, pal[:16], compression=2),
        "BMP", "RLE4")
    add("bmp_rgb555.bmp", write_bmp(b, 16), "BMP", "16-bit 5-5-5")
    add("bmp_rgb565.bmp", write_bmp(b, 16, compression=3,
                                    masks=(0xF800, 0x7E0, 0x1F)),
        "BMP", "16-bit 5-6-5 bit fields")
    add("bmp_24.bmp", write_bmp(a, 24), "BMP", "24-bit")
    add("bmp_v4_24.bmp", write_bmp(b, 24, header=108, top_down=True), "BMP",
        "24-bit, V4 header, top-down")
    rgba = np.concatenate([b, rs.randint(0, 256, (45, 61, 1))], 2)
    add("bmp_32_v5.bmp", write_bmp(rgba, 32, compression=3, header=124,
                                   masks=(0xFF0000, 0xFF00, 0xFF,
                                          0xFF000000)),
        "BMP", "32-bit bit fields, V5 header, alpha")
    g = a[..., 1:2].astype(np.int64)
    add("pnm_p1.pbm", b"P1\n# bits\n53 37\n" + " ".join(
        str(v) for v in (g[..., 0] > 127).astype(int).ravel()).encode()
        + b"\n", "PNM", "P1 ASCII bits")
    add("pnm_p4.pbm", b"P4\n53 37\n" + np.packbits(
        (g[..., 0] > 100).astype(np.uint8), axis=1).tobytes(), "PNM",
        "P4 packed bits")
    add("pnm_p2_100.pgm", b"P2\n53 37\n100\n" + " ".join(
        str(v) for v in (g * 100 // 255).ravel()).encode() + b"\n", "PNM",
        "P2 ASCII, maxval 100")
    wide = b.astype(np.int64) * 1000 // 255
    add("pnm_p3_1000.ppm", b"P3\n61 45\n1000\n" + " ".join(
        str(v) for v in wide.ravel()).encode() + b"\n", "PNM",
        "P3 ASCII, maxval 1000")
    add("pnm_p5_65535.pgm", b"P5\n53 37\n65535\n" + (
        g * 257 + rs.randint(0, 256, g.shape)).astype(">u2").tobytes(),
        "PNM", "P5 16-bit")
    add("pnm_p6_100.ppm", b"P6\n61 45\n100\n" + (
        b.astype(np.int64) * 100 // 255).astype(np.uint8).tobytes(), "PNM",
        "P6 maxval 100")

    def enc(block):
        bgr = np.ascontiguousarray(block[..., ::-1])
        return cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 90])[
            1].tobytes()

    add("tiff_none_strips.tif", write_tiff(a, rows_per_strip=8), "TIFF",
        "none, strips")
    add("tiff_none_be_planar2.tif", write_tiff(b, order=">", planar=2,
                                               rows_per_strip=10),
        "TIFF", "none, big-endian, planar 2")
    add("tiff_packbits.tif", write_tiff(a, compression=32773), "TIFF",
        "PackBits")
    add("tiff_lzw_predictor.tif", write_tiff(b, compression=5, predictor=2,
                                             rows_per_strip=16),
        "TIFF", "LZW, predictor 2")
    add("tiff_lzw_old.tif", write_tiff(a, compression=5, old_lzw=True),
        "TIFF", "LZW, old-style codes")
    add("tiff_deflate_tiles.tif", write_tiff(b, compression=8,
                                             tile=(32, 32)),
        "TIFF", "Deflate, tiles")
    wide16 = b.astype(np.int64) * 257 + rs.randint(0, 256, b.shape)
    add("tiff_deflate_16bit_planar2.tif", write_tiff(
        wide16, bits=16, compression=8, predictor=2, planar=2,
        order=">", tile=(16, 32)), "TIFF",
        "Deflate, 16-bit, predictor 2, planar 2, tiles, big-endian")
    add("tiff_gray1_miniswhite.tif", write_tiff(
        (g > 127).astype(int), bits=1, photometric=0), "TIFF",
        "1-bit min-is-white")
    add("tiff_gray16_tiles.tif", write_tiff(
        g * 257 + rs.randint(0, 256, g.shape), bits=16, photometric=1,
        compression=5, tile=(32, 32)), "TIFF",
        "16-bit min-is-black, tiles (libtiff's clipped-tile stride)")
    add("tiff_palette4.tif", write_tiff(idx >> 4, bits=4,
                                        colormap=pal[:16].T * 257),
        "TIFF", "4-bit palette, 16-bit colour map")
    add("tiff_palette8.tif", write_tiff(idx, bits=8, colormap=pal.T,
                                        compression=5),
        "TIFF", "8-bit palette, 8-bit colour map")
    add("tiff_rgba_unassoc.tif", write_tiff(rgba, extra=2, compression=5),
        "TIFF", "RGBA, unassociated alpha")
    add("tiff_jpeg_ycbcr_tables.tif", write_tiff(
        b, compression=7, photometric=6, subsampling=(2, 2), jpeg=enc,
        jpeg_tables=True, rows_per_strip=16), "TIFF",
        "JPEG, YCbCr 4:2:0 strips, JPEGTables")
    add("tiff_jpeg_tiles.tif", write_tiff(
        a, compression=7, photometric=6, subsampling=(2, 2), jpeg=enc,
        tile=(16, 32)), "TIFF", "JPEG, YCbCr tiles")
    add("tiff_orient3.tif", write_tiff(b, compression=5, orientation=3,
                                       tile=(16, 16)),
        "TIFF", "orientation 3, tiles")
    add("tiff_orient6.tif", write_tiff(a, orientation=6), "TIFF",
        "orientation 6, not square", "refused")
    add("webp_lossless.webp", _pil(a, "WEBP", lossless=True), "WebP",
        "VP8L")
    add("webp_lossless_palette.webp", _pil(
        np.repeat((idx >> 6)[..., None] * 80, 3, 2).astype(np.uint8),
        "WEBP", lossless=True), "WebP", "VP8L colour indexing")
    add("webp_lossy.webp", _pil(b, "WEBP", quality=80), "WebP", "VP8")
    add("webp_lossy_alpha.webp", _pil(rgba.astype(np.uint8), "WEBP",
                                      quality=70), "WebP", "VP8X + ALPH")
    add("webp_lossy_orient6.webp", _pil(a, "WEBP", quality=90,
                                        exif=_webp_exif(6)),
        "WebP", "VP8, EXIF orientation 6")
    add("webp_lossless_orient3.webp", _pil(b, "WEBP", lossless=True,
                                           exif=_webp_exif(3)),
        "WebP", "VP8L, EXIF orientation 3")
    import io
    from PIL import Image
    frames = [Image.fromarray(picture(37, 53, k)) for k in range(3)]
    anim = io.BytesIO()
    frames[0].save(anim, "WEBP", save_all=True, append_images=frames[1:],
                   lossless=True, duration=100)
    add("webp_animation.webp", anim.getvalue(), "WebP",
        "animation (its first frame)")
    big = picture(480, 640, 3, noise=0)
    add("webp_lossy_480x640.webp", _pil(big, "WEBP", quality=80), "WebP",
        "VP8 at 480x640")
    add("webp_lossless_480x640.webp", _pil(big, "WEBP", lossless=True),
        "WebP", "VP8L at 480x640")
    add("tiff_lzw_480x640.tif", write_tiff(big, compression=5, predictor=2,
                                           rows_per_strip=32),
        "TIFF", "LZW, predictor 2, at 480x640")
    lossless = b.astype(np.int64)
    add("jpeg_lossless_p8.jpg", jpeg_lossless(lossless, 8, 4), "JPEG",
        "lossless, 8 bits, predictor 4")
    add("jpeg_lossless_p6_pt.jpg", jpeg_lossless(lossless >> 2, 6, 7, 1),
        "JPEG", "lossless, 6 bits, predictor 7, point transform 1")
    add("jpeg_lossless_cmyk_restart.jpg", jpeg_lossless(
        np.concatenate([lossless, 255 - lossless[..., :1]], 2), 8, 5,
        restart=61), "JPEG", "lossless CMYK, restarts")
    add("jpeg_lossless_orient6.jpg", jpeg_lossless(
        a.astype(np.int64), 8, 1, orientation=6), "JPEG",
        "lossless, EXIF orientation 6")
    twelve = a.astype(np.int64) * 16 + rs.randint(0, 16, a.shape)
    add("jpeg12_sequential.jpg", jpeg12(twelve), "JPEG",
        "12-bit sequential (SOF1)", "refused")
    add("jpeg12_progressive.jpg", jpeg12(twelve, progressive=True), "JPEG",
        "12-bit progressive (SOF2)", "refused")
    add("jpeg_lossless_gray.jpg", jpeg_lossless(g, 8, 1, colour="gray"),
        "JPEG", "lossless gray (needs a colour conversion)", "refused")
    add("jpeg_lossless_p16.jpg", jpeg_lossless(wide16, 16, 1), "JPEG",
        "lossless, 16 bits", "refused")
    bgr = np.ascontiguousarray(a[..., ::-1])
    for ext, fmt in ((".jp2", "JPEG 2000 (JP2)"), (".avif", "AVIF"),
                     (".hdr", "Radiance HDR"), (".pfm", "PFM"),
                     (".ras", "Sun raster"), (".pam", "PAM")):
        src = bgr.astype(np.float32) / 255 if ext in (".hdr", ".pfm") \
            else bgr
        add("other" + ext.replace(".", "_") + ext,
            cv2.imencode(ext, src)[1].tobytes(), fmt, "cv2.imencode")
    add("other_gif.gif", _pil(a, "GIF"), "GIF", "Pillow")
    _add_new_formats(add, a, b, big, rs)
    _add_tiff_tail(add)
    _add_avif(add)
    return out


def _add_new_formats(add, a, b, big, rs):
    """The fixtures of GIF, Sun raster, PAM, PFM, HDR and the TIFF variants
    (`tiffv_*`): a few variants of each, what cv2 refuses of each, and a
    480x640 GIF, HDR and Group 4 TIFF (the 480x640 Sun raster, PAM and PFM
    that chip_smoke.py times are written there from a 480x640 reference,
    rather than committed at their raw size)."""
    pal = rs.randint(0, 256, (256, 3))
    idx = rs.randint(0, 16, (37, 53))
    add("gif_offset_local_transparent.gif", write_gif(
        idx[:20, :30], pal[:16], screen=(37, 53), offset=(9, 17),
        local_palette=pal[100:116], transparent=3, background=7), "GIF",
        "frame at an offset, local palette, transparency")
    add("gif_interlaced_deferred.gif", write_gif(
        rs.randint(0, 256, (61, 97)), pal, interlace=True, deferred=True),
        "GIF", "interlaced, deferred clear")
    add("gif_no_palette.gif", write_gif(rs.randint(0, 256, (37, 53)), None),
        "GIF", "no colour table (OpenCV's default one)")
    big_pal = (np.arange(256)[:, None] * [1, 3, 7] % 256)
    big_idx = ((big[..., 0].astype(int) // 8) * 8 +
               big[..., 2].astype(int) // 32) % 256
    add("gif_480x640.gif", write_gif(big_idx, big_pal), "GIF",
        "480x640, 256 colours")
    add("gif_bg_past_table.gif", write_gif(idx[:4, :4] % 4, pal[:4],
                                           screen=(37, 53), background=9),
        "GIF", "background index past the table", "refused")
    gidx = rs.randint(0, 256, (45, 61))
    add("ras_pal8.ras", write_ras(gidx, 8, pal), "Sun raster",
        "8-bit, colour map")
    add("ras_1bit.ras", write_ras(rs.randint(0, 2, (37, 53)), 1),
        "Sun raster", "1-bit, no map")
    add("ras_32_old.ras", write_ras(b, 32, rtype=0), "Sun raster",
        "32-bit, old type")
    add("ras_rle.ras", write_ras(gidx, 8, pal, rtype=2), "Sun raster",
        "byte-encoded (RLE)", "refused")
    wide16 = b.astype(np.int64) * 257 + rs.randint(0, 256, b.shape)
    add("pam_rgb16.pam", write_pam(wide16, 65535, "RGB"), "PAM",
        "RGB, maxval 65535")
    add("pam_gray100.pam", write_pam(a[..., :1].astype(int) * 100 // 255,
                                     100, comments=True), "PAM",
        "gray, maxval 100, no TUPLTYPE")
    add("pam_bw.pam", write_pam(rs.randint(0, 2, (37, 53, 1)), 1,
                                "BLACKANDWHITE"), "PAM",
        "maxval 1 (read as packed bits)")
    add("pam_rgb_as_gray.pam", write_pam(a, 255, "GRAYSCALE"), "PAM",
        "TUPLTYPE GRAYSCALE at depth 3", "refused")
    f = b.astype(np.float32) * 2 + rs.uniform(-0.5, 0.5, b.shape).astype(
        np.float32)
    add("pfm_scale2_be.pfm", write_pfm(f, 2.0), "PFM",
        "scale 2, big-endian")
    add("pfm_gray.pfm", write_pfm(f[..., 0]), "PFM", "one channel (Pf)",
        "refused")
    add("hdr_rle.hdr", write_hdr(rgbe(a.astype(np.float64) / 200)),
        "Radiance HDR", "run-length scanlines")
    add("hdr_flat.hdr", write_hdr(rgbe(b.astype(np.float64) / 90), "flat",
                                  magic=b"#?RGBE"), "Radiance HDR",
        "flat pixels")
    add("hdr_480x640.hdr", write_hdr(rgbe((big // 16 * 16).astype(
        np.float64) / 255)), "Radiance HDR", "480x640, run-length")
    runs = rgbe(a.astype(np.float64) / 255)
    runs[5, 3:30] = runs[5, 3]
    add("hdr_old_rle.hdr", write_hdr(runs, "old"), "Radiance HDR",
        "old-style run-length pixels", "refused")
    bilevel = a[..., 0] > 120
    add("tiffv_mh.tif", pil_tiff(bilevel, "tiff_ccitt"), "TIFF",
        "CCITT modified Huffman")
    add("tiffv_g3_2d.tif", pil_tiff(bilevel, "group3", {292: 1, 278: 16}),
        "TIFF", "CCITT Group 3, 2-D, strips")
    add("tiffv_g4_fill_order2.tif", set_tiff_tag(
        pil_tiff(bilevel, "group4", {266: 2}), 262, 0), "TIFF",
        "CCITT Group 4, FillOrder 2, min-is-white")
    bands = (big[..., 0] // 16 + big[..., 1] // 16 + big[..., 2] // 32) % 2
    add("tiffv_g4_480x640.tif", pil_tiff(bands == 0, "group4"),
        "TIFF", "CCITT Group 4 at 480x640")
    add("tiffv_bigtiff.tif", write_tiff(b, compression=5, bigtiff=True,
                                        order=">", tile=(16, 32)), "TIFF",
        "BigTIFF, LZW tiles, big-endian")
    add("tiffv_cmyk.tif", write_tiff(rs.randint(0, 256, (45, 61, 4)),
                                     photometric=5, compression=8), "TIFF",
        "CMYK")
    import cv2
    ycc = cv2.cvtColor(b, cv2.COLOR_RGB2YCrCb)[..., [0, 2, 1]]
    add("tiffv_ycbcr22.tif", write_tiff(ycc, photometric=6,
                                        subsampling=(2, 2), compression=5,
                                        rows_per_strip=8), "TIFF",
        "YCbCr 2x2 outside JPEG")
    add("tiffv_ycbcr44_tiles.tif", write_tiff(
        ycc, photometric=6, subsampling=(4, 4), tile=(16, 32)), "TIFF",
        "YCbCr 4x4 tiles (libtiff's clipped-tile skip)")
    add("tiffv_signed16.tif", write_tiff(wide16, bits=16, sample_format=2,
                                         compression=8), "TIFF",
        "signed 16-bit samples")
    add("tiffv_gray_alpha_planes.tif", write_tiff(
        rs.randint(0, 256, (37, 53, 2)), photometric=1, planar=2, extra=2),
        "TIFF", "gray + unassociated alpha in separate planes")
    add("tiffv_lzma.tif", write_tiff(a, compression=34925), "TIFF",
        "LZMA (cv2's libtiff lacks it)", "refused")
    add("tiffv_zstd.tif", write_tiff(a, compression=50000), "TIFF",
        "ZSTD (cv2's libtiff lacks it)", "refused")
    add("tiffv_float32.tif", write_tiff(
        (a.astype(np.float32) / 255).view(np.uint32), bits=32,
        sample_format=3), "TIFF", "float samples", "refused")
    add("tiffv_cielab.tif", write_tiff(a, photometric=8), "TIFF",
        "CIELab")
    # the compressions cv2's libtiff cannot decode: the picture of zero
    # samples (the strips hold the pictures uncompressed all the same)
    add("tiffb_pixar_rgb.tif", write_tiff(a, compression=32908,
                                          rows_per_strip=8), "TIFF",
        "Pixar compression (32908), RGB strips: black")
    add("tiffb_next_miniswhite.tif", write_tiff(
        a[..., 0], photometric=0, compression=32947), "TIFF",
        "NeXT compression (32947), min-is-white: white")
    add("tiffb_jp2k_palette_tiles.tif", write_tiff(
        idx, compression=34712, tile=(16, 16), colormap=np.tile(
            np.arange(256, dtype=np.uint16) * 200 + 9000, (3, 1))), "TIFF",
        "JPEG 2000 compression (34712), palette tiles: entry 0")


def _tiff_values_at(data: bytes, tag: int):
    """(byte order, struct format, count, where the values are) of a SHORT
    or LONG tag of a classic TIFF's first IFD."""
    order, p, typ, count = _tiff_entry(data, tag)
    f, size = ("H", 2) if typ == 3 else ("I", 4)
    at = p + 8 if size * count <= 4 else struct.unpack(
        order + "I", data[p + 8:p + 12])[0]
    return order, f, count, at


def set_tiff_values(data: bytes, tag: int, values) -> bytes:
    """A classic TIFF with every value of a SHORT or LONG tag of its first
    IFD set to `values` (as many as it holds), in line or where they are
    stored."""
    order, f, count, at = _tiff_values_at(data, tag)
    assert count == len(values), (tag, count, len(values))
    body = struct.pack(order + f * count, *values)
    out = bytearray(data)
    out[at:at + len(body)] = body
    return bytes(out)


def tiff_values(data: bytes, tag: int):
    """The values of a SHORT or LONG tag of a classic TIFF's first IFD."""
    order, f, count, at = _tiff_values_at(data, tag)
    return list(struct.unpack_from(order + f * count, data, at))


def drop_tiff_tag(data: bytes, tag: int) -> bytes:
    """A classic TIFF whose first IFD no longer holds `tag`."""
    order = "<" if data[:2] == b"II" else ">"
    ifd = struct.unpack(order + "I", data[4:8])[0]
    n = struct.unpack(order + "H", data[ifd:ifd + 2])[0]
    entries = [data[ifd + 2 + 12 * e:ifd + 14 + 12 * e] for e in range(n)]
    kept = [x for x in entries if struct.unpack(order + "H", x[:2])[0] != tag]
    out = bytearray(data)
    out[ifd:ifd + 2 + 12 * n + 4] = (struct.pack(order + "H", len(kept)) +
                                     b"".join(kept) + bytes(4) +
                                     bytes(12 * (n - len(kept))))
    return bytes(out)


def sgilog_tiff(words, compression: int, photometric: int, **kw) -> bytes:
    """write_sgilog (libtiff's SGILog encoder, through the libtiff shared
    library) of raw words, as bytes."""
    import os
    import tempfile
    from semi_detr_tpu_torch.tools.sgilog_table import write_sgilog
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sgilog.tif")
        write_sgilog(path, words, compression, photometric, **kw)
        with open(path, "rb") as f:
            return f.read()


def sgilog_words(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    """Seeded raw SGILog words of a (h, w) picture: LogL 16-bit (a few
    negative and zero, runs), LogLuv 32 (zero luminance, a negative row,
    runs) or LogLuv 24 (every kind of uv index, past the grid too)."""
    rs = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    if kind == "logl":
        le = 13500 + (xs * 3000 // max(w - 1, 1)) + rs.randint(0, 400, (h, w))
        le[:, :2] = 0
        le[h // 3, :] |= 0x8000
        le[h // 2:h // 2 + 3, 3:w - 2] = 15000
        return le.astype(np.uint16).view(np.int16)
    if kind == "luv32":
        le = 14500 + (ys * 2500 // max(h - 1, 1)) + rs.randint(0, 300, (h, w))
        le[1, :3] = 0
        le[h // 4, :] |= 0x8000
        u = 70 + xs * 60 // max(w - 1, 1) + rs.randint(0, 8, (h, w))
        v = 150 + ys * 60 // max(h - 1, 1) + rs.randint(0, 8, (h, w))
        out = (le.astype(np.uint32) << 16) | (u << 8) | v
        out[h // 2:h // 2 + 4, 2:w - 3] = out[h // 2, 2]
        return out.astype(np.uint32)
    le = 700 + (xs * 200 // max(w - 1, 1)) + rs.randint(0, 20, (h, w))
    le[0, :2] = 0
    c = rs.randint(0, 16384, (h, w))
    return ((le.astype(np.uint32) << 14) | c).astype(np.uint32)


def cielab(img: np.ndarray, bits: int = 8, seed: int = 0) -> np.ndarray:
    """RGB -> CIELab samples as TIFF stores them: L* in 0-255, a* and b* as
    signed bytes (cv2's Lab with its offset of 128 taken out); at 16 bits
    L* times 257 and a*, b* times 256 as signed 16-bit words, plus seeded
    noise in their low bytes."""
    import cv2
    lab = cv2.cvtColor(np.ascontiguousarray(img), cv2.COLOR_RGB2Lab).astype(
        np.int64)
    if bits == 8:
        return lab ^ np.array([0, 0x80, 0x80])
    noise = np.random.RandomState(seed).randint(0, 256, lab.shape)
    wide = np.concatenate([lab[..., :1] * 257,
                           (lab[..., 1:] - 128) * 256 + noise[..., 1:]], 2)
    return wide & 0xFFFF


def _add_tiff_tail(add):
    """The TIFF variants of test_torch_tiff_tail.py (`tiffx_*`): orientation
    5-8 on square pictures, StripByteCounts libtiff estimates anew, CMYK
    inside JPEG, a predictor on subsampled YCbCr, CIELab, SGILog (LogL,
    LogLuv 32 and 24), ThunderScan, what cv2 refuses of them, and a 480x640
    CIELab file (the image demo's TIFF input)."""
    import cv2
    rs = np.random.RandomState(18)
    sq = picture(40, 40, 7)
    add("tiffx_orient5.tif", write_tiff(sq, orientation=5, compression=5,
                                        rows_per_strip=7), "TIFF",
        "orientation 5, square, strips")
    add("tiffx_orient6_tiles.tif", write_tiff(
        sq, orientation=6, compression=8, tile=(16, 16)), "TIFF",
        "orientation 6, square, tiles across a width of 40")
    add("tiffx_orient7_planar2.tif", write_tiff(
        sq, orientation=7, planar=2, tile=(16, 32)), "TIFF",
        "orientation 7, square, planar 2 tiles")
    add("tiffx_orient8_gray16.tif", write_tiff(
        sq[..., :1].astype(np.int64) * 257, bits=16, photometric=1,
        orientation=8, compression=5, rows_per_strip=9), "TIFF",
        "orientation 8, square, 16-bit gray")
    c = picture(29, 43, 8)
    one = write_tiff(c)
    add("tiffx_counts_zero.tif", set_tiff_values(one, 279, [0]), "TIFF",
        "one uncompressed strip, StripByteCounts 0 (estimated)")
    add("tiffx_counts_short.tif", set_tiff_values(one, 279, [100]), "TIFF",
        "one uncompressed strip, StripByteCounts 100 (estimated)")
    add("tiffx_counts_missing_lzw.tif", drop_tiff_tag(
        write_tiff(c, compression=5), 279), "TIFF",
        "one LZW strip, no StripByteCounts (estimated)")
    tiles = write_tiff(c, tile=(16, 16))
    counts = tiff_values(tiles, 325)
    add("tiffx_counts_wrong_tiles.tif", set_tiff_values(
        tiles, 325, [7] + counts[1:]), "TIFF",
        "uncompressed tiles, first two counts differ (estimated)")
    cmyk = np.concatenate([c, rs.randint(0, 256, (29, 43, 1))], 2)

    import io
    from PIL import Image

    def adobe_cmyk(block):  # Pillow's CMYK JPEG: an Adobe marker
        out = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(block.astype(np.uint8)),
                        "CMYK").save(out, "JPEG", quality=90)
        return out.getvalue()
    buf = io.BytesIO()
    Image.fromarray(cmyk.astype(np.uint8), "CMYK").save(
        buf, "TIFF", compression="jpeg")
    add("tiffx_cmyk_jpeg.tif", buf.getvalue(), "TIFF",
        "CMYK inside JPEG (Pillow's libtiff)")
    add("tiffx_cmyk_jpeg_adobe_tiles.tif", write_tiff(
        cmyk, photometric=5, compression=7, jpeg=adobe_cmyk, tile=(16, 16),
        jpeg_tables=True), "TIFF",
        "CMYK inside JPEG, Adobe marker, tiles, JPEGTables")
    ycc = cv2.cvtColor(c, cv2.COLOR_RGB2YCrCb)[..., [0, 2, 1]]
    add("tiffx_ycbcr21_predictor.tif", write_tiff(
        ycc[:, :42], photometric=6, subsampling=(2, 1), compression=5,
        predictor=2, rows_per_strip=8), "TIFF",
        "YCbCr 2x1, LZW, predictor 2, strips")
    add("tiffx_ycbcr42_predictor_tiles.tif", write_tiff(
        ycc, photometric=6, subsampling=(4, 2), compression=8, predictor=2,
        tile=(16, 16)), "TIFF",
        "YCbCr 4x2, Deflate, predictor 2, tiles (libtiff leaves them "
        "undifferenced)")
    add("tiffx_ycbcr44_predictor.tif", write_tiff(
        ycc, photometric=6, subsampling=(4, 4), compression=5, predictor=2,
        tile=(16, 32)), "TIFF", "YCbCr 4x4, LZW, predictor 2, tiles")
    lab = cielab(c)
    add("tiffx_cielab16_tiles.tif", write_tiff(
        cielab(c, 16), bits=16, photometric=8, compression=5, predictor=2,
        tile=(16, 32)), "TIFF", "CIELab, 16 bits, LZW, predictor 2, tiles")
    add("tiffx_cielab_whitepoint.tif", write_tiff(
        lab, photometric=8, compression=8, rows_per_strip=8,
        white_point=((3127, 10000), (3290, 10000))), "TIFF",
        "CIELab, 8 bits, WhitePoint D65")
    for kind, comp, ph, name, kw in (
            ("logl", 34676, 32844, "tiffx_sgilog_logl.tif",
             dict(rows_per_strip=8)),
            ("luv32", 34676, 32845, "tiffx_sgilog_luv32.tif",
             dict(order=">")),
            ("luv24", 34677, 32845, "tiffx_sgilog_luv24_tiles.tif",
             dict(tile=(16, 16)))):
        add(name, sgilog_tiff(sgilog_words(kind, 29, 43, comp + ph), comp,
                              ph, **kw), "TIFF",
            {"logl": "SGILog LogL", "luv32": "SGILog LogLuv 32",
             "luv24": "SGILog LogLuv 24"}[kind] + " (libtiff's encoder), " +
            ", ".join(f"{k} {v}" for k, v in kw.items()))
    idx = np.clip(c[..., 0].astype(np.int64) // 16, 0, 15)
    idx[5, 4:30] = 9
    add("tiffx_thunderscan.tif", write_tiff(
        idx, bits=4, colormap=rs.randint(0, 65536, (3, 16)),
        compression=32809, rows_per_strip=8), "TIFF",
        "ThunderScan, 4-bit palette")
    add("tiffx_predictor3_int.tif", write_tiff(c, compression=5, predictor=3),
        "TIFF", "the floating-point predictor on integer samples", "refused")
    add("tiffx_icclab.tif", write_tiff(lab, photometric=9), "TIFF",
        "ICC CIELab (photometric 9)", "refused")
    add("tiffx_logluv_lzw.tif", write_tiff(c, photometric=32845,
                                           compression=5), "TIFF",
        "LogLuv without SGILog compression", "refused")
    big = picture(480, 640, 9, noise=0)
    add("tiffx_cielab_480x640.tif", write_tiff(
        cielab(big), photometric=8, compression=5, predictor=2,
        rows_per_strip=16), "TIFF", "CIELab, LZW, predictor 2, at 480x640")


# ------------------------------------------------------------------- AVIF

def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full(kind: bytes, version: int, flags: int, body: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags) + body)


def avif_boxes(data: bytes, start: int = 0, end: int = None):
    """[(type, body start, body end)] of the boxes in data[start:end]."""
    end = len(data) if end is None else end
    out, p = [], start
    while p < end:
        size, kind = struct.unpack(">I4s", data[p:p + 8])
        hdr = 8
        if size == 1:
            size, hdr = struct.unpack(">Q", data[p + 8:p + 16])[0], 16
        elif size == 0:
            size = end - p
        out.append((kind, p + hdr, p + size))
        p += size
    return out


def avif_items(data: bytes):
    """The still image cv2.imwrite writes, taken apart: {"primary": id,
    "items": {id: {"type", "data", "props": [property boxes],
    "essential": [bool]}}, "refs": [(type, from, [to])]}. Item data is
    read through iloc (version 0-2, file or idat offsets)."""
    meta = next(b for b in avif_boxes(data) if b[0] == b"meta")
    boxes = {k: (s, e) for k, s, e in avif_boxes(data, meta[1] + 4, meta[2])}
    items, props, refs = {}, [], []
    s, e = boxes[b"pitm"]
    primary = struct.unpack(">H" if data[s] == 0 else ">I",
                            data[s + 4:s + (6 if data[s] == 0 else 8)])[0]
    s, e = boxes[b"iinf"]
    n_off = 6 if data[s] == 0 else 8
    for kind, bs, be_ in avif_boxes(data, s + n_off, e):
        v = data[bs]
        iid = struct.unpack(">H", data[bs + 4:bs + 6])[0] if v == 2 else \
            struct.unpack(">I", data[bs + 4:bs + 8])[0]
        t = data[bs + 8:bs + 12] if v == 2 else data[bs + 10:bs + 14]
        items[iid] = {"type": t, "props": [], "essential": []}
    s, e = boxes[b"iprp"]
    for kind, bs, be_ in avif_boxes(data, s, e):
        if kind == b"ipco":
            props = [data[ps - 8:pe] for _, ps, pe in avif_boxes(data, bs, be_)]
        if kind == b"ipma":
            v, flags = data[bs], int.from_bytes(data[bs + 1:bs + 4], "big")
            n = struct.unpack(">I", data[bs + 4:bs + 8])[0]
            p = bs + 8
            for _ in range(n):
                iid = struct.unpack(">H" if v < 1 else ">I", data[p:p + (2 if v < 1 else 4)])[0]
                p += 2 if v < 1 else 4
                k = data[p]
                p += 1
                for _ in range(k):
                    if flags & 1:
                        x = struct.unpack(">H", data[p:p + 2])[0]
                        p += 2
                        idx, ess = x & 0x7FFF, bool(x & 0x8000)
                    else:
                        idx, ess = data[p] & 0x7F, bool(data[p] & 0x80)
                        p += 1
                    items[iid]["props"].append(props[idx - 1])
                    items[iid]["essential"].append(ess)
    if b"iref" in boxes:
        s, e = boxes[b"iref"]
        v = data[s]
        for kind, bs, be_ in avif_boxes(data, s + 4, e):
            w = 2 if v == 0 else 4
            fr = int.from_bytes(data[bs:bs + w], "big")
            n = struct.unpack(">H", data[bs + w:bs + w + 2])[0]
            to = [int.from_bytes(data[bs + w + 2 + w * i:bs + w + 2 + w * (i + 1)], "big")
                  for i in range(n)]
            refs.append((kind, fr, to))
    idat = boxes.get(b"idat")
    s, e = boxes[b"iloc"]
    v = data[s]
    p = s + 4
    off_size, len_size = data[p] >> 4, data[p] & 15
    base_size, idx_size = data[p + 1] >> 4, (data[p + 1] & 15) if v else 0
    p += 2
    def num(size):
        nonlocal p
        x = int.from_bytes(data[p:p + size], "big") if size else 0
        p += size
        return x
    count = num(2 if v < 2 else 4)
    for _ in range(count):
        iid = num(2 if v < 2 else 4)
        method = num(2) & 15 if v else 0
        num(2)
        base = num(base_size)
        chunks = []
        for _ in range(num(2)):
            num(idx_size)
            off, length = num(off_size), num(len_size)
            src = data if method == 0 else data[idat[0]:idat[1]]
            chunks.append(src[base + off:base + off + length])
        items[iid]["data"] = b"".join(chunks)
    return {"primary": primary, "items": items, "refs": refs,
            "ftyp": next(data[s - 8:e] for k, s, e in avif_boxes(data) if k == b"ftyp")}


def write_avif(items: dict, primary: int, refs=(), ftyp: bytes = None,
               iloc_version: int = 0, field_size: int = 4, base_size: int = 0,
               in_idat=(), split_extents=(), pitm_version: int = 0,
               ipma_large: bool = False, big_mdat: bool = False) -> bytes:
    """An AVIF file of `items` ({id: {"type", "data", "props",
    "essential"}}, as avif_items gives them) with the primary item and the
    references given: iloc of `iloc_version` with offsets and lengths of
    `field_size` bytes and a base offset of `base_size` (which the extents
    count from); the items of `in_idat` stored in an idat box
    (construction method 1), those of `split_extents` as two extents;
    ipma of 15-bit indices where `ipma_large`; a 64-bit mdat size where
    `big_mdat`."""
    ftyp = ftyp or _box(b"ftyp", b"avif" + bytes(4) + b"avifmif1miaf")
    props = []
    for it in items.values():
        for pb in it["props"]:
            if pb not in props:
                props.append(pb)
    ids = sorted(items)
    w = 2 if pitm_version == 0 else 4
    hdlr = _full(b"hdlr", 0, 0, bytes(4) + b"pict" + bytes(12) + b"\0")
    pitm = _full(b"pitm", pitm_version, 0, primary.to_bytes(w, "big"))
    infes = b"".join(_full(b"infe", 2, 0, struct.pack(">HH", i, 0) + items[i]["type"] + b"\0")
                     for i in ids)
    iinf = _full(b"iinf", 0, 0, struct.pack(">H", len(ids)) + infes)
    iref = b""
    if refs:
        iref = _full(b"iref", 0, 0, b"".join(
            _box(k, struct.pack(">HH", fr, len(to)) + b"".join(struct.pack(">H", t) for t in to))
            for k, fr, to in refs))
    ipco = _box(b"ipco", b"".join(props))
    entries = b""
    for i in ids:
        it = items[i]
        entries += struct.pack(">HB", i, len(it["props"]))
        for pb, ess in zip(it["props"], it["essential"]):
            k = props.index(pb) + 1
            entries += struct.pack(">H", k | (0x8000 if ess else 0)) if ipma_large \
                else bytes([k | (0x80 if ess else 0)])
    ipma = _full(b"ipma", 0, 1 if ipma_large else 0, struct.pack(">I", len(ids)) + entries)
    iprp = _box(b"iprp", ipco + ipma)
    idat_body = b"".join(items[i]["data"] for i in ids if i in in_idat)
    idat = _box(b"idat", idat_body) if idat_body else b""
    mdat_body = b"".join(items[i]["data"] for i in ids if i not in in_idat)

    def iloc(mdat_start):
        fs = field_size
        sizes = bytes([(fs << 4) | fs, (base_size << 4)])
        body = sizes + (struct.pack(">H", len(ids)) if iloc_version < 2
                        else struct.pack(">I", len(ids)))
        at_m, at_i = mdat_start, 0
        for i in ids:
            d = items[i]["data"]
            body += i.to_bytes(2 if iloc_version < 2 else 4, "big")
            if iloc_version:
                body += struct.pack(">H", 1 if i in in_idat else 0)
            body += struct.pack(">H", 0)
            start = at_i if i in in_idat else at_m
            base = start if base_size else 0
            if base_size:
                body += base.to_bytes(base_size, "big")
            parts = [(start, len(d))]
            if i in split_extents:
                half = len(d) // 2
                parts = [(start, half), (start + half, len(d) - half)]
            body += struct.pack(">H", len(parts))
            for off, n in parts:
                body += (off - base).to_bytes(fs, "big") + n.to_bytes(fs, "big")
            if i in in_idat:
                at_i += len(d)
            else:
                at_m += len(d)
        return _full(b"iloc", iloc_version, 0, body)

    def meta(mdat_start):
        return _full(b"meta", 0, 0, hdlr + pitm + iloc(mdat_start) + iinf +
                     iref + iprp + idat)

    hdr = 16 if big_mdat else 8
    start = len(ftyp) + len(meta(0)) + hdr
    m = meta(start)
    mdat = (struct.pack(">I4sQ", 1, b"mdat", 16 + len(mdat_body)) if big_mdat
            else struct.pack(">I4s", 8 + len(mdat_body), b"mdat")) + mdat_body
    return ftyp + m + mdat


def avif_cv2(img: np.ndarray, quality: int = 100, depth: int = 8,
             speed: int = None) -> bytes:
    """cv2.imwrite's AVIF of a BGR(A) or gray picture (uint16 at depth 10
    or 12); at quality 100 a lossless AV1 key frame, 4:4:4 and the
    identity matrix (or monochrome)."""
    import cv2
    params = [cv2.IMWRITE_AVIF_QUALITY, quality, cv2.IMWRITE_AVIF_DEPTH, depth]
    if speed is not None:
        params += [cv2.IMWRITE_AVIF_SPEED, speed]
    ok, buf = cv2.imencode(".avif", img, params)
    assert ok
    return buf.tobytes()


class _Bits:
    """MSB-first bit reading and writing of the AV1 headers."""

    def __init__(self, data: bytes = b""):
        self.bits = "".join(format(x, "08b") for x in data)
        self.p = 0

    def f(self, n: int) -> int:
        v = int(self.bits[self.p:self.p + n] or "0", 2) if n else 0
        self.p += n
        return v

    def take(self, n: int) -> str:
        self.p += n
        return self.bits[self.p - n:self.p]

    def su(self, n: int) -> int:
        v = self.f(n)
        return v - (1 << n) if v >> (n - 1) else v


def _leb128(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def av1_obus(data: bytes):
    """[(type, header byte, payload)] of a temporal unit whose OBUs carry
    sizes and no extension."""
    out, p = [], 0
    while p < len(data):
        h = data[p]
        size, k = 0, 0
        while True:
            b = data[p + 1 + k]
            size |= (b & 0x7F) << (7 * k)
            k += 1
            if not b & 0x80:
                break
        out.append(((h >> 3) & 15, h, data[p + 1 + k:p + 1 + k + size]))
        p += 1 + k + size
    return out


def av1_join(obus) -> bytes:
    return b"".join(bytes([h]) + _leb128(len(body)) + body for _, h, body in obus)


def _pack(bits: str) -> bytes:
    bits += "1"  # trailing one bit, then zeros to the byte
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def _seq_fields(seq: bytes) -> dict:
    """The fields of a reduced still picture sequence header that the
    rewrites need, and its bits cut where the full syntax inserts some."""
    r = _Bits(seq)
    f = {"profile": r.f(3), "still": r.f(1), "reduced": r.f(1), "level": r.f(5)}
    assert f["reduced"] == 1
    start = r.p
    wb, hb = r.f(4) + 1, r.f(4) + 1
    f["width"], f["height"] = r.f(wb) + 1, r.f(hb) + 1
    f["dims"] = r.bits[start:r.p]
    f["sb128"] = r.f(1)
    f["flags"] = r.take(2)  # filter intra, edge filter
    tail = r.p
    r.f(3)  # superres, cdef, restoration
    hbd = r.f(1)
    profile = f["profile"]
    depth = (12 if r.f(1) else 10) if profile == 2 and hbd else (10 if hbd else 8)
    f["mono"] = r.f(1) if profile != 1 else 0
    cp = tc = mc = 2
    if r.f(1):
        cp, tc, mc = r.f(8), r.f(8), r.f(8)
    f["separate"] = 0
    if f["mono"]:
        r.f(1)
    else:
        if not (cp == 1 and tc == 13 and mc == 0):
            r.f(1)
            if profile == 2 and depth == 12 and r.f(1):
                r.f(1)
        f["separate"] = r.f(1)
    assert not r.f(1)  # film grain
    f["tail"] = r.bits[tail:r.p]
    return f


def _frame_fields(frame: bytes, seq: dict) -> dict:
    """Bit positions in a reduced-header lossless key frame's header: its
    head (before tile info), the segmentation flag and the header's end;
    "data" is the tile data."""
    r = _Bits(frame)
    f = {"dcu": r.f(1), "sc": r.f(1)}
    f["fimv"] = r.take(1) if f["sc"] else ""
    f["rd"] = r.f(1)
    f["render"] = r.take(32) if f["rd"] else ""
    f["ibc"] = r.take(1) if f["sc"] else ""
    f["tile_info"] = r.p
    sb = 32 if seq["sb128"] else 16
    mi_cols, mi_rows = 2 * ((seq["width"] + 7) >> 3), 2 * ((seq["height"] + 7) >> 3)

    def log2(target):
        k = 0
        while (1 << k) < target:
            k += 1
        return k
    assert r.f(1) == 1  # uniform tile spacing, one tile
    for n in ((mi_cols + sb - 1) // sb, (mi_rows + sb - 1) // sb):
        if log2(min(n, 64)):
            assert r.f(1) == 0
    assert r.f(8) == 0  # base_q_idx: lossless
    if r.f(1):
        r.f(7)
    if not seq["mono"]:
        diff = r.f(1) if seq["separate"] else 0
        for _ in range(4 if diff else 2):
            if r.f(1):
                r.f(7)
    if r.f(1):  # using_qmatrix
        r.f(8 + (4 if seq["separate"] else 0))
    f["segmentation"] = r.p
    assert r.f(1) == 0
    r.f(1)  # reduced_tx_set
    f["end"] = r.p
    f["bits"] = r.bits
    f["data"] = frame[(r.p + 7) // 8:]
    return f


def _with_headers(item: bytes, seq_bits: str, frame_bits: str) -> bytes:
    frame_bits += "0" * (-len(frame_bits) % 8)
    head = bytes(int(frame_bits[i:i + 8], 2) for i in range(0, len(frame_bits), 8))
    out = []
    for t, h, body in av1_obus(item):
        if t == 1 and seq_bits is not None:
            body = _pack(seq_bits)
        elif t == 6:
            body = head + _frame_fields(body, _seq_fields(
                next(b for tt, _, b in av1_obus(item) if tt == 1)))["data"]
        out.append((t, h, body))
    return av1_join(out)


def av1_full_headers(item: bytes) -> bytes:
    """The AV1 data of a cv2-written lossless item with its reduced still
    picture sequence header written out in full (timing info, one
    operating point with an initial display delay, the enable flags) and
    its frame header as a shown key frame of such a sequence: the same
    picture through the other header syntax."""
    obus = av1_obus(item)
    seq = _seq_fields(next(body for t, _, body in obus if t == 1))
    fr = _frame_fields(next(body for t, _, body in obus if t == 6), seq)
    full = (format(seq["profile"], "03b") + format(seq["still"], "01b") + "0" +
            "1" + format(1, "032b") + format(25, "032b") + "0" + "0" + "1" +
            format(0, "05b") + format(0, "012b") + format(seq["level"], "05b") +
            ("0" if seq["level"] > 7 else "") + "1" + format(9, "04b") +
            seq["dims"] + "0" + format(seq["sb128"], "01b") + seq["flags"] +
            "00000" + "11" + seq["tail"])
    frame = ("0" + "00" + "1" + format(fr["dcu"], "01b") + format(fr["sc"], "01b") +
             fr["fimv"] + "0" + format(fr["rd"], "01b") + fr["render"] + fr["ibc"] +
             ("" if fr["dcu"] else "1") + fr["bits"][fr["tile_info"]:fr["end"]])
    return _with_headers(item, full, frame)


def av1_header_edit(item: bytes, segmentation: bool = False) -> bytes:
    """A cv2-written lossless item's frame header edited: segmentation on
    with every feature off (each segment lossless). The tile data is not
    coded anew, so the header is all such a file holds of the tool: a test
    of the refusal, which cv2 refuses too."""
    obus = av1_obus(item)
    seq = _seq_fields(next(body for t, _, body in obus if t == 1))
    fr = _frame_fields(next(body for t, _, body in obus if t == 6), seq)
    bits = fr["bits"][:fr["end"]]
    if segmentation:
        p = fr["segmentation"]
        bits = bits[:p] + "1" + "0" * 64 + bits[p + 1:]
    return _with_headers(item, None, bits)


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def av1_seq_info(seq: bytes) -> dict:
    """The fields of a reduced still picture sequence header (as libaom
    writes it for libavif) that a key frame's header and tiles depend on."""
    r = _Bits(seq)
    f = {"profile": r.f(3), "still": r.f(1), "reduced": r.f(1)}
    assert f["reduced"] == 1
    r.f(5)  # seq_level_idx
    wb, hb = r.f(4) + 1, r.f(4) + 1
    f["width"], f["height"] = r.f(wb) + 1, r.f(hb) + 1
    f["sb128"], f["filter_intra"], f["edge_filter"] = r.f(1), r.f(1), r.f(1)
    f["superres"], f["cdef"], f["restoration"] = r.f(1), r.f(1), r.f(1)
    hbd = r.f(1)
    profile = f["profile"]
    f["depth"] = (12 if r.f(1) else 10) if profile == 2 and hbd else (
        10 if hbd else 8)
    f["mono"] = r.f(1) if profile != 1 else 0
    f["primaries"] = f["transfer"] = f["matrix"] = 2
    if r.f(1):
        f["primaries"], f["transfer"], f["matrix"] = r.f(8), r.f(8), r.f(8)
    f["ssx"] = f["ssy"] = 1
    f["separate"] = 0
    if f["mono"]:
        f["full_range"] = r.f(1)
    elif (f["primaries"], f["transfer"], f["matrix"]) == (1, 13, 0):
        f["full_range"], f["ssx"], f["ssy"] = 1, 0, 0
    else:
        f["full_range"] = r.f(1)
        if profile == 1:
            f["ssx"] = f["ssy"] = 0
        elif profile == 2:
            f["ssx"], f["ssy"] = 1, 0
            if f["depth"] == 12:
                f["ssx"] = r.f(1)
                f["ssy"] = r.f(1) if f["ssx"] else 0
        if f["ssx"] and f["ssy"]:
            r.f(2)  # chroma_sample_position
    if not f["mono"]:
        f["separate"] = r.f(1)
    f["film_grain"] = r.f(1)
    return f


def av1_frame_info(item: bytes) -> dict:
    """The tile layout of a key frame written under a reduced still picture
    sequence header, in one frame OBU: its uncompressed header parsed to
    tile_info (uniform, the log2 sizes, TileCols and TileRows, MiColStarts
    and MiRowStarts with the frame's end last, context_update_tile_id and
    TileSizeBytes), base_q_idx, whether it is lossless and the header's
    end, then its tile group
    (tile_start_and_end_present_flag and each tile's size in bytes), and
    the bit where delta_lf_present is read (None where it is not)."""
    obus = av1_obus(item)
    seq = av1_seq_info(next(b for t, _, b in obus if t == 1))
    frame = next(b for t, _, b in obus if t == 6)
    r = _Bits(frame)
    out = {"seq": seq}
    r.f(1)  # disable_cdf_update
    sc = r.f(1)
    if sc:
        r.f(1)  # force_integer_mv
    if seq["superres"]:
        assert r.f(1) == 0
    if r.f(1):  # render_and_frame_size_different
        r.f(32)
    ibc = r.f(1) if sc else 0
    sh = 5 if seq["sb128"] else 4
    mi_cols = 2 * ((seq["width"] + 7) >> 3)
    mi_rows = 2 * ((seq["height"] + 7) >> 3)
    sb_cols = (mi_cols + (1 << sh) - 1) >> sh
    sb_rows = (mi_rows + (1 << sh) - 1) >> sh
    max_w = 4096 >> (sh + 2)
    area = (4096 * 2304) >> (2 * (sh + 2))
    min_cols = _tile_log2(max_w, sb_cols)
    max_cols = _tile_log2(1, min(sb_cols, 64))
    max_rows = _tile_log2(1, min(sb_rows, 64))
    min_tiles = max(min_cols, _tile_log2(area, sb_rows * sb_cols))
    out["uniform"] = r.f(1)
    if out["uniform"]:
        cl = min_cols
        while cl < max_cols and r.f(1):
            cl += 1
        w = (sb_cols + (1 << cl) - 1) >> cl
        cols = [s << sh for s in range(0, sb_cols, w)]
        rl = max(min_tiles - cl, 0)
        while rl < max_rows and r.f(1):
            rl += 1
        h = (sb_rows + (1 << rl) - 1) >> rl
        rows = [s << sh for s in range(0, sb_rows, h)]
    else:
        def ns(n):
            w = n.bit_length()
            m = (1 << w) - n
            v = r.f(w - 1)
            return v if v < m else (v << 1) - m + r.f(1)
        cols, start, widest = [], 0, 0
        while start < sb_cols:
            cols.append(start << sh)
            size = ns(min(sb_cols - start, max_w)) + 1
            widest, start = max(widest, size), start + size
        area = (sb_rows * sb_cols) >> (min_tiles + 1) if min_tiles else \
            sb_rows * sb_cols
        rows, start = [], 0
        while start < sb_rows:
            rows.append(start << sh)
            start += ns(min(sb_rows - start, max(area // widest, 1))) + 1
        cl, rl = _tile_log2(1, len(cols)), _tile_log2(1, len(rows))
    out.update(cols_log2=cl, rows_log2=rl, tile_cols=len(cols),
               tile_rows=len(rows), mi_col_starts=cols + [mi_cols],
               mi_row_starts=rows + [mi_rows], context_update_tile_id=0,
               tile_size_bytes=4)
    if cl or rl:
        out["context_update_tile_id"] = r.f(cl + rl)
        out["tile_size_bytes"] = r.f(2) + 1
    out["base_q_idx"] = q = r.f(8)
    dq = [r.su(7) if r.f(1) else 0]
    if not seq["mono"]:
        diff = r.f(1) if seq["separate"] else 0
        dq += [r.su(7) if r.f(1) else 0 for _ in range(2)]
        dq += [r.su(7) if r.f(1) else 0 for _ in range(2)] if diff else dq[1:]
    if r.f(1):  # using_qmatrix
        r.f(8 + (4 if seq["separate"] else 0))
    assert r.f(1) == 0  # segmentation_enabled
    out["delta_lf_at"] = None
    if q > 0 and r.f(1):  # delta_q_present
        r.f(2)
        if not ibc:
            out["delta_lf_at"] = r.p
            if r.f(1):  # delta_lf_present
                r.f(3)
    out["lossless"] = lossless = q == 0 and not any(dq)
    planes = 1 if seq["mono"] else 3
    if not lossless and not ibc:
        lf = [r.f(6), r.f(6)]
        if planes > 1 and any(lf):
            r.f(12)
        r.f(3)  # sharpness
        if r.f(1) and r.f(1):  # loop_filter_delta_enabled, _update
            for _ in range(10):
                if r.f(1):
                    r.f(7)
        if seq["cdef"]:
            r.f(2)
            r.f((1 << r.f(2)) * (6 if planes == 1 else 12))
        if seq["restoration"]:
            types = [r.f(2) for _ in range(planes)]
            if any(types):
                if seq["sb128"]:
                    r.f(1)
                elif r.f(1):
                    r.f(1)
                if seq["ssx"] and seq["ssy"] and any(types[1:]):
                    r.f(1)
        r.f(1)  # tx_mode_select
    r.f(1)  # reduced_tx_set
    assert not seq["film_grain"]
    out["header_end"] = r.p
    # the tile group
    p = (r.p + 7) // 8
    n_tiles = out["tile_cols"] * out["tile_rows"]
    out["start_and_end_present"] = 0
    if n_tiles > 1:
        out["start_and_end_present"] = frame[p] >> 7
        assert not out["start_and_end_present"]
        p += 1
    sizes = []
    for t in range(n_tiles):
        if t == n_tiles - 1:
            sizes.append(len(frame) - p)
        else:
            k = out["tile_size_bytes"]
            size = int.from_bytes(frame[p:p + k], "little") + 1
            sizes.append(size)
            p += k + size
    out["tile_sizes"] = sizes
    return out


def avif_grid(tiles, rows: int, cols: int, height: int, width: int) -> bytes:
    """A grid derived image (ImageGrid, 16-bit output size) of cv2-written
    lossless items of one size, row by row, cropped to height x width."""
    parts = [avif_items(t) for t in tiles]
    items, refs = {}, []
    for k, part in enumerate(parts):
        it = dict(part["items"][part["primary"]])
        items[k + 2] = it
    spe = next(pb for pb in items[2]["props"] if pb[4:8] == b"ispe")
    grid = bytes([0, 0, rows - 1, cols - 1]) + struct.pack(">HH", width, height)
    ispe = _full(b"ispe", 0, 0, struct.pack(">II", width, height))
    items[1] = {"type": b"grid", "data": grid, "props": [ispe],
                "essential": [False]}
    del spe
    refs.append((b"dimg", 1, [k + 2 for k in range(len(parts))]))
    return write_avif(items, 1, refs, parts[0]["ftyp"])


def _avif_picture(h: int, w: int, seed: int, noise: float = 6) -> np.ndarray:
    """A smooth seeded BGR picture (sines of gradients) with Gaussian noise:
    every intra predictor finds work in it."""
    rs = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    img = np.stack([(xs * 3 + ys) % 256, (ys * 2 + 40) % 256,
                    ((xs + ys) * 5) % 256], -1).astype(float)
    img = 128 + 100 * np.sin(img / 40.0) + rs.normal(0, noise, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _avif_screen(h: int, w: int, seed: int) -> np.ndarray:
    """Screen content: flat boxes of six colours and two lines of text."""
    import cv2
    rs = np.random.RandomState(seed)
    img = np.full((h, w, 3), 240, np.uint8)
    cols = rs.randint(0, 256, (6, 3))
    for k in range(12):
        y0, x0 = rs.randint(0, h), rs.randint(0, w)
        img[y0:y0 + rs.randint(4, 30), x0:x0 + rs.randint(4, 60)] = cols[k % 6]
    for dy in (0, 20):
        cv2.putText(img, "AVIF 1234 abc", (2, h // 2 + dy),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (20, 20, 20), 1)
    return img


def _avif_repeats(h: int, w: int, seed: int) -> np.ndarray:
    """Four colours in 2 x 2 cells repeating every 20 pixels: libaom turns
    on intra block copy for it."""
    rs = np.random.RandomState(seed)
    cols = rs.randint(0, 256, (4, 3)).astype(np.uint8)
    idx = rs.randint(0, 4, (10, 10))
    idx = np.tile(idx, (h // 20 + 1, w // 20 + 1))[:(h + 1) // 2, :(w + 1) // 2]
    return np.ascontiguousarray(cols[idx].repeat(2, 0).repeat(2, 1)[:h, :w])


def _avif_mixed(seed: int) -> np.ndarray:
    """256x256: blurred noise over screen content (boxes and text); libaom
    turns on intra block copy in a lossy frame for it (speeds 0-6)."""
    import cv2
    rs = np.random.RandomState(seed)
    top = cv2.GaussianBlur(rs.randint(0, 256, (128, 256, 3)).astype(np.uint8),
                           (0, 0), 2)
    return np.concatenate([top, _avif_screen(128, 256, 3)], 0)


def _avif_edit(data: bytes, props_add=(), props_drop=(), av1=None, **kw):
    """A cv2-written AVIF rewritten: properties added to (or dropped from)
    the primary item, its AV1 data replaced, the container written by
    write_avif with its options."""
    a = avif_items(data)
    items = {k: dict(v) for k, v in a["items"].items()}
    it = items[a["primary"]]
    keep = [(pb, e) for pb, e in zip(it["props"], it["essential"])
            if pb[4:8] not in props_drop]
    keep += [(pb, True) for pb in props_add]
    it["props"], it["essential"] = [k[0] for k in keep], [k[1] for k in keep]
    if av1 is not None:
        it["data"] = av1(it["data"])
    return write_avif(items, a["primary"], a["refs"], a["ftyp"], **kw)


def _add_avif(add):
    """The AVIF fixtures (cv2.imwrite at quality 100: lossless AV1): each
    variant names the coding tools or container feature it reaches."""
    pic = _avif_picture
    add("avif_rgb8.avif", avif_cv2(pic(48, 64, 1)), "AVIF",
        "8-bit RGB, speed 6 (cv2's default): DC, smooth, directional with "
        "the edge filter and upsampling, split partitions at the edges")
    add("avif_speed0.avif", avif_cv2(pic(64, 96, 0), speed=0), "AVIF",
        "speed 0: 128x128 superblocks, HORZ_A / HORZ_4 / VERT_4, CfL, "
        "filter intra, Paeth, smooth V and H, angle deltas")
    add("avif_speed1.avif", avif_cv2(pic(72, 112, 16, 4), speed=1), "AVIF",
        "speed 1: VERT_A and HORZ_B partitions")
    add("avif_speed9.avif", avif_cv2(pic(64, 96, 9), speed=9), "AVIF",
        "speed 9: the fewest tools")
    add("avif_rgb10.avif", avif_cv2(pic(48, 64, 5).astype(np.uint16) * 4 + 1,
                                    depth=10), "AVIF",
        "10-bit RGB (profile 1), scaled to 8 bits as libavif scales it")
    add("avif_rgb12.avif", avif_cv2(pic(48, 64, 6).astype(np.uint16) * 16 + 7,
                                    depth=12), "AVIF",
        "12-bit RGB (profile 2, 4:4:4)")
    add("avif_mono8.avif", avif_cv2(pic(48, 64, 7)[..., 0].copy()), "AVIF",
        "8-bit monochrome")
    add("avif_mono10.avif", avif_cv2(pic(48, 64, 8)[..., 1].astype(np.uint16) * 4 + 3,
                                     depth=10), "AVIF",
        "10-bit monochrome, rounded to even as cv2 scales gray")
    add("avif_mono12.avif", avif_cv2(pic(48, 64, 8)[..., 0].astype(np.uint16) * 16 + 3,
                                     depth=12), "AVIF",
        "12-bit monochrome")
    add("avif_screen.avif", avif_cv2(_avif_screen(96, 160, 1), speed=0), "AVIF",
        "screen content: palette of y and uv, the colour cache, delta-coded "
        "v colours")
    add("avif_intrabc.avif", avif_cv2(_avif_repeats(256, 256, 5), speed=4),
        "AVIF", "repeated cells: intra block copy (vector stack and the "
        "default vector), skip, palette")
    add("avif_1x40.avif", avif_cv2(pic(1, 40, 3)), "AVIF", "1x40: one row")
    add("avif_40x1.avif", avif_cv2(pic(40, 1, 3)), "AVIF", "40x1: one column")
    add("avif_23x37.avif", avif_cv2(pic(23, 37, 4)), "AVIF",
        "23x37: split_or_horz and split_or_vert at both edges")
    add("avif_130x150.avif", avif_cv2(pic(130, 150, 3)), "AVIF",
        "130x150: above 128x128, three superblocks across")
    bgra = np.dstack([pic(48, 64, 1), (np.arange(48 * 64).reshape(48, 64) % 251)
                      .astype(np.uint8)])
    alpha = avif_cv2(bgra)
    add("avif_alpha.avif", alpha, "AVIF",
        "an alpha item (auxl, auxC), dropped as IMREAD_COLOR drops it")
    base = avif_cv2(pic(48, 64, 2))
    add("avif_iloc1_idat.avif", _avif_edit(base, iloc_version=1,
                                           in_idat=(1,), field_size=8,
                                           base_size=4),
        "AVIF", "iloc version 1, the data in idat, 8-byte offsets and "
        "lengths, a base offset")
    add("avif_iloc2.avif", _avif_edit(base, iloc_version=2, split_extents=(1,),
                                      pitm_version=1, ipma_large=True,
                                      big_mdat=True),
        "AVIF", "iloc version 2, two extents, pitm version 1, 15-bit ipma "
        "indices, a 64-bit mdat size")
    add("avif_transforms.avif", _avif_edit(base, props_add=(
        _box(b"irot", b"\x01"), _box(b"imir", b"\x01"),
        _box(b"clap", struct.pack(">8I", 40, 1, 30, 1, 0, 1, 0, 1)))),
        "AVIF", "irot, imir and clap, which cv2 leaves unapplied")
    icc = struct.pack(">I", 132) + b"lcms" + bytes(124)
    add("avif_icc.avif", _avif_edit(base, props_drop=(b"colr",),
                                    props_add=(_box(b"colr", b"prof" + icc),)),
        "AVIF", "an ICC colr property instead of nclx: the sequence "
        "header's identity matrix")
    add("avif_full_header.avif", _avif_edit(avif_cv2(_avif_screen(96, 160, 2),
                                                     speed=0),
                                            av1=av1_full_headers),
        "AVIF", "a full sequence header (timing info, an operating point "
        "with its initial display delay) and the frame header of a shown "
        "key frame")
    add("avif_grid.avif", avif_grid([avif_cv2(pic(64, 64, k)) for k in range(4)],
                                    2, 2, 120, 100), "AVIF",
        "a 2x2 grid of 64x64 lossless items, cropped to 120x100")
    add("avif_grid_small.avif", avif_grid([avif_cv2(pic(32, 48, k))
                                           for k in range(4)], 2, 2, 60, 90),
        "AVIF", "a grid of tiles under 64x64, which libavif refuses",
        "refused")
    add("avif_480x640.avif", avif_cv2(np.ascontiguousarray(
        picture(480, 640, 7, noise=2)[..., ::-1])), "AVIF",
        "480x640 RGB, speed 6: the picture phase 7a times and the trainer "
        "reads")
    _add_avif_lossy(add)
    _add_avif_tiles(add)
    _add_avif_layouts(add)


def _add_avif_lossy(add):
    """The lossy AVIF fixtures (cv2.imwrite below quality 100: 4:2:0 BT.601
    full range, or monochrome): each variant names the tools it reaches."""
    pic = _avif_picture
    big = np.ascontiguousarray(picture(480, 640, 7, noise=2)[..., ::-1])
    add("avif_lossy_480x640.avif", avif_cv2(big, quality=95), "AVIF",
        "480x640, cv2's defaults (quality 95, speed 9): quantizer matrices, "
        "delta q, TX_MODE_SELECT, deblocking, CDEF; the picture phase 7a "
        "times and the trainer reads")
    for h, w in ((1, 40), (40, 1), (23, 37), (53, 37)):
        add(f"avif_lossy_{h}x{w}.avif", avif_cv2(pic(h, w, 4), quality=95),
            "AVIF", f"{h}x{w} at quality 95: odd chroma sizes, frame edges")
    for q in (0, 30, 60, 99):
        add(f"avif_lossy_q{q}.avif", avif_cv2(pic(64, 96, 11), quality=q),
            "AVIF", f"quality {q}")
    add("avif_lossy_speed0.avif", avif_cv2(np.ascontiguousarray(big[:256, :256]),
                                           quality=95, speed=0), "AVIF",
        "speed 0: loop restoration, switchable (Wiener and self-guided "
        "units)")
    for sp in (4, 5, 8, 10):
        add(f"avif_lossy_speed{sp}.avif", avif_cv2(pic(96, 128, 3), quality=60,
                                                   speed=sp), "AVIF",
            f"speed {sp} at quality 60" + (": self-guided restoration"
                                            if sp == 4 else ""))
    add("avif_lossy_10bit.avif", avif_cv2(pic(48, 64, 5).astype(np.uint16) * 4,
                                          quality=60, depth=10), "AVIF",
        "10-bit (quality 60): cut to 8 bits before libyuv's conversion")
    add("avif_lossy_12bit.avif", avif_cv2(pic(48, 64, 6).astype(np.uint16) * 16 + 5,
                                          quality=60, depth=12), "AVIF",
        "12-bit (profile 2, 4:2:0, quality 60)")
    add("avif_lossy_mono.avif", avif_cv2(pic(48, 64, 7)[..., 0].copy(), quality=80),
        "AVIF", "monochrome (quality 80)")
    add("avif_lossy_mono10.avif", avif_cv2(pic(48, 64, 8)[..., 1].astype(np.uint16) * 4 + 3,
                                           quality=80, depth=10), "AVIF",
        "10-bit monochrome (quality 80), rounded to even as cv2 scales gray")
    add("avif_lossy_screen.avif", avif_cv2(_avif_screen(96, 160, 1), quality=90,
                                           speed=2), "AVIF",
        "screen content (quality 90, speed 2): palette at 4:2:0 (the chroma "
        "map of a 16x4 block), identity and one-dimensional transforms")
    add("avif_lossy_intrabc.avif", avif_cv2(_avif_mixed(5), quality=30, speed=4),
        "AVIF", "photo over screen content (quality 30, speed 4): intra block "
        "copy in a lossy frame (its transform trees and inter transform "
        "types, half-sample chroma), the in-loop filters off")


def avif_pil(img: np.ndarray, **kw) -> bytes:
    """Pillow's AVIF (its libavif over libaom) of a BGR picture, with the
    plugin's options (subsampling, quality, speed, range, tile_rows and
    tile_cols as log2, autotiling, advanced: libaom's own)."""
    import io
    from PIL import Image
    b = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img[..., ::-1])).save(b, "AVIF", **kw)
    return b.getvalue()


def avif_banner(h: int, w: int, seed: int) -> np.ndarray:
    """A wide BGR picture of flat seeded boxes on a flat ground: its
    decoded pixels stay small as PNG."""
    rs = np.random.RandomState(seed)
    img = np.zeros((h, w, 3), np.uint8)
    img[:] = (200, 180, 150)
    for _ in range(40):
        y0, x0 = rs.randint(0, h), rs.randint(0, w)
        img[y0:y0 + rs.randint(20, 160), x0:x0 + rs.randint(40, 600)] = \
            rs.randint(0, 256, 3)
    return img


def avif_colr(data: bytes, matrix: int = None, full: int = None,
              primaries: int = None) -> bytes:
    """An AVIF with its primary item's nclx colr box edited: the matrix,
    the range flag or the primaries (the samples stay as coded)."""
    a = avif_items(data)
    items = {k: dict(v) for k, v in a["items"].items()}
    it = items[a["primary"]]
    props = []
    for pb in it["props"]:
        if pb[4:8] == b"colr" and pb[8:12] == b"nclx":
            b = bytearray(pb)
            if primaries is not None:
                b[12:14] = primaries.to_bytes(2, "big")
            if matrix is not None:
                b[16:18] = matrix.to_bytes(2, "big")
            if full is not None:
                b[18] = (b[18] & 0x7F) | (0x80 if full else 0)
            pb = bytes(b)
        props.append(pb)
    it["props"] = props
    return write_avif(items, a["primary"], a["refs"], a["ftyp"])


def _add_avif_tiles(add):
    """AVIF of several tiles: Pillow's forced 2x2 and cv2.imwrite's files
    wider than 4096 (2x1 at its defaults)."""
    add("avif_tiles_2x2.avif", avif_pil(_avif_picture(240, 320, 31),
                                        tile_rows=1, tile_cols=1), "AVIF",
        "240x320, Pillow's 2x2 tiles (tile_rows and tile_cols 1)")
    for h, w, seed in ((300, 4200, 5), (256, 4104, 6)):
        ok, buf = __import__("cv2").imencode(".avif", avif_banner(h, w, seed))
        assert ok
        add(f"avif_tiles_{h}x{w}.avif", buf.tobytes(), "AVIF",
            f"{h}x{w} at cv2's defaults: 2x1 tiles (over 64 superblocks "
            "across)")


def _add_avif_layouts(add):
    """Pillow's AVIF of the chroma layouts cv2 never writes (lossy 4:4:4
    and 4:2:2, lossless 4:2:0 and 4:2:2, all BT.601) and colour
    descriptions other writers give (limited range; BT.709, BT.2020 NCL,
    unspecified and chromaticity-derived matrices: colr edits of a lossy
    file)."""
    pic, scr = _avif_picture, _avif_screen
    for sub, tag in (("4:4:4", "444"), ("4:2:2", "422")):
        add(f"avif_layout_{tag}.avif", avif_pil(pic(96, 136, 32), subsampling=sub,
                                                speed=0), "AVIF",
            f"lossy {sub}, speed 0: CfL, filter intra, loop restoration")
        add(f"avif_layout_{tag}_23x37.avif", avif_pil(pic(23, 37, 33),
                                                      subsampling=sub), "AVIF",
            f"lossy {sub}, 23x37: odd chroma sizes, frame edges")
        add(f"avif_layout_{tag}_screen.avif", avif_pil(
            scr(96, 160, 34), subsampling=sub, speed=2, quality=90), "AVIF",
            f"screen content at {sub}: the chroma palette")
        add(f"avif_layout_{tag}_cdef.avif", avif_pil(
            pic(96, 136, 35), subsampling=sub, speed=4, quality=40,
            advanced={"enable-cdef": "1"}), "AVIF",
            f"lossy {sub} with CDEF (libaom's enable-cdef): Cdef_Uv_Dir")
    add("avif_layout_422_intrabc.avif", avif_pil(
        _avif_mixed(5), subsampling="4:2:2", quality=30, speed=4), "AVIF",
        "intra block copy at 4:2:2 (half-sample chroma across)")
    for sub, tag in (("4:2:0", "420"), ("4:2:2", "422")):
        add(f"avif_layout_lossless_{tag}.avif", avif_pil(
            pic(64, 96, 36), quality=100, subsampling=sub), "AVIF",
            f"lossless {sub} (Pillow's quality 100), BT.601")
        add(f"avif_layout_lossless_{tag}_23x37.avif", avif_pil(
            pic(23, 37, 37), quality=100, subsampling=sub), "AVIF",
            f"lossless {sub}, 23x37")
    add("avif_layout_lossless_420_screen.avif", avif_pil(
        scr(96, 160, 38), quality=100, speed=0), "AVIF",
        "lossless 4:2:0 screen content: palette, CfL of 4x4 chroma")
    base = pic(64, 96, 39)
    add("avif_colr_limited.avif", avif_pil(base, range="limited"), "AVIF",
        "limited range, BT.601 (Pillow's range='limited')")
    lossy = avif_pil(base)
    for name, m, full, prim, what in (
            ("bt709", 1, 1, None, "BT.709"),
            ("bt709_limited", 1, 0, None, "BT.709, limited range"),
            ("bt2020", 9, 1, None, "BT.2020 NCL"),
            ("bt2020_limited", 9, 0, None, "BT.2020 NCL, limited range"),
            ("unspecified", 2, 1, None, "matrix 2 (unspecified: BT.601)"),
            ("cdncl", 12, 1, 9, "chromaticity-derived NCL of BT.2020 "
                                "primaries")):
        add(f"avif_colr_{name}.avif", avif_colr(lossy, m, full, prim), "AVIF",
            f"colr nclx {what} over BT.601 samples")


def write_fixtures(directory: str, prefixes=None) -> dict:
    """Writes every fixture (or those whose names start with one of
    `prefixes`), and for each one cv2 decodes its pixels as
    `<stem>.ref.png`, and their entries of formats.json (the entries of
    the other writers, such as the JPEG 2000 fixtures of
    test_torch_jpeg2000.py, kept); returns formats.json's content."""
    import json
    import os
    import cv2
    index = {}
    if os.path.exists(os.path.join(directory, "formats.json")):
        with open(os.path.join(directory, "formats.json")) as f:
            index = json.load(f)
    for name, (data, fmt, variant, expect) in fixture_files().items():
        if prefixes and not name.startswith(tuple(prefixes)):
            continue
        path = os.path.join(directory, name)
        with open(path, "wb") as f:
            f.write(data)
        ref = cv2.imread(path, cv2.IMREAD_COLOR)
        stem = name.rsplit(".", 1)[0]
        if expect == "pixels":
            assert ref is not None, name
            cv2.imwrite(os.path.join(directory, stem + ".ref.png"), ref)
        elif expect == "refused":
            assert ref is None, name
        route = {"BMP": "bmp", "PNM": "pnm", "TIFF": "tiff", "WebP": "webp",
                 "JPEG": "jpeg_lossless", "GIF": "gif", "PAM": "pam",
                 "Sun raster": "sun_raster", "PFM": "pfm",
                 "Radiance HDR": "hdr",
                 "JPEG 2000 (JP2)": "jpeg2000", "AVIF": "avif"}.get(fmt)
        index[name] = {"format": fmt, "variant": variant, "expect": expect,
                       "route": route if expect == "pixels" else None}
    with open(os.path.join(directory, "formats.json"), "w") as f:
        json.dump(index, f, indent=1, sort_keys=True)
    return index


if __name__ == "__main__":
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    import sys
    write_fixtures(os.path.join(here, "..", "semi_detr_tpu_torch", "native",
                                "fixtures"), sys.argv[1:] or None)


# ------------------------------------------------------ test references

def cv2_rgb(data: bytes, tmp_dir: str, name: str = "probe"):
    """cv2.imread(path, IMREAD_COLOR) of the bytes written to a file (the
    JAX loader's fallback reads a path; imdecode differs for a TIFF turned
    by orientation 5-8), BGR turned to RGB; None where cv2 refuses."""
    import os
    import cv2
    path = os.path.join(tmp_dir, name)
    with open(path, "wb") as f:
        f.write(data)
    try:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
    except cv2.error:  # a header it cannot size a picture from
        return None
    return None if img is None else np.ascontiguousarray(img[..., ::-1])


def load_jax_native(module=None):
    """The JAX package's `native` module (or `module`, a copy of it) with
    its host library loaded in this process, so that no reference the tests
    take from it is a None of a library that failed to load.

    The JAX package builds `libsdt_dataloader.so` at first use straight
    into its own directory, with no lock between processes: a pytest worker
    that loads it while another one's g++ is still writing it fails, and
    the module caches that failure for the life of the process (every
    decode then returns None). Here every process loads it under one file
    lock in the temp dir, keyed by the library's path; a missing or stale
    library is built under a temporary name and renamed into place, and a
    load that fails is retried on a fresh build. Raises RuntimeError,
    saying why, when it still does not load."""
    import fcntl
    import hashlib
    import os
    import subprocess
    import tempfile
    if module is None:
        from semi_detr_tpu import native as module
    if module._lib:
        return module
    so, src = module._SO, module._SRC
    key = hashlib.sha256(os.path.abspath(so).encode()).hexdigest()[:16]
    lock = os.path.join(tempfile.gettempdir(), f"sdt_jax_native_{key}.lock")
    why = []
    with open(lock, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        for attempt in range(3):
            stale = not os.path.exists(so) or (
                os.path.getmtime(so) < os.path.getmtime(src))
            if attempt or stale:
                fd, tmp = tempfile.mkstemp(suffix=".so",
                                           dir=os.path.dirname(so))
                os.close(fd)
                cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src,
                       "-o", tmp, "-ljpeg", "-lpng", "-lpthread"]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode:
                    os.unlink(tmp)
                    why.append("g++: " + proc.stderr[-2000:])
                    continue
                os.replace(tmp, so)
            module._lib = None
            if module._load():
                return module
            why.append(f"ctypes could not load {so}")
    raise RuntimeError("the JAX package's host library does not load: "
                       + "; ".join(why))


class _JaxNative:
    """`semi_detr_tpu.native` through load_jax_native: every attribute is
    the module's, taken after its library has loaded."""

    def __getattr__(self, name):
        return getattr(load_jax_native(), name)


jax_native = _JaxNative()


def _jax_native_loaded():
    load_jax_native()


def jax_native_fixture():
    """A module-scoped autouse fixture that loads the JAX package's host
    library (load_jax_native) before a test file's first test: a test file
    that reaches it through the JAX loaders binds it as a module global."""
    import pytest
    return pytest.fixture(scope="module", autouse=True)(_jax_native_loaded)


def jax_load_images(directory: str, names):
    """The JAX package's loader (`CocoDataset.load_image`: its native
    decoder, else cv2.imread) on files of one directory: {name: (H, W, 3)
    RGB, or the exception it raised}."""
    from semi_detr_tpu.data.coco import CocoDataset
    load_jax_native()
    ann = {"images": [{"id": i + 1, "file_name": n, "width": 1, "height": 1}
                      for i, n in enumerate(names)],
           "annotations": [], "categories": [{"id": 1, "name": "person"}]}
    ds = CocoDataset(ann, directory, classes=("person",),
                     filter_empty_gt=False, test_mode=True)
    out = {}
    for i, n in enumerate(names):
        try:
            out[n] = ds.load_image(i)
        except Exception as err:  # noqa: BLE001 - the loader's own error
            out[n] = err
    return out


def committed(prefixes):
    """The committed fixtures whose names start with one of `prefixes`:
    {name: their formats.json entry}."""
    import json
    import os
    from semi_detr_tpu_torch import native
    with open(os.path.join(native.FIXTURES, "formats.json")) as f:
        index = json.load(f)
    return {n: e for n, e in sorted(index.items()) if n.startswith(prefixes)}
