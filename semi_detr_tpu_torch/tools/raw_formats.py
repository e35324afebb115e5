"""Files of formats the JAX loader hands to cv2, written without cv2 or
Pillow.

`raw_format_files`: the uncompressed formats (Sun raster, PAM, PFM),
written from an RGB picture so that `cv2.imread(path, IMREAD_COLOR)` reads
them back to that picture exactly: `chip_smoke.py` phase 7a times the host
decoders on them at 480x640 without committing files of their raw size,
and holds each decode to the picture it was written from (a committed cv2
reference). `tests/test_torch_raster_pam.py` holds each to cv2.imread on
the CPU.

* Sun raster, standard type, 24 bits: B, G, R per pixel, rows padded to
  16 bits.
* PAM, TUPLTYPE RGB, maxval 255: cv2 copies the samples into its BGR
  picture unswapped, so they are written B, G, R for the picture to read
  back as R, G, B.
* PFM, little-endian (scale -1): the picture's values as float32, rows
  bottom-up; cv2 rounds them back to the same bytes.

`j2k_codestream`, `jp2_file`, `jpeg2000_files`, `jpeg2000_ht_files`: JPEG
2000 streams of the kinds Pillow's encoder cannot make, high-throughput
ones among them (the section "JPEG 2000" below).
"""
from __future__ import annotations

import functools
import os
import struct
from typing import Dict, Tuple

import numpy as np


def raw_format_files(rgb: np.ndarray) -> Dict[str, Tuple[bytes, str, str]]:
    """{file name: (bytes, format, variant)} of the picture (h, w, 3)
    uint8, each read by cv2 to exactly `rgb`."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    bgr = rgb[..., ::-1]
    rows = bgr.reshape(h, 3 * w)
    if (3 * w) % 2:
        rows = np.concatenate([rows, np.zeros((h, 1), np.uint8)], 1)
    ras = struct.pack(">8I", 0x59A66A95, w, h, 24, rows.size, 1, 0, 0) + \
        rows.tobytes()
    pam = (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH 3\nMAXVAL 255\n"
           f"TUPLTYPE RGB\nENDHDR\n").encode() + bgr.tobytes()
    pfm = f"PF\n{w} {h}\n-1.0\n".encode() + \
        rgb[::-1].astype("<f4").tobytes()
    return {f"ras_{h}x{w}.ras": (ras, "Sun raster", f"24-bit at {h}x{w}"),
            f"pam_{h}x{w}.pam": (pam, "PAM", f"RGB at {h}x{w}"),
            f"pfm_{h}x{w}.pfm": (pfm, "PFM", f"float RGB at {h}x{w}")}


# ------------------------------------------------------------ JPEG 2000
#
# A JPEG 2000 writer for the streams Pillow's OpenJPEG encoder cannot make:
# code-block styles other than the default, POC, PPM / PPT, SOP / EPH,
# RGN, tile-parts of several tiles interleaved, COC / QCC, palettes, channel
# definitions, colour specifications, precisions other than 8 and 16, sub-
# sampled and signed components, image offsets, and high-throughput code-
# blocks (Part 15), which no encoder on these machines writes. The 5/3
# wavelet and the RCT (the 9/7 and the ICT only as a decoder reads the 5/3
# coefficients sent as quantised ones); every code-block coded by the MQ
# coder of ISO/IEC 15444-1 Annex C and the passes of Annex D, or by the HT
# block coder below, every packet as Annex B sends it.
# `tests/test_torch_jpeg2000.py` and `tests/test_torch_jpeg2000_ht.py`
# regenerate the committed fixtures (`native/fixtures/j2kw_*`, `j2kh_*`)
# from it byte for byte, and hold the host library's decode of them to
# cv2.imread (OpenJPEG).

# the MQ coder's states (Table C.2): Qe, next MPS, next LPS, switch
_MQ = ((0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
       (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
       (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
       (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
       (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
       (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
       (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
       (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
       (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
       (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
       (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
       (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
       (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
       (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
       (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
       (0x0001, 45, 43, 0), (0x5601, 46, 46, 0))
_UNI, _AGG, _SC, _MAG = 18, 17, 9, 14
# code-block styles (COD / COC SPcod)
BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32


class _MqEncoder:
    """The MQ encoder (C.2) of one terminated segment."""

    def __init__(self, states, mps):
        self.st, self.mps = states, mps
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.out = bytearray([0])  # a dummy byte before the segment

    def encode(self, d, cx):
        qe, nmps, nlps, sw = _MQ[self.st[cx]]
        self.a -= qe
        if d == self.mps[cx]:
            if self.a & 0x8000:
                self.c += qe
                return
            if self.a < qe:
                self.a = qe
            else:
                self.c += qe
            self.st[cx] = nmps
        else:
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if sw:
                self.mps[cx] = 1 - self.mps[cx]
            self.st[cx] = nlps
        while True:
            self.a = (self.a << 1) & 0xFFFF
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def _byteout(self):
        if self.out[-1] == 0xFF:
            self.out.append((self.c >> 20) & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        elif self.c < 0x8000000:
            self.out.append((self.c >> 19) & 0xFF)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            self.out[-1] += 1
            if self.out[-1] == 0xFF:
                self.c &= 0x7FFFFFF
                self.out.append((self.c >> 20) & 0xFF)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                self.out.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8

    def flush(self) -> bytes:
        temp = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= temp:
            self.c -= 0x8000
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        data = self.out[1:]
        if data and data[-1] == 0xFF:  # a segment never ends with 0xFF
            data = data[:-1]
        return bytes(data)


class _RawEncoder:
    """The raw bits of a BYPASS segment, a 0 stuffed after each 0xFF."""

    def __init__(self):
        self.out, self.c, self.ct = bytearray(), 0, 8

    def encode(self, d, cx=None):
        self.ct -= 1
        self.c |= d << self.ct
        if self.ct == 0:
            self.out.append(self.c)
            self.ct = 7 if self.c == 0xFF else 8
            self.c = 0

    def flush(self) -> bytes:
        full = 7 if self.out and self.out[-1] == 0xFF else 8
        if self.ct < full:  # the last byte, filled with 0, 1, 0, ...
            bit = 0
            while self.ct > 0:
                self.ct -= 1
                self.c |= bit << self.ct
                bit ^= 1
            self.out.append(self.c)
        if self.out and self.out[-1] == 0xFF:
            self.out = self.out[:-1]
        return bytes(self.out)


def _t1_encode(coef, orient: int, style: int, nbits: int):
    """Tier-1 (Annex D) of one code-block's integer coefficients (h, w):
    [(passes, bytes)] per terminated segment, the segments as a decoder
    groups them for the style."""
    h, w = coef.shape
    mag = np.abs(coef).astype(np.int64)
    neg = (coef < 0)
    sig = np.zeros((h + 2, w + 2), np.int8)  # 1 significant, -1 negative
    visited = np.zeros((h, w), bool)
    refined = np.zeros((h, w), bool)
    states = [0] * 19
    mps = [0] * 19

    def reset():
        states[:] = [0] * 19
        mps[:] = [0] * 19
        states[_UNI], states[_AGG], states[0] = 46, 3, 4

    reset()
    vsc = bool(style & VSC)

    def nb(y, x):  # the significance of the neighbours, VSC applied
        cz = vsc and (y & 3) == 3
        a = sig[y:y + 3, x:x + 3] != 0
        hh = int(a[1, 0]) + int(a[1, 2])
        vv = int(a[0, 1]) + (0 if cz else int(a[2, 1]))
        dd = int(a[0, 0]) + int(a[0, 2]) + (
            0 if cz else int(a[2, 0]) + int(a[2, 2]))
        return hh, vv, dd, cz

    def zc(y, x):
        hh, vv, dd, _ = nb(y, x)
        if orient == 3:
            hv = hh + vv
            if not dd:
                return 0 if hv == 0 else 1 if hv == 1 else 2
            if dd == 1:
                return 3 if hv == 0 else 4 if hv == 1 else 5
            if dd == 2:
                return 6 if hv == 0 else 7
            return 8
        if orient == 1:
            hh, vv = vv, hh
        if not hh:
            if not vv:
                return 0 if dd == 0 else 1 if dd == 1 else 2
            return 3 if vv == 1 else 4
        if hh == 1:
            return 7 if vv else 6 if dd else 5
        return 8

    def sc(y, x):
        cz = vsc and (y & 3) == 3
        s = sig
        hc = max(-1, min(1, int(s[y + 1, x]) + int(s[y + 1, x + 2])))
        vc = max(-1, min(1, int(s[y, x + 1]) + (
            0 if cz else int(s[y + 2, x + 1]))))
        xr = 1 if (hc < 0 or (hc == 0 and vc < 0)) else 0
        if hc < 0:
            hc, vc = -hc, -vc
        ctx = _SC + ((1 if vc else 0) if not hc else
                     (2 if vc < 0 else 3 if vc == 0 else 4))
        return ctx, xr

    def any_nb(y, x):
        hh, vv, dd, _ = nb(y, x)
        return hh + vv + dd > 0

    def make_sig(y, x):
        sig[y + 1, x + 1] = -1 if neg[y, x] else 1

    def code_sign(enc, y, x, raw):
        if raw:
            enc.encode(int(neg[y, x]))
        else:
            ctx, xr = sc(y, x)
            enc.encode(int(neg[y, x]) ^ xr, ctx)
        make_sig(y, x)

    def scan():
        for y0 in range(0, h, 4):
            for x in range(w):
                yield y0, x

    def sigpass(enc, p, raw):
        for y0, x in scan():
            for y in range(y0, min(y0 + 4, h)):
                if sig[y + 1, x + 1] or visited[y, x] or not any_nb(y, x):
                    continue
                bit = int((mag[y, x] >> p) & 1)
                if raw:
                    enc.encode(bit)
                else:
                    enc.encode(bit, zc(y, x))
                if bit:
                    code_sign(enc, y, x, raw)
                visited[y, x] = True

    def refpass(enc, p, raw):
        for y0, x in scan():
            for y in range(y0, min(y0 + 4, h)):
                if not sig[y + 1, x + 1] or visited[y, x]:
                    continue
                bit = int((mag[y, x] >> p) & 1)
                if raw:
                    enc.encode(bit)
                else:
                    ctx = _MAG + 2 if refined[y, x] else (
                        _MAG + 1 if any_nb(y, x) else _MAG)
                    enc.encode(bit, ctx)
                refined[y, x] = True

    def clnpass(enc, p):
        for y0, x in scan():
            rows = min(4, h - y0)
            i = 0
            partial = False
            if rows == 4 and all(not sig[y0 + k + 1, x + 1] and
                                 not visited[y0 + k, x] and
                                 not any_nb(y0 + k, x) for k in range(4)):
                bits = [int((mag[y0 + k, x] >> p) & 1) for k in range(4)]
                if not any(bits):
                    enc.encode(0, _AGG)
                    continue
                enc.encode(1, _AGG)
                i = bits.index(1)
                enc.encode(i >> 1, _UNI)
                enc.encode(i & 1, _UNI)
                partial = True
            for k in range(i, rows):
                y = y0 + k
                if not partial:
                    if sig[y + 1, x + 1] or visited[y, x]:
                        continue
                    bit = int((mag[y, x] >> p) & 1)
                    enc.encode(bit, zc(y, x))
                    if not bit:
                        continue
                partial = False
                code_sign(enc, y, x, False)
            visited[y0:y0 + rows, x] = False
        if style & SEGSYM:
            for b in (1, 0, 1, 0):
                enc.encode(b, _UNI)

    # the passes, from the top bit-plane: cleanup, then sig, ref, cleanup
    passes = []
    for p in range(nbits - 1, -1, -1):
        kinds = (2,) if p == nbits - 1 else (0, 1, 2)
        passes += [(k, p) for k in kinds]
    segments, enc, count, maxp = [], None, 0, None
    first = True
    for n, (kind, p) in enumerate(passes):
        raw = bool(style & BYPASS) and n >= 10 and kind < 2
        if enc is None:
            if style & TERMALL:
                maxp = 1
            elif style & BYPASS:
                maxp = 10 if first else (2 if maxp in (1, 10) else 1)
            else:
                maxp = 109
            first = False
            enc = _RawEncoder() if raw else _MqEncoder(states, mps)
            count = 0
        if kind == 0:
            sigpass(enc, p, raw)
        elif kind == 1:
            refpass(enc, p, raw)
        else:
            clnpass(enc, p)
        if (style & RESET) and not raw:
            reset()
        count += 1
        if count == maxp or n == len(passes) - 1:
            segments.append((count, enc.flush()))
            enc = None
    return segments


# ------------------------------------------- the HT block coder (Part 15)
#
# ITU-T T.814 / ISO/IEC 15444-15: the cleanup pass (MagSgn forward, MEL,
# VLC backward, with their stuffing), then SigProp and MagRef, mirroring
# the scan of OpenJPEG 2.5's decoder (ht_dec.c) that cv2 reads them with.
# Its VLC codewords come from the decode tables of native/j2k_ht_tables.h
# inverted (`tools.ht_vlc_table` finds those in cv2's binary): cv2 reading
# the lossless fixtures back to their pictures witnesses both.

HT = 0x40
_HT_HEADER = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "j2k_ht_tables.h")


@functools.lru_cache(maxsize=None)
def _committed_ht_tables():
    from semi_detr_tpu_torch.tools.ht_vlc_table import parse_header
    with open(_HT_HEADER) as f:
        t0, t1, mel = parse_header(f.read())
    return tuple(t0.tolist()), tuple(t1.tolist()), mel


def _vlc_encoder(table):
    """{(context, rho, u_off): [(e_k, e_1, codeword, length)]} of a decode
    table."""
    out = {}
    for i, e in enumerate(table):
        n = e & 7
        if not n:
            continue
        key = (i >> 7, (e >> 4) & 15, (e >> 3) & 1)
        entry = ((e >> 12) & 15, (e >> 8) & 15, i & ((1 << n) - 1), n)
        if entry not in out.setdefault(key, []):
            out[key].append(entry)
    return out


@functools.lru_cache(maxsize=4)
def _ht_coder(tables):
    t0, t1, mel = tables
    return _vlc_encoder(t0), _vlc_encoder(t1), mel


class _Fwd:
    """A forward stream (MagSgn, SigProp): bits from the least significant,
    7 bits in the byte after an 0xFF."""

    def __init__(self):
        self.buf, self.tmp, self.used, self.max = bytearray(), 0, 0, 8

    def put(self, v, n):
        while n > 0:
            t = min(self.max - self.used, n)
            self.tmp |= (v & ((1 << t) - 1)) << self.used
            self.used += t
            v >>= t
            n -= t
            if self.used == self.max:
                self.buf.append(self.tmp)
                self.max = 7 if self.tmp == 0xFF else 8
                self.tmp = self.used = 0

    def end(self, fill):
        """MagSgn pads with ones (a last 0xFF dropped: the decoder reads
        0xFF past the end); SigProp with zeros."""
        if self.used:
            if fill:
                self.tmp |= ((1 << (self.max - self.used)) - 1) << self.used
            if not (fill and self.tmp == 0xFF):
                self.buf.append(self.tmp)
        elif fill and self.max == 7:
            self.buf.pop()
        return bytes(self.buf)


class _Rev:
    """A backward stream (VLC, MagRef), written from the segment's end: a
    byte after one above 0x8F holds 7 bits when its low 7 are all ones."""

    def __init__(self, vlc):
        # the VLC's first byte shares its low nibble with Scup, and the
        # segment's last byte is Scup's
        self.buf = [0xFF] if vlc else []
        self.used, self.tmp, self.last8f = (4, 0xF, True) if vlc else (
            0, 0, True)

    def put(self, v, n):
        while n > 0:
            avail = 8 - self.last8f - self.used
            t = min(avail, n)
            self.tmp |= (v & ((1 << t) - 1)) << self.used
            self.used += t
            v >>= t
            n -= t
            if t == avail:
                if self.last8f and self.tmp != 0x7F:
                    self.last8f = False
                    continue
                self.buf.append(self.tmp)
                self.last8f = self.tmp > 0x8F
                self.tmp = self.used = 0

    def end(self):
        if self.used:
            self.buf.append(self.tmp)
        return bytes(self.buf[::-1])


class _Mel:
    """The MEL coder (T.814 C.3): runs of 0 events, bits from the most
    significant, 7 bits in the byte after an 0xFF."""

    def __init__(self, exp):
        self.exp, self.buf, self.tmp, self.rem = exp, bytearray(), 0, 8
        self.run, self.k, self.threshold = 0, 0, 1

    def bit(self, b):
        self.tmp = (self.tmp << 1) | b
        self.rem -= 1
        if not self.rem:
            self.buf.append(self.tmp)
            self.rem = 7 if self.tmp == 0xFF else 8
            self.tmp = 0

    def event(self, e):
        if not e:
            self.run += 1
            if self.run >= self.threshold:
                self.bit(1)
                self.run = 0
                self.k = min(12, self.k + 1)
                self.threshold = 1 << self.exp[self.k]
            return
        self.bit(0)
        for t in range(self.exp[self.k] - 1, -1, -1):
            self.bit((self.run >> t) & 1)
        self.run = 0
        self.k = max(0, self.k - 1)
        self.threshold = 1 << self.exp[self.k]


def _mel_vlc_end(mel, vlc):
    """The MEL's last byte and the VLC's first, fused where their bits do
    not overlap (OpenJPH's termination)."""
    if mel.run > 0:
        mel.bit(1)
    mtmp = (mel.tmp << mel.rem) & 0xFF
    mmask = (0xFF << mel.rem) & 0xFF
    vmask = 0xFF >> (8 - vlc.used)
    if not (mmask | vmask):
        return
    fuse = mtmp | vlc.tmp
    if not (((fuse ^ mtmp) & mmask) | ((fuse ^ vlc.tmp) & vmask)) and \
            fuse != 0xFF and len(vlc.buf) > 1:
        mel.buf.append(fuse)
    else:
        mel.buf.append(mtmp)
        vlc.buf.append(vlc.tmp)
    vlc.used = 0


# u's prefix (least significant bit first) and suffix lengths (T.814
# Table 3): 1 "1"; 2 "01"; 3-4 "001" + 1 bit; 5-36 "000" + 5 bits
def _u_code(u):
    if u == 0:
        return (0, 0), (0, 0)
    if u <= 2:
        return (1, 1) if u == 1 else (2, 2), (0, 0)
    if u <= 4:
        return (4, 3), (u - 3, 1)
    return (0, 3), (u - 5, 5)


def _bitlen(a):
    a = np.asarray(a, np.int64)
    out = np.zeros(a.shape, np.int64)
    m = a.copy()
    while m.any():
        out += m > 0
        m >>= 1
    return out


def _ht_cleanup(mu, neg, coder):
    """The HT cleanup pass of magnitudes mu (h, w) with signs neg: the
    codeword segment [MagSgn][MEL][VLC reversed], Scup in its last two
    bytes."""
    enc0, enc1, mel_exp = coder
    h, w = mu.shape
    hh, ww = h + (h & 1), (w + 3) // 4 * 4
    vv = np.zeros((hh, ww), np.int64)
    ee = np.zeros((hh, ww), np.int64)
    sig = mu > 0
    vv[:h, :w] = np.where(sig, 2 * (mu - 1) + neg, 0)
    ee[:h, :w] = _bitlen(np.where(sig, 2 * (mu - 1) + 1, 0))
    # a quad's samples: 0 top-left, 1 bottom-left, 2 top-right, 3 bottom-
    # right
    qv = np.stack([vv[0::2, 0::2], vv[1::2, 0::2], vv[0::2, 1::2],
                   vv[1::2, 1::2]], -1).tolist()
    qe = np.stack([ee[0::2, 0::2], ee[1::2, 0::2], ee[0::2, 1::2],
                   ee[1::2, 1::2]], -1).tolist()
    ms, mel, vlc = _Fwd(), _Mel(mel_exp), _Rev(True)
    nq = ww // 2
    ls = [0] * (nq + 3)  # the line state the decoder keeps per quad

    memo = {}

    def codeword(enc, c, rho, u_off, U, v):
        key = (enc is enc0, c, rho, u_off, U,
               tuple(v[i] >> (U - 1) for i in range(4) if rho >> i & 1))
        if key in memo:
            ek, cwd, n = memo[key]
            vlc.put(cwd, n)
            return ek
        best = None
        for ek, e1, cwd, n in enc[(c, rho, u_off)]:
            if U == 1 and ek:
                continue
            if any(ek >> i & 1 and (v[i] >> (U - 1)) != (e1 >> i & 1)
                   for i in range(4) if rho >> i & 1):
                continue
            key = (-bin(ek).count("1"), n, cwd)
            if best is None or key < best[0]:
                best = (key, ek, cwd, n)
        if best is None:
            raise ValueError(f"no codeword for context {c}, rho {rho}, "
                             f"u_off {u_off}, U {U}")
        memo[key] = best[1:]
        vlc.put(best[2], best[3])
        return best[1]

    def magsgn(rho, U, ek, v):
        for i in range(4):
            if rho >> i & 1:
                m = U - (ek >> i & 1)
                ms.put(v[i] & ((1 << m) - 1), m)

    def line_state(j, rho, e):
        if rho & 2:
            ls[j] = 0x80 | max(ls[j] & 0x7F, e[1])
        ls[j + 1] = 0x80 | e[3] if rho & 8 else 0

    for yq in range(hh // 2):
        first = yq == 0
        ls0, c_q = ls[0], 0
        if not first:
            ls[0] = 0
        for x in range(0, w, 4):
            j = x // 2
            quads = [(qv[yq][j], qe[yq][j])]
            if x + 2 < w:
                quads.append((qv[yq][j + 1], qe[yq][j + 1]))
            info = []
            for k, (v, e) in enumerate(quads):
                rho = sum(1 << i for i in range(4) if e[i])
                if first:
                    c, kappa = c_q, 1
                else:
                    left, right = (ls0, ls[j + 1]) if k == 0 else (
                        ls[j + 1], ls[j + 2])
                    c = c_q | (left >> 7) | ((right >> 5) & 4)
                    kappa = 1
                    if bin(rho).count("1") >= 2:
                        kappa = max(max(left & 0x7F, right & 0x7F) - 1, 1)
                U = max(max(e), kappa)
                u = U - kappa
                if c == 0:
                    mel.event(rho != 0)
                ek = 0
                if c or rho:
                    ek = codeword(enc0 if first else enc1, c, rho,
                                  int(u > 0), U, v)
                c_q = ((rho & 1) | (rho >> 1)) if first else (
                    2 if rho & 12 else 0)
                info.append((rho, U, u, ek, v, e))
            u0 = info[0][2]
            u1 = info[1][2] if len(info) > 1 else 0
            (p0, s0), (p1, s1) = _u_code(u0), _u_code(u1)
            if first and u0 and u1:
                mel.event(min(u0, u1) > 2)
                if min(u0, u1) > 2:
                    (p0, s0), (p1, s1) = _u_code(u0 - 2), _u_code(u1 - 2)
                elif u0 > 2:
                    p1, s1 = (u1 - 1, 1), (0, 0)
                    vlc.put(*p0)
                    vlc.put(*p1)
                    vlc.put(*s0)
                    p0 = p1 = s0 = (0, 0)
            for cw in (p0, p1, s0, s1):
                vlc.put(*cw)
            if not first:
                ls0 = ls[j + 2]
                ls[j + 1] = ls[j + 2] = 0
            for k, (rho, U, u, ek, v, e) in enumerate(info):
                magsgn(rho, U, ek, v)
                line_state(j + k, rho, e)
            if len(info) == 1:
                ls[j + 2] = 0
    _mel_vlc_end(mel, vlc)
    seg = bytearray(ms.end(True) + bytes(mel.buf) + vlc.end())
    scup = len(mel.buf) + len(vlc.buf)
    if not 2 <= scup <= 4079:
        raise ValueError(f"Scup {scup} out of range")
    seg[-1] = scup >> 4
    seg[-2] = (seg[-2] & 0xF0) | (scup & 0xF)
    return bytes(seg)


def _ht_refine(mag, neg, p, vsc, magref):
    """SigProp (and with `magref` MagRef) at plane p - 1 of the cleanup at
    plane p, in the stripes, groups of 4 columns and bit orders OpenJPEG
    reads them: (SigProp's bytes, MagRef's reversed), which the second
    codeword segment holds in that order."""
    h, w = mag.shape
    sig = (mag >> p) > 0
    bit = ((mag >> (p - 1)) & 1).astype(bool)
    sp, mr = _Fwd(), _Rev(False)
    above = np.zeros(w + 2, bool)  # the previous stripe's row 3, final
    for y0 in range(0, h, 4):
        rows = min(4, h - y0)
        s = np.zeros((6, w + 2), bool)  # rows -1..4, columns -1..w
        s[1:rows + 1, 1:w + 1] = sig[y0:y0 + rows]
        mb = np.zeros((4, w + 2), bool)
        for r in range(4):
            lo, hi = max(r - 1, 0), min(r + 1, 3)
            for dr in range(lo, hi + 1):
                mb[r, 1:w + 1] |= s[dr + 1, 0:w] | s[dr + 1, 1:w + 1] | \
                    s[dr + 1, 2:w + 2]
        if y0 + 4 < h and not vsc:
            nxt = np.zeros(w + 2, bool)
            nxt[1:w + 1] = sig[y0 + 4]
            mb[3, 1:w + 1] |= nxt[0:w] | nxt[1:w + 1] | nxt[2:w + 2]
        mb[0, 1:w + 1] |= above[0:w] | above[1:w + 1] | above[2:w + 2]
        mb[:, 1:w + 1] &= ~s[1:5, 1:w + 1]
        mb[rows:] = False
        if magref:  # the cleanup's samples, column by column
            col = bit[y0:y0 + rows].T[sig[y0:y0 + rows].T].astype(
                np.int64)
            for at in range(0, len(col), 32):
                chunk = col[at:at + 32]
                mr.put(int((chunk << np.arange(len(chunk))).sum()),
                       len(chunk))
        mbt = mb[:, 1:].T.tolist()  # by column, 4 rows each
        st = s[1:5, 1:].T.tolist()
        pad = np.zeros((4, w), bool)
        pad[:rows] = bit[y0:y0 + rows]
        bt = pad.T.tolist()
        pad = np.zeros((4, w), bool)
        pad[:rows] = neg[y0:y0 + rows] > 0
        nt = pad.T.tolist()
        newt = [[False] * 4 for _ in range(w + 1)]
        for g in range(0, w, 4):
            for x in range(g, min(g + 4, w)):
                m, b = mbt[x], bt[x]
                for r in range(4):
                    if not m[r]:
                        continue
                    sp.put(int(b[r]), 1)
                    if not b[r]:
                        continue
                    newt[x][r] = True
                    if r < 3 and not st[x][r + 1] and r + 1 < rows:
                        m[r + 1] = True
                    for rr in range(max(r - 1, 0), min(r + 1, 3) + 1):
                        if rr < rows and not st[x + 1][rr]:
                            mbt[x + 1][rr] = True
            for x in range(g, min(g + 4, w)):
                for r in range(4):
                    if newt[x][r]:
                        sp.put(int(nt[x][r]), 1)
        above = np.zeros(w + 2, bool)
        if rows == 4:
            above[1:w + 1] = s[4, 1:w + 1] | np.array(
                [c[3] for c in newt[:w]], bool)
    return sp.end(False), mr.end()


# the damage `ht_damage` does to every HT code-block (the tests hold the
# decoder to cv2 on each): a second segment of no bytes; SigProp and
# MagRef signalled below plane 0 (two passes of two zero bytes after a
# lossless cleanup); Scup past Lcup, or below 2; a cleanup segment of one
# byte; zero bit-planes past the band's; one bit-plane more than coded;
# significance in a column past the block's (an odd width)
HT_DAMAGE = ("empty_refinement", "below_plane_0", "scup_past_lcup",
             "scup_below_2", "short_cleanup", "zero_planes_past",
             "planes_overstated", "outside")


def _ht_encode(coef, p, passes, vsc, tables, damage=None):
    """One HT code-block of integer coefficients, its cleanup at plane p:
    [(codeword segment, bytes)] per coding pass, the cleanup (segment 0),
    then SigProp and MagRef of plane p - 1 (segment 1) where passes > 1;
    passes past 3 are signalled with no bytes (OpenJPEG refuses them)."""
    coder = _ht_coder(tuple(tuple(int(e) for e in t) for t in tables)
                      if tables is not None else _committed_ht_tables())
    mag = np.abs(np.asarray(coef, np.int64))
    neg = (np.asarray(coef) < 0).astype(np.int64)
    mu, sgn = mag >> p, neg
    if damage == "outside":
        mu = np.pad(mu, ((0, 0), (0, 1)), constant_values=1)
        sgn = np.pad(neg, ((0, 0), (0, 1)))
    cleanup = bytearray(_ht_cleanup(mu, sgn, coder))
    if damage == "scup_past_lcup":
        scup = len(cleanup) + 1
        cleanup[-1] = scup >> 4
        cleanup[-2] = (cleanup[-2] & 0xF0) | (scup & 0xF)
    elif damage == "scup_below_2":
        cleanup[-1] = 0
        cleanup[-2] = (cleanup[-2] & 0xF0) | 1
    elif damage == "short_cleanup":
        cleanup = cleanup[:1]
    out = [(0, bytes(cleanup))]
    if damage == "below_plane_0":
        return out + [(1, b"\0"), (1, b"\0")]
    if passes > 1:
        sp, mr = _ht_refine(mag, neg, p, vsc, passes > 2)
        if damage == "empty_refinement":
            sp = mr = b""
        out += [(1, sp), (1, mr)][:passes - 1]
        out += [(1, b"")] * (passes - 3)
    return out


def _fdwt53(a, axis, x0):
    """The forward 5/3 (F.4.8.2) along one axis of samples starting at the
    absolute coordinate x0: (low, high)."""
    a = np.moveaxis(np.asarray(a, np.int64), axis, 0)
    n = a.shape[0]
    if n == 1:
        lo, hi = (a, a[:0]) if x0 % 2 == 0 else (a[:0], a * 2)
        return np.moveaxis(lo, 0, axis), np.moveaxis(hi, 0, axis)
    x = a.copy()

    def at(i):
        if i < 0:
            i = -i
        if i >= n:
            i = 2 * (n - 1) - i
        return x[i]

    odd = [i for i in range(n) if (x0 + i) % 2]
    even = [i for i in range(n) if (x0 + i) % 2 == 0]
    for i in odd:
        x[i] = x[i] - ((at(i - 1) + at(i + 1)) >> 1)
    for i in even:
        x[i] = x[i] + ((at(i - 1) + at(i + 1) + 2) >> 2)
    return (np.moveaxis(x[even], 0, axis), np.moveaxis(x[odd], 0, axis))


def _ceil_pow2(a, b):
    return -((-a) >> b)


class _Tile:
    """One tile-component's resolutions, bands, precincts and code-blocks,
    laid out as ISO/IEC 15444-1 Annex B (and OpenJPEG's tcd.c) lay them."""

    def __init__(self, plane, x0, y0, levels, cblk, precincts):
        self.x0, self.y0 = x0, y0
        self.x1, self.y1 = x0 + plane.shape[1], y0 + plane.shape[0]
        self.levels = levels
        # the wavelet: columns, then rows, level by level
        bands = {}
        ll, lx0, ly0 = plane.astype(np.int64), x0, y0
        for lv in range(1, levels + 1):
            lo, hi = _fdwt53(ll, 0, ly0)
            lolo, hilo = _fdwt53(lo, 1, lx0)
            lohi, hihi = _fdwt53(hi, 1, lx0)
            r = levels - lv + 1
            bands[(r, 1)], bands[(r, 2)], bands[(r, 3)] = hilo, lohi, hihi
            ll, lx0, ly0 = lolo, _ceil_pow2(lx0, 1), _ceil_pow2(ly0, 1)
        bands[(0, 0)] = ll
        self.res = []
        for r in range(levels + 1):
            lv = levels - r
            rx0, ry0 = _ceil_pow2(x0, lv), _ceil_pow2(y0, lv)
            rx1, ry1 = _ceil_pow2(self.x1, lv), _ceil_pow2(self.y1, lv)
            pdx, pdy = precincts[r]
            px0, py0 = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
            pw = 0 if rx0 == rx1 else (
                (_ceil_pow2(rx1, pdx) << pdx) - px0) >> pdx
            ph = 0 if ry0 == ry1 else (
                (_ceil_pow2(ry1, pdy) << pdy) - py0) >> pdy
            if r == 0:
                gx0, gy0, gw, gh = px0, py0, pdx, pdy
            else:
                gx0, gy0 = _ceil_pow2(px0, 1), _ceil_pow2(py0, 1)
                gw, gh = pdx - 1, pdy - 1
            cbw, cbh = min(cblk[0], gw), min(cblk[1], gh)
            blist = []
            for b in ((0,) if r == 0 else (1, 2, 3)):
                if r == 0:
                    bx0, by0, bx1, by1 = rx0, ry0, rx1, ry1
                else:
                    xob, yob = b & 1, b >> 1
                    bx0 = _ceil_pow2(x0 - (xob << lv), lv + 1)
                    by0 = _ceil_pow2(y0 - (yob << lv), lv + 1)
                    bx1 = _ceil_pow2(self.x1 - (xob << lv), lv + 1)
                    by1 = _ceil_pow2(self.y1 - (yob << lv), lv + 1)
                data = bands[(r, b)]
                assert data.shape == (max(by1 - by0, 0), max(bx1 - bx0, 0))
                precs = []
                for pn in range(pw * ph):
                    cx0 = gx0 + (pn % pw) * (1 << gw)
                    cy0 = gy0 + (pn // pw) * (1 << gh)
                    qx0, qy0 = max(cx0, bx0), max(cy0, by0)
                    qx1 = min(cx0 + (1 << gw), bx1)
                    qy1 = min(cy0 + (1 << gh), by1)
                    tx0, ty0 = (qx0 >> cbw) << cbw, (qy0 >> cbh) << cbh
                    cw = max(0, (_ceil_pow2(qx1, cbw) << cbw) - tx0 >> cbw)
                    ch = max(0, (_ceil_pow2(qy1, cbh) << cbh) - ty0 >> cbh)
                    blocks = []
                    for k in range(cw * ch):
                        ux = tx0 + (k % cw) * (1 << cbw)
                        uy = ty0 + (k // cw) * (1 << cbh)
                        ex0, ey0 = max(ux, qx0), max(uy, qy0)
                        ex1, ey1 = min(ux + (1 << cbw), qx1), min(
                            uy + (1 << cbh), qy1)
                        blocks.append(data[ey0 - by0:ey1 - by0,
                                           ex0 - bx0:ex1 - bx0])
                    precs.append((cw, ch, blocks))
                blist.append(dict(b=b, empty=bx1 <= bx0 or by1 <= by0,
                                  precs=precs))
            self.res.append(dict(x0=rx0, y0=ry0, x1=rx1, y1=ry1, pdx=pdx,
                                 pdy=pdy, pw=pw, ph=ph, bands=blist))


class _BitWriter:
    """Packet header bits (opj_bio): a 0 bit stuffed after each 0xFF."""

    def __init__(self):
        self.out, self.buf, self.ct = bytearray(), 0, 8

    def _byteout(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        self.out.append(self.buf >> 8)

    def put(self, bit):
        if self.ct == 0:
            self._byteout()
        self.ct -= 1
        self.buf |= bit << self.ct

    def bits(self, v, n):
        for i in range(n - 1, -1, -1):
            self.put((v >> i) & 1)

    def flush(self) -> bytes:
        self._byteout()
        if self.ct == 7:
            self._byteout()
        return bytes(self.out)


class _TagTree:
    def __init__(self, w, h):
        sizes, self.parent = [(w, h)], []
        while sizes[-1][0] * sizes[-1][1] > 1:
            sizes.append(((sizes[-1][0] + 1) // 2, (sizes[-1][1] + 1) // 2))
        base = 0
        for lw_, lh_ in sizes:
            nxt = base + lw_ * lh_
            nw_ = (lw_ + 1) // 2
            for j in range(lh_):
                for i in range(lw_):
                    self.parent.append(nxt + (j // 2) * nw_ + i // 2
                                       if lw_ * lh_ > 1 else -1)
            base = nxt
        n = len(self.parent)
        self.value, self.low, self.known = [999] * n, [0] * n, [0] * n

    def set(self, leaf, v):
        node = leaf
        while node >= 0 and self.value[node] > v:
            self.value[node] = v
            node = self.parent[node]

    def encode(self, bw, leaf, threshold):
        stack, node = [], leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bw.put(1)
                        self.known[node] = 1
                    break
                bw.put(0)
                low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()


def _put_passes(bw, n):
    if n == 1:
        bw.put(0)
    elif n == 2:
        bw.bits(2, 2)
    elif n <= 5:
        bw.bits(3, 2)
        bw.bits(n - 3, 2)
    elif n <= 36:
        bw.bits(15, 4)
        bw.bits(n - 6, 5)
    else:
        bw.bits(0x1FF, 9)
        bw.bits(n - 37, 7)


def _packet_order(tiles, numlayers, prg, pocs, comps, tx0, ty0, tx1, ty1):
    """pi.c's packets of a tile: [(layer, res, comp, precinct)], each once
    (comps: (dx, dy) per component)."""
    nc = len(tiles)
    seen, out = set(), []

    def emit(l, r, c, p):
        if (l, r, c, p) not in seen:
            seen.add((l, r, c, p))
            out.append((l, r, c, p))

    maxres = max(t.levels + 1 for t in tiles)
    entries = pocs or [(0, 0, numlayers, maxres, nc, prg)]
    dx = dy = 0
    for c, t in enumerate(tiles):
        for r, res in enumerate(t.res):
            lv = t.levels - r
            ddx, ddy = comps[c][0] << (res["pdx"] + lv), comps[c][1] << (
                res["pdy"] + lv)
            dx, dy = (min(dx, ddx) if dx else ddx), (min(dy, ddy) if dy
                                                      else ddy)

    def position(x, y, r, c):
        t = tiles[c]
        if r > t.levels:
            return None
        res, lv = t.res[r], t.levels - r
        cdx, cdy = comps[c][0] << lv, comps[c][1] << lv
        trx0, try0 = -(-tx0 // cdx), -(-ty0 // cdy)
        trx1, try1 = -(-tx1 // cdx), -(-ty1 // cdy)
        rpx, rpy = res["pdx"] + lv, res["pdy"] + lv
        if not (y % (comps[c][1] << rpy) == 0 or
                (y == ty0 and (try0 << lv) % (1 << rpy))):
            return None
        if not (x % (comps[c][0] << rpx) == 0 or
                (x == tx0 and (trx0 << lv) % (1 << rpx))):
            return None
        if not res["pw"] or not res["ph"] or trx0 == trx1 or try0 == try1:
            return None
        prci = (-(-x // cdx) >> res["pdx"]) - (trx0 >> res["pdx"])
        prcj = (-(-y // cdy) >> res["pdy"]) - (try0 >> res["pdy"])
        return prci + prcj * res["pw"]

    def positions():
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield x, y
                x += dx - x % dx
            y += dy - y % dy

    for r0, c0, l1, r1, c1, order in entries:
        l1 = min(l1, numlayers)

        def precincts(l, r, c):
            if r <= tiles[c].levels:
                res = tiles[c].res[r]
                for p in range(res["pw"] * res["ph"]):
                    emit(l, r, c, p)

        def layers(r, c, p):
            if p is not None:
                for l in range(l1):
                    emit(l, r, c, p)

        if order == 0:
            for l in range(l1):
                for r in range(r0, r1):
                    for c in range(c0, c1):
                        precincts(l, r, c)
        elif order == 1:
            for r in range(r0, r1):
                for l in range(l1):
                    for c in range(c0, c1):
                        precincts(l, r, c)
        elif order == 2:
            for r in range(r0, r1):
                for x, y in positions():
                    for c in range(c0, c1):
                        layers(r, c, position(x, y, r, c))
        elif order == 3:
            for x, y in positions():
                for c in range(c0, c1):
                    for r in range(r0, r1):
                        layers(r, c, position(x, y, r, c))
        else:
            for c in range(c0, c1):
                for x, y in positions():
                    for r in range(r0, r1):
                        layers(r, c, position(x, y, r, c))
    return out


def _marker(code, body=b""):
    return struct.pack(">HH", code, len(body) + 2) + body


def j2k_codestream(planes, precision=8, signed=False, subsampling=None,
                   offset=(0, 0), levels=2, cblk=(4, 4), style=0,
                   layers=1, progression=0, pocs=None, precincts=None,
                   tile=None, mct=None, sop=False, eph=False, ppm=False,
                   ppt=False, roi=None, tile_parts=1, coc=None,
                   comment=None, ht=False, ht_passes=1, ht_drop=0,
                   ht_layers=None, cap=True, cpf=False, irreversible=False,
                   ht_tables=None, ht_damage=None) -> bytes:
    """A lossless codestream of integer planes (one per component, each at
    its own sampled size): 5/3 wavelet over `levels`, code-blocks of
    2^cblk, `style` the code-block style bits, `layers` quality layers
    (TERMALL spreads the passes over them, else layer 0 holds them all),
    `progression` 0-4 (LRCP, RLCP, RPCL, PCRL, CPRL) or `pocs` [(res0,
    comp0, layer1, res1, comp1, order)], `precincts` [(log2 w, log2 h)] by
    resolution, `tile` (w, h), `mct` the RCT (default: 3 or more
    components), SOP / EPH markers, packet headers in PPM or PPT, `roi`
    (shift, fraction of each band's top-left raised), `tile_parts` per
    tile (interleaved across tiles), `coc` {component: (cblk, style)}.

    `ht`: every code-block by the HT block coder (style bit 0x40 added to
    `style`, a CAP marker unless `cap` is False, a CPF marker with `cpf`):
    `ht_passes` 1 (cleanup), 2 (+ SigProp) or 3 (+ MagRef), more signalled
    empty; the cleanup at plane `ht_drop` + (1 with SigProp), planes below
    `ht_drop` left out (lossy; and SigProp reaches only the samples next to
    significant ones, so three passes are lossless only where plane
    `ht_drop` has no other); `ht_layers` the passes each layer adds (by
    default all in layer 0); `ht_tables` decode tables (default
    native/j2k_ht_tables.h); `ht_damage` one of HT_DAMAGE. `irreversible`:
    the 9/7 wavelet in COD and scalar-expounded QCD / QCC, the 5/3
    coefficients sent as its quantised ones (a picture cv2 decodes as the
    decoder under test must; not the input's)."""
    nc = len(planes)
    prec = [precision] * nc if np.isscalar(precision) else list(precision)
    sgn = [signed] * nc if np.isscalar(signed) else list(signed)
    sub = subsampling or [(1, 1)] * nc
    ox, oy = offset
    h0, w0 = planes[0].shape
    x1, y1 = ox + w0 * sub[0][0], oy + h0 * sub[0][1]
    mct = nc >= 3 if mct is None else mct
    prec_sizes = precincts or [(15, 15)] * (levels + 1)
    tw_, th_ = tile or (x1, y1)
    ntx, nty = -(-x1 // tw_), -(-y1 // th_)
    # component planes on the canvas, DC shifted
    comp = []
    for c in range(nc):
        v = np.asarray(planes[c], np.int64)
        if not sgn[c]:
            v = v - (1 << (prec[c] - 1))
        comp.append(v)
    if ht:
        style |= HT
    cstyle = {c: (cblk, style) for c in range(nc)}
    cstyle.update(coc or {})
    htc = dict(passes=ht_passes, drop=ht_drop, layers=ht_layers,
               tables=ht_tables, damage=ht_damage)
    # tiles
    tiles_data = []
    for t in range(ntx * nty):
        p, q = t % ntx, t // ntx
        tx0, ty0 = max(p * tw_, ox), max(q * th_, oy)
        tx1, ty1 = min((p + 1) * tw_, x1), min((q + 1) * th_, y1)
        tcs = []
        for c in range(nc):
            dx, dy = sub[c]
            cx0, cy0 = -(-tx0 // dx), -(-ty0 // dy)
            cx1, cy1 = -(-tx1 // dx), -(-ty1 // dy)
            px0, py0 = -(-ox // dx), -(-oy // dy)
            region = comp[c][cy0 - py0:cy1 - py0, cx0 - px0:cx1 - px0]
            tcs.append(region)
        if mct:
            r_, g_, b_ = tcs[0], tcs[1], tcs[2]
            tcs[0] = (r_ + 2 * g_ + b_) >> 2
            tcs[1], tcs[2] = b_ - g_, r_ - g_
        tiles = [_Tile(tcs[c], -(-tx0 // sub[c][0]), -(-ty0 // sub[c][1]),
                       levels, cstyle[c][0], prec_sizes)
                 for c in range(nc)]
        tiles_data.append(_tile_packets(
            tiles, prec, mct, cstyle, layers, progression, pocs,
            [tuple(s) for s in sub], (tx0, ty0, tx1, ty1), roi, sop, eph,
            htc))
    # the main header
    siz = struct.pack(">HIIIIIIIIH", 0, x1, y1, ox, oy, tw_, th_, 0, 0, nc)
    for c in range(nc):
        siz += bytes([(prec[c] - 1) | (0x80 if sgn[c] else 0), *sub[c]])
    scod = (1 if precincts else 0) | (2 if sop else 0) | (4 if eph else 0)

    def spcod(cb, st):
        out = bytes([levels, cb[0] - 2, cb[1] - 2, st,
                     0 if irreversible else 1])
        if precincts:
            out += bytes(ppy << 4 | ppx for ppx, ppy in prec_sizes)
        return out

    head = b"\xff\x4f" + _marker(0xFF51, siz)
    if ht and cap:  # Part 15 capability, Ccap15 0: HT code-blocks only
        head += _marker(0xFF50, struct.pack(">IH", 1 << 17, 0))
    head += _marker(0xFF52, bytes([scod, progression]) + struct.pack(
        ">H", layers) + bytes([1 if mct else 0]) + spcod(cblk, style))
    csz = 1 if nc < 257 else 2
    for c, (cb, st) in sorted((coc or {}).items()):
        head += _marker(0xFF53, c.to_bytes(csz, "big") + bytes(
            [1 if precincts else 0]) + spcod(cb, st))
    head += _marker(0xFF5C, _sqcd(prec[0] + (1 if mct else 0), levels,
                                  irreversible))
    for c in range(1, nc):
        want = prec[c] + (1 if mct and c < 3 else 0)
        if want != prec[0] + (1 if mct else 0):
            head += _marker(0xFF5D, c.to_bytes(csz, "big") + _sqcd(
                want, levels, irreversible))
    if cpf:  # the corresponding profile: Part 15's HT profile, walked past
        head += _marker(0xFF59, struct.pack(">H", 0x0F00))
    if roi:
        for c in range(nc):
            head += _marker(0xFF5E, c.to_bytes(csz, "big") + bytes(
                [0, roi[0]]))
    if pocs:
        body = b""
        for r0, c0, l1, r1, c1, order in pocs:
            body += bytes([r0]) + c0.to_bytes(csz, "big") + struct.pack(
                ">H", l1) + bytes([r1]) + c1.to_bytes(csz, "big") + bytes(
                    [order])
        head += _marker(0xFF5F, body)
    if comment:
        head += _marker(0xFF64, b"\0\1" + comment)
    # tile-parts: each tile's packets split into tile_parts runs
    parts = []
    for t, packets in enumerate(tiles_data):
        k = len(packets)
        cuts = [round(i * k / tile_parts) for i in range(tile_parts + 1)]
        for i in range(tile_parts):
            parts.append((i, t, packets[cuts[i]:cuts[i + 1]]))
    parts.sort(key=lambda x: (x[0], x[1]))  # interleaved across tiles
    if ppm:
        raw = b"".join(struct.pack(">I", len(ch)) + ch for ch in (
            b"".join(hd for _, hd, _ in pk) for _, _, pk in parts))
        for z, at in enumerate(range(0, len(raw), 65000)):
            head += _marker(0xFF60, bytes([z]) + raw[at:at + 65000])
    out = bytearray(head)
    zppt = [0] * len(tiles_data)  # each tile's PPT segments numbered on
    for i, t, packets in parts:
        if ppm or ppt:
            data = b"".join(sp + bd for sp, _, bd in packets)
        else:
            data = b"".join(sp + hd + bd for sp, hd, bd in packets)
        extra = b""
        if ppt:
            hdrs = b"".join(hd for _, hd, _ in packets)
            for at in range(0, max(len(hdrs), 1), 65000):
                extra += _marker(0xFF61, bytes([zppt[t]]) +
                                 hdrs[at:at + 65000])
                zppt[t] += 1
        psot = 12 + len(extra) + 2 + len(data)
        out += _marker(0xFF90, struct.pack(">HIBB", t, psot, i, tile_parts))
        out += extra + b"\xff\x93" + data
    out += b"\xff\xd9"
    return bytes(out)


_GUARD_BITS = 2


def _sqcd(prec, levels, irreversible=False):
    """QCD / QCC for no quantisation: each band's exponent, its precision
    plus the band's gain, and two guard bits; `irreversible`: scalar
    expounded, the same exponents and a mantissa of 0x280."""
    expn = [prec] + [prec + g for _ in range(levels) for g in (1, 1, 2)]
    if irreversible:
        return bytes([2 | _GUARD_BITS << 5]) + b"".join(
            struct.pack(">H", e << 11 | 0x280) for e in expn)
    return bytes([_GUARD_BITS << 5]) + bytes(e << 3 for e in expn)


def _tile_packets(tiles, prec, mct, cstyle, layers, progression, pocs, sub,
                  bounds, roi, sop, eph, htc):
    """[(SOP marker or b"", header, body)] of one tile's packets, in its
    progression."""
    gains = {0: 0, 1: 1, 2: 1, 3: 2}
    # tier-1 of every code-block: {(c, r, b, p, k): (zero bit-planes,
    # segments)}
    coded = {}
    for c, t in enumerate(tiles):
        style = cstyle[c][1]
        rprec = prec[c] + (1 if mct and c < 3 else 0)
        for r, res in enumerate(t.res):
            for band in res["bands"]:
                if band["empty"]:
                    continue
                mb = rprec + gains[band["b"]] + _GUARD_BITS - 1
                for pn, (cw, ch, blocks) in enumerate(band["precs"]):
                    for k, blk in enumerate(blocks):
                        v = np.asarray(blk, np.int64)
                        shift = 0
                        if roi:
                            shift, frac = roi
                            v = v.copy()
                            v[:int(np.ceil(v.shape[0] * frac)), :] <<= shift
                        nbits = int(np.abs(v).max()).bit_length() if v.size \
                            else 0
                        if style & HT:
                            # the cleanup's plane p: missing MSBs K_max -
                            # 1 - p (RGN's shift is not applied: OpenJPEG
                            # refuses ROI with HT code-blocks)
                            dmg = htc["damage"]
                            p = htc["drop"] + (htc["passes"] > 1 and
                                               dmg != "below_plane_0")
                            zero = mb - 1 - p + {"zero_planes_past": p + 1,
                                                 "planes_overstated": -1
                                                 }.get(dmg, 0)
                            segs = [] if not nbits or (
                                htc["passes"] == 1 and nbits <= p) else \
                                _ht_encode(blk, p, htc["passes"],
                                           bool(style & VSC), htc["tables"],
                                           dmg)
                        else:
                            zero = mb + shift - nbits
                            segs = _t1_encode(v, band["b"], style, nbits) \
                                if nbits and v.size else []
                        if zero < 0:
                            raise ValueError("coefficients past the range "
                                             "the quantisation gives")
                        coded[(c, r, band["b"], pn, k)] = (zero, segs)
    # each code-block's segments by layer: TERMALL spreads them
    def by_layer(segs, style):
        out = [[] for _ in range(layers)]
        if not segs:
            return out
        if style & HT:  # the passes by layer, grouped by codeword segment
            counts = htc["layers"] or [len(segs)]
            at = 0
            for lay, n in enumerate(counts):
                for seg, data in segs[at:at + n]:
                    if out[lay] and out[lay][-1][2] == seg:
                        m, d, _ = out[lay][-1]
                        out[lay][-1] = (m + 1, d + data, seg)
                    else:
                        out[lay].append((1, data, seg))
                at += n
            return [[(m, d) for m, d, _ in g] for g in out]
        if style & TERMALL:
            n = len(segs)
            for i, s in enumerate(segs):
                out[min(layers - 1, i * layers // n)].append(s)
        else:
            out[0] = list(segs)
        return out
    state = {}
    for key, (zero, segs) in coded.items():
        lay = by_layer(segs, cstyle[key[0]][1])
        first = next((i for i, s in enumerate(lay) if s), 10 ** 6)
        state[key] = dict(zero=zero, lay=lay, first=first, lblock=3)
    trees = {}
    for c, t in enumerate(tiles):
        for r, res in enumerate(t.res):
            for band in res["bands"]:
                if band["empty"]:
                    continue
                for pn, (cw, ch, blocks) in enumerate(band["precs"]):
                    incl, imsb = _TagTree(cw, ch), _TagTree(cw, ch)
                    for k in range(cw * ch):
                        s = state[(c, r, band["b"], pn, k)]
                        incl.set(k, s["first"])
                        imsb.set(k, s["zero"])
                    trees[(c, r, band["b"], pn)] = (incl, imsb)
    out = []
    nsop = 0
    for l, r, c, pn in _packet_order(tiles, layers, progression, pocs, sub,
                                     *bounds):
        res = tiles[c].res[r]
        bw = _BitWriter()
        body = b""
        if not any(state[(c, r, band["b"], pn, k)]["lay"][l]
                   for band in res["bands"] if not band["empty"]
                   for k in range(len(band["precs"][pn][2]))):
            bw.put(0)
        else:
            bw.put(1)
            for band in res["bands"]:
                if band["empty"]:
                    continue
                cw, ch, blocks = band["precs"][pn]
                incl, imsb = trees[(c, r, band["b"], pn)]
                for k in range(cw * ch):
                    s = state[(c, r, band["b"], pn, k)]
                    segs = s["lay"][l]
                    if s["first"] >= l:  # not included before this layer
                        if s["first"] > l:
                            incl.encode(bw, k, l + 1)
                            continue
                        incl.encode(bw, k, l + 1)
                        for i in range(s["zero"] + 1):
                            imsb.encode(bw, k, i + 1)
                    else:
                        bw.put(1 if segs else 0)
                        if not segs:
                            continue
                    npass = sum(n for n, _ in segs)
                    _put_passes(bw, npass)
                    need = max(len(d).bit_length() - (n.bit_length() - 1)
                               for n, d in segs)
                    inc = max(0, need - s["lblock"])
                    bw.bits((1 << (inc + 1)) - 2, inc + 1)
                    s["lblock"] += inc
                    for n, d in segs:
                        bw.bits(len(d), s["lblock"] + n.bit_length() - 1)
                    body += b"".join(d for _, d in segs)
        hdr = bw.flush()
        if eph:
            hdr += b"\xff\x92"
        sop_marker = b""
        if sop:
            sop_marker = b"\xff\x91" + struct.pack(">HH", 4, nsop % 65536)
            nsop += 1
        out.append((sop_marker, hdr, body))
    return out


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def jp2_file(codestream: bytes, colour=16, palette=None, cmap=None,
             cdef=None, brand=b"jp2 ") -> bytes:
    """The codestream in a JP2 file: the signature, ftyp, jp2h (ihdr from
    the codestream's SIZ; colr, an enumerated colour space or ("icc",
    profile bytes), or None for none; pclr from `palette` ((entries,
    channels) ints, bit depth 8), cmap [(component, type, column)], cdef
    [(channel, type, association)]) and jp2c; `brand` b"jph " for a JPH
    file (ISO/IEC 15444-15 Annex D: the same boxes under its own brand)."""
    siz = codestream[4:]
    x1, y1, x0, y0 = struct.unpack(">IIII", siz[4:20])
    nc, = struct.unpack(">H", siz[36:38])
    bits = {siz[38 + 3 * c] for c in range(nc)}
    ihdr = struct.pack(">IIH", y1 - y0, x1 - x0, nc) + bytes(
        [bits.pop() if len(bits) == 1 else 255, 7, 0, 0])
    jp2h = _box(b"ihdr", ihdr)
    if ihdr[10] == 255:
        jp2h += _box(b"bpcc", bytes(siz[38 + 3 * c] for c in range(nc)))
    if isinstance(colour, tuple):
        jp2h += _box(b"colr", bytes([2, 0, 0]) + colour[1])
    elif colour is not None:
        jp2h += _box(b"colr", bytes([1, 0, 0]) + struct.pack(">I", colour))
    if palette is not None:
        pal = np.asarray(palette)
        jp2h += _box(b"pclr", struct.pack(">HB", *pal.shape) + bytes(
            [7] * pal.shape[1]) + pal.astype(np.uint8).tobytes())
        jp2h += _box(b"cmap", b"".join(struct.pack(">HBB", *m)
                                       for m in cmap))
    if cdef is not None:
        jp2h += _box(b"cdef", struct.pack(">H", len(cdef)) + b"".join(
            struct.pack(">HHH", *d) for d in cdef))
    return (_box(b"jP  ", b"\r\n\x87\n") +
            _box(b"ftyp", brand + b"\0\0\0\0" + brand) +
            _box(b"jp2h", jp2h) +
            _box(b"jp2c", codestream))


def _picture(h: int, w: int, seed: int, noise: int = 24) -> np.ndarray:
    """A seeded RGB picture: gradients and noise of +-noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 128 // max(h + w, 1)], -1)
    return np.clip(base + rng.integers(-noise, noise + 1, (h, w, 3)), 0,
                   255).astype(np.uint8)


def jpeg2000_files() -> Dict[str, Tuple[bytes, str, str, str]]:
    """The committed JPEG 2000 fixtures of this writer (`j2kw_*`):
    {file name: (bytes, format, variant, expect)}, expect "pixels" where
    cv2.imread reads the file, "refused" where it refuses it."""
    rgb = _picture(19, 23, 15)
    p = [rgb[..., c] for c in range(3)]
    rng = np.random.default_rng(16)
    prc = [(2, 2), (2, 2), (3, 3)]
    out = {}

    def add(name, data, variant, expect="pixels"):
        fmt = "JPEG 2000 (JP2)" if name.endswith(".jp2") else \
            "JPEG 2000 (codestream)"
        out[name] = (data, fmt, variant, expect)

    add("j2kw_bypass.j2k", j2k_codestream(p, style=BYPASS),
        "BYPASS code-blocks")
    add("j2kw_reset_termall.j2k", j2k_codestream(
        p, style=RESET | TERMALL, layers=3), "RESET and TERMALL, 3 layers")
    add("j2kw_vsc_segsym_pterm.j2k", j2k_codestream(
        p, style=VSC | SEGSYM | PTERM), "VSC, segmentation symbols, "
        "predictable termination")
    add("j2kw_all_styles.j2k", j2k_codestream(
        p, style=63, layers=2, cblk=(3, 3)), "every code-block style bit, "
        "2 layers")
    add("j2kw_poc.j2k", j2k_codestream(
        p, pocs=[(0, 0, 2, 2, 3, 1), (0, 0, 3, 3, 3, 4)], layers=3,
        style=TERMALL, precincts=prc), "POC (RLCP then CPRL), precincts")
    add("j2kw_sop_eph.j2k", j2k_codestream(
        p, sop=True, eph=True, layers=2, style=TERMALL, progression=2,
        precincts=prc), "SOP and EPH markers, RPCL")
    add("j2kw_ppm.j2k", j2k_codestream(
        p, ppm=True, sop=True, eph=True, tile=(11, 9)), "PPM packet "
        "headers, SOP and EPH, tiles")
    add("j2kw_ppt.j2k", j2k_codestream(
        p, ppt=True, eph=True, tile=(11, 9), layers=2, style=TERMALL,
        progression=3, precincts=prc), "PPT packet headers, PCRL, tiles")
    add("j2kw_tile_parts.j2k", j2k_codestream(
        p, tile=(11, 9), tile_parts=2, comment=b"tile-parts"),
        "two tile-parts per tile, interleaved; COM")
    add("j2kw_rgn.j2k", j2k_codestream(p, roi=(12, 0.5)),
        "RGN max-shift ROI")
    add("j2kw_coc.j2k", j2k_codestream(
        p, coc={1: ((3, 5), VSC | SEGSYM), 2: ((5, 2), TERMALL)}),
        "COC: code-block sizes and styles by component")
    twelve = [(c.astype(np.int64) << 4) | rng.integers(0, 16, c.shape)
              for c in p]
    add("j2kw_prec12.j2k", j2k_codestream(twelve, precision=12),
        "12-bit RGB")
    add("j2kw_mixed_prec.j2k", j2k_codestream(
        [twelve[0], p[1], p[2]], precision=[12, 8, 8], mct=False),
        "12-, 8- and 8-bit components (QCC)")
    add("j2kw_tiles_odd.j2k", j2k_codestream(p, tile=(7, 5), levels=3),
        "7x5 tiles, 3 levels")
    cs = j2k_codestream(p)
    for enumcs, what in ((17, "gray of 3 components"), (18, "sYCC"),
                         (14, "CIELab (taken as sRGB)")):
        add(f"j2kw_colr_{enumcs}.jp2", jp2_file(cs, colour=enumcs),
            f"colr {what}")
    add("j2kw_colr_icc.jp2", jp2_file(cs, colour=("icc", bytes(64))),
        "colr ICC profile")
    add("j2kw_no_colr.jp2", jp2_file(cs, colour=None), "no colr box")
    idx = rng.integers(0, 40, (19, 23))
    pal = rng.integers(0, 256, (32, 3))
    add("j2kw_palette.jp2", jp2_file(
        j2k_codestream([idx]), palette=pal,
        cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)]),
        "palette of 32, indices past it clipped")
    alpha = rng.integers(0, 256, (19, 23))
    add("j2kw_cdef_alpha_first.jp2", jp2_file(
        j2k_codestream([alpha] + p, mct=False),
        cdef=[(0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)]),
        "cdef: alpha first")
    add("j2kw_cdef_bgr.jp2", jp2_file(
        j2k_codestream(p[::-1], mct=False),
        cdef=[(0, 0, 3), (1, 0, 2), (2, 0, 1)]), "cdef: B, G, R")
    cmyk = p + [rng.integers(0, 256, (19, 23))]
    add("j2kw_colr_cmyk.jp2", jp2_file(j2k_codestream(cmyk, mct=False),
                                       colour=12), "colr CMYK", "refused")
    add("j2kw_colr_esycc.jp2", jp2_file(cs, colour=24), "colr e-sYCC",
        "refused")
    add("j2kw_prec6.j2k", j2k_codestream([c >> 2 for c in p], precision=6),
        "6-bit", "refused")
    add("j2kw_signed.j2k", j2k_codestream(
        [c.astype(np.int64) - 128 for c in p], signed=True), "signed",
        "refused")
    add("j2kw_subsampled.j2k", j2k_codestream(
        [p[0], p[1][::2, ::2], p[2][::2, ::2]],
        subsampling=[(1, 1), (2, 2), (2, 2)], mct=False),
        "chroma sub-sampled 2x2", "refused")
    add("j2kw_offset.j2k", j2k_codestream(p, offset=(3, 2)),
        "image offset", "refused")
    add("j2kw_gray_raw.j2k", j2k_codestream([p[0]]),
        "one component, no colour space", "refused")
    return out


def jpeg2000_ht_files(sources=None) -> Dict[str, Tuple[bytes, str, str,
                                                      str]]:
    """The committed high-throughput JPEG 2000 fixtures of this writer
    (`j2kh_*`): {file name: (bytes, format, variant, expect)}, as
    `jpeg2000_files`. 64x64 or smaller, but the 480x640 file the demo and
    the card's timing read. `sources`, a dict, receives the picture each
    lossless fixture must read back to in cv2 (RGB; gray repeated, 12 and
    16 bits shifted to 8, alpha dropped)."""
    rgb = _picture(19, 23, 41, 40)
    p = [rgb[..., c] for c in range(3)]
    rng = np.random.default_rng(42)
    prc = [(2, 2), (2, 2), (3, 3)]
    out = {}

    def add(name, data, variant, expect="pixels", source=None):
        fmt = {"jp2": "JPEG 2000 (JP2)", "jph": "JPEG 2000 (JPH)"}.get(
            name.rsplit(".", 1)[1], "JPEG 2000 (codestream)")
        out[name] = (data, fmt, variant, expect)
        if source is not None and sources is not None:
            source = np.asarray(source)
            sources[name] = np.repeat(source[..., None], 3, 2) \
                if source.ndim == 2 else source[..., :3]

    add("j2kh_cleanup.j2k", j2k_codestream(p, ht=True),
        "HT cleanup pass only, lossless", source=rgb)
    add("j2kh_sigprop.j2k", j2k_codestream(p, ht=True, ht_passes=2),
        "HT cleanup and SigProp (plane 0 of the cleanup's samples left out)")
    add("j2kh_magref.j2k", j2k_codestream(p, ht=True, ht_passes=3),
        "HT cleanup, SigProp and MagRef, lossless", source=rgb)
    add("j2kh_layers.j2k", j2k_codestream(
        p, ht=True, ht_passes=3, layers=2, ht_layers=[2, 1]),
        "HT, 2 layers: cleanup and SigProp, then MagRef", source=rgb)
    add("j2kh_termall_layers.j2k", j2k_codestream(
        p, ht=True, ht_passes=3, layers=2, ht_layers=[1, 2], style=TERMALL),
        "HT with TERMALL, 2 layers: cleanup, then SigProp and MagRef",
        source=rgb)
    add("j2kh_lossy_plane2.j2k", j2k_codestream(p, ht=True, ht_drop=2),
        "HT cleanup at bit-plane 2 (planes 0-1 left out)")
    add("j2kh_lossy_refined.j2k", j2k_codestream(
        p, ht=True, ht_passes=3, ht_drop=1),
        "HT cleanup at plane 2, SigProp and MagRef of plane 1")
    add("j2kh_irreversible.j2k", j2k_codestream(
        p, ht=True, ht_passes=3, ht_drop=1, irreversible=True),
        "HT, 9/7 and ICT, scalar expounded")
    add("j2kh_vsc_styles.j2k", j2k_codestream(
        p, ht=True, ht_passes=3, style=0x3F, cblk=(3, 3)),
        "HT with every other style bit (VSC among them), 8x8 blocks",
        source=rgb)
    add("j2kh_cblk_4x4.j2k", j2k_codestream(
        p, ht=True, ht_passes=3, cblk=(2, 2), levels=1),
        "HT, 4x4 code-blocks", source=rgb)
    big = _picture(45, 61, 43, 40)
    add("j2kh_cblk_64x64.j2k", j2k_codestream(
        [big[..., c] for c in range(3)], ht=True, ht_passes=3, cblk=(6, 6),
        levels=0), "HT, one 64x64 code-block over 45x61", source=big)
    add("j2kh_cblk_8x32.j2k", j2k_codestream(
        [big[..., c] for c in range(3)], ht=True, ht_passes=3, cblk=(3, 5),
        levels=3), "HT, 8x32 code-blocks, 3 levels", source=big)
    add("j2kh_tiles_rpcl.j2k", j2k_codestream(
        p, ht=True, tile=(11, 9), progression=2, precincts=prc),
        "HT, 11x9 tiles, precincts, RPCL", source=rgb)
    add("j2kh_no_cap.j2k", j2k_codestream(p, ht=True, cap=False),
        "HT without a CAP marker", source=rgb)
    add("j2kh_cpf.j2k", j2k_codestream(p, ht=True, cpf=True),
        "HT with a CPF marker", source=rgb)
    add("j2kh_gray.jp2", jp2_file(j2k_codestream(
        [p[1]], ht=True, ht_passes=3), colour=17), "HT gray", source=p[1])
    gray16 = rng.integers(0, 1 << 16, (17, 21))
    add("j2kh_gray16.jp2", jp2_file(j2k_codestream(
        [gray16], precision=16, ht=True, ht_passes=3), colour=17),
        "HT 16-bit gray", source=gray16 >> 8)
    twelve = [(c.astype(np.int64) << 4) | rng.integers(0, 16, c.shape)
              for c in p]
    add("j2kh_rgb12.j2k", j2k_codestream(twelve, precision=12, ht=True,
                                         ht_passes=3), "HT 12-bit RGB",
        source=np.stack(twelve, -1) >> 4)
    add("j2kh_rgba.jp2", jp2_file(j2k_codestream(
        p + [rng.integers(0, 256, (19, 23))], ht=True, ht_passes=3)),
        "HT RGBA", source=rgb)
    add("j2kh_jph.jph", jp2_file(j2k_codestream(p, ht=True, ht_passes=3),
                                 brand=b"jph "), "JPH file (brand jph)",
        source=rgb)
    add("j2kh_empty_refinement.j2k", j2k_codestream(
        p, ht=True, ht_passes=3, ht_damage="empty_refinement"),
        "HT, SigProp and MagRef of no bytes: the cleanup alone")
    add("j2kh_below_plane0.j2k", j2k_codestream(
        p, ht=True, ht_passes=3, ht_damage="below_plane_0"),
        "HT, SigProp and MagRef below plane 0: the cleanup alone",
        source=rgb)
    add("j2kh_mixed.j2k", j2k_codestream(p, ht=True, style=0x80),
        "mixed HT code-block style (0x80)", "refused")
    add("j2kh_roi.j2k", j2k_codestream(p, ht=True, roi=(3, 0.5)),
        "HT with RGN (ROI)", "refused")
    add("j2kh_passes4.j2k", j2k_codestream(p, ht=True, ht_passes=4),
        "HT, 4 coding passes", "refused")
    add("j2kh_placeholders.j2k", j2k_codestream(
        p, ht=True, ht_passes=6, layers=2, ht_layers=[3, 3]),
        "HT, a second set of passes (6) in layer 2", "refused")
    demo = _picture(480, 640, 44, 3)
    add("j2kh_480x640.jp2", jp2_file(j2k_codestream(
        [demo[..., c] for c in range(3)], ht=True, ht_passes=3,
        cblk=(6, 6), levels=5)), "480x640 HT: cleanup at plane 1, "
        "SigProp and MagRef, 64x64 blocks")
    return out
