// TIFF decoder of the host library, to the pixels cv2.imread (IMREAD_COLOR,
// BGR turned to RGB) gives the JAX package's loader: OpenCV 5.0 reads such
// a file through libtiff 4.7's RGBA interface (TIFFReadRGBAStrip and
// TIFFReadRGBATile, tif_getimage.c), whose conversions this file repeats.
//
// * The first page of a classic TIFF, either byte order; strips or tiles;
//   PlanarConfiguration 1 or 2.
// * Compression none, PackBits, LZW (libtiff's codes, and the old style it
//   still reads: LSB first, the width growing one code later), Deflate
//   (zlib), and JPEG (7) by the host JPEG decoders of jpeg_host.cpp, each
//   strip or tile a stream of its own with JPEGTables merged in front.
//   FillOrder 2 reverses the bits of the raw data first (not under JPEG).
// * Predictor 2 under LZW and Deflate (libtiff ignores it under none and
//   PackBits), on 8- and 16-bit samples.
// * Photometric min-is-white and min-is-black (1, 8 or 16 bits; a second
//   sample, alpha, dropped), RGB (8 or 16 bits; a fourth sample dropped, but
//   an unassociated alpha premultiplies the colour first, (v * a + 127) /
//   255, as tif_getimage.c does), palette (1, 4 or 8 bits; a colour map with
//   any entry of 256 or more taken as 16 bits and shifted down by 8), and
//   YCbCr inside JPEG (libtiff asks libjpeg for RGB); a JPEG stream under
//   photometric RGB is not colour-converted. 16-bit samples become
//   (v + 128) / 257 in RGB, v >> 8 in gray (libtiff's own two maps).
// * Orientation 1-4 as libtiff's RGBA reader turns a strip or tile: rows
//   flipped over the whole picture, columns within each tile (over the whole
//   width for strips). cv2 reads no TIFF of orientation 5-8: it fails after
//   the decode when it turns the picture, so those raise here too.
//
// What cv2 reads and this file does not (CCITT, LZMA, ZSTD, WebP or JPEG
// 2000 inside TIFF, old-style JPEG, float and signed samples, CMYK, CIELab,
// YCbCr outside JPEG, BigTIFF) raises ImageDecodeError naming it with "not
// ported". What cv2 refuses as well (2-bit gray or palette, 4-bit gray,
// more than four samples) raises too.

#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "host.h"

namespace sdt {

namespace {

int bad(const std::string& what) {
  set_error("TIFF: damaged data: " + what);
  return kCorrupt;
}

int not_ported(const std::string& what) {
  set_error("TIFF: " + what + " not ported (cv2 reads it)");
  return kUnsupported;
}

int refused(const std::string& what) {
  set_error("TIFF: " + what + " (cv2 refuses it too)");
  return kUnsupported;
}

struct Reader {
  const uint8_t* d;
  bool le;
  uint32_t u16(long p) const {
    return le ? d[p] | (d[p + 1] << 8) : (d[p] << 8) | d[p + 1];
  }
  uint32_t u32(long p) const {
    return le ? u16(p) | (u16(p + 2) << 16) : (u16(p) << 16) | u16(p + 2);
  }
};

struct Tiff {
  bool le = true;
  uint32_t w = 0, h = 0;
  int bits = 1, spp = 1, compression = 1, photometric = -1, planar = 1,
      predictor = 1, orientation = 1, sample_format = 1, fill_order = 1;
  int extra = -1;  // ExtraSamples' first value, -1 where there is none
  uint32_t rows_per_strip = 0xFFFFFFFFu;
  bool tiled = false;
  uint32_t tile_w = 0, tile_h = 0;
  int ycc_h = 2, ycc_v = 2;
  std::vector<uint32_t> offsets, counts, colormap;
  std::vector<uint8_t> jpeg_tables;
};

const char* compression_name(int c) {
  switch (c) {
    case 2: return "CCITT modified Huffman compression (2)";
    case 3: return "CCITT Group 3 compression (3)";
    case 4: return "CCITT Group 4 compression (4)";
    case 6: return "old-style JPEG compression (6)";
    case 32809: return "ThunderScan compression (32809)";
    case 32908: case 32909: return "Pixar compression";
    case 34676: case 34677: return "SGILog compression";
    case 34712: return "JPEG 2000 compression (34712)";
    case 34925: return "LZMA compression (34925)";
    case 50000: return "ZSTD compression (50000)";
    case 50001: return "WebP compression (50001)";
    case 34887: return "LERC compression (34887)";
    case 32947: return "NeXT compression (32947)";
    default: return nullptr;
  }
}

// the first IFD's fields and the checks of what the decoder reads
int parse(const uint8_t* d, long n, Tiff* t) {
  if (n < 8) return bad("file ends inside its header");
  t->le = d[0] == 'I';
  Reader r{d, t->le};
  if (r.u16(2) == 43) return not_ported("BigTIFF");
  const uint32_t ifd = r.u32(4);
  if (ifd < 8 || ifd + 2L > n) return bad("first IFD outside the file");
  const int entries = static_cast<int>(r.u16(ifd));
  if (ifd + 2L + 12L * entries > n) return bad("IFD runs past the file");
  static const int kSize[] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8};
  for (int e = 0; e < entries; ++e) {
    const long p = ifd + 2 + 12L * e;
    const uint32_t tag = r.u16(p), type = r.u16(p + 2), count = r.u32(p + 4);
    if (type < 1 || type > 12) continue;  // a type libtiff skips
    const long bytes = static_cast<long>(kSize[type]) * count;
    if (count > (1u << 28)) return bad("a tag of too many values");
    const long at = bytes <= 4 ? p + 8 : static_cast<long>(r.u32(p + 8));
    if (at < 0 || at + bytes > n) return bad("a tag's values outside the file");
    auto value = [&](uint32_t i) -> uint32_t {
      switch (type) {
        case 3: case 8: return r.u16(at + 2L * i);
        case 4: case 9: return r.u32(at + 4L * i);
        default: return d[at + i];
      }
    };
    auto values = [&]() {
      std::vector<uint32_t> v(count);
      for (uint32_t i = 0; i < count; ++i) v[i] = value(i);
      return v;
    };
    if (count == 0) continue;
    switch (tag) {
      case 256: t->w = value(0); break;
      case 257: t->h = value(0); break;
      case 258: {
        t->bits = static_cast<int>(value(0));
        for (uint32_t i = 1; i < count; ++i)
          if (value(i) != value(0))
            return not_ported("samples of different bit depths");
        break;
      }
      case 259: t->compression = static_cast<int>(value(0)); break;
      case 262: t->photometric = static_cast<int>(value(0)); break;
      case 266: t->fill_order = static_cast<int>(value(0)); break;
      case 273: case 324: t->offsets = values(); t->tiled |= tag == 324; break;
      case 274: t->orientation = static_cast<int>(value(0)); break;
      case 277: t->spp = static_cast<int>(value(0)); break;
      case 278: t->rows_per_strip = value(0); break;
      case 279: case 325: t->counts = values(); break;
      case 284: t->planar = static_cast<int>(value(0)); break;
      case 317: t->predictor = static_cast<int>(value(0)); break;
      case 320: t->colormap = values(); break;
      case 322: t->tile_w = value(0); break;
      case 323: t->tile_h = value(0); break;
      case 338: t->extra = static_cast<int>(value(0)); break;
      case 339: t->sample_format = static_cast<int>(value(0)); break;
      case 347: t->jpeg_tables.assign(d + at, d + at + bytes); break;
      case 530:
        t->ycc_h = static_cast<int>(value(0));
        t->ycc_v = count > 1 ? static_cast<int>(value(1)) : t->ycc_h;
        break;
      default: break;
    }
  }
  if (t->w == 0 || t->h == 0) return bad("no image size");
  if (t->w > 1u << 24 || t->h > 1u << 24) return bad("an image size too large");
  if (const char* c = compression_name(t->compression)) return not_ported(c);
  if (t->compression != 1 && t->compression != 5 && t->compression != 7 &&
      t->compression != 8 && t->compression != 32946 &&
      t->compression != 32773)
    return refused("compression " + std::to_string(t->compression));
  if (t->sample_format != 1)
    return not_ported(t->sample_format == 3 ? "float samples (SampleFormat 3)"
                      : t->sample_format == 2 ? "signed samples (SampleFormat 2)"
                      : "SampleFormat " + std::to_string(t->sample_format));
  if (t->photometric < 0) return bad("no PhotometricInterpretation");
  if (t->fill_order == 2 && t->compression != 1)
    return not_ported("FillOrder 2 under compression " +
                      std::to_string(t->compression));
  switch (t->photometric) {
    case 0: case 1: case 2: case 3: break;
    case 5: return not_ported("CMYK (photometric 5)");
    case 6:
      if (t->compression != 7) return not_ported("YCbCr outside JPEG");
      if (t->planar != 1) return refused("YCbCr JPEG in separate planes");
      break;
    case 8: case 9: case 10: return not_ported("CIELab (photometric " +
                                               std::to_string(t->photometric) +
                                               ")");
    default:
      return not_ported("photometric " + std::to_string(t->photometric));
  }
  if (t->spp < 1 || t->spp > 4) return refused(std::to_string(t->spp) +
                                               " samples per pixel");
  if (t->planar != 1 && t->planar != 2) return bad("bad PlanarConfiguration");
  const int colour = (t->photometric == 2 || t->photometric == 6) ? 3 : 1;
  if (t->spp < colour) return bad("fewer samples than the photometric needs");
  if (t->planar == 2 && colour == 1 && t->spp > 1)
    return not_ported("gray with extra samples in separate planes");
  if (t->spp > colour + 1 && colour == 1)
    return refused("gray with " + std::to_string(t->spp - 1) +
                   " extra samples");
  const int b = t->bits;
  bool ok;
  switch (t->photometric) {
    case 0: case 1: ok = b == 1 || b == 8 || b == 16; break;
    case 3: ok = (b == 1 || b == 4 || b == 8) && t->spp == 1; break;
    default: ok = b == 8 || b == 16; break;
  }
  if (t->compression == 7 && b != 8) ok = false;
  if (!ok)
    return refused(std::to_string(b) + "-bit samples under photometric " +
                   std::to_string(t->photometric));
  if (t->photometric == 3) {
    if (t->colormap.size() != 3u << b) return bad("a colour map of the wrong size");
  }
  if (t->predictor != 1) {
    const bool coded = t->compression == 5 || t->compression == 8 ||
                       t->compression == 32946;
    if (coded && t->predictor == 3) return not_ported("floating-point predictor");
    if (coded && t->predictor != 2) return bad("unknown predictor");
    if (coded && b < 8) return bad("predictor 2 on samples of under 8 bits");
  }
  if (t->tiled) {
    if (t->tile_w == 0 || t->tile_h == 0 || t->tile_w % 16 || t->tile_h % 16 ||
        t->tile_w > 1u << 16 || t->tile_h > 1u << 16)
      return bad("bad tile size");
  } else if (t->rows_per_strip == 0) {
    return bad("RowsPerStrip of 0");
  }
  const long across = t->tiled ? (t->w + t->tile_w - 1) / t->tile_w : 1;
  const long down = t->tiled ? (t->h + t->tile_h - 1) / t->tile_h
                             : (t->h + std::min(t->rows_per_strip, t->h) - 1) /
                                   std::min(t->rows_per_strip, t->h);
  const long segments = across * down * (t->planar == 2 ? t->spp : 1);
  if (static_cast<long>(t->offsets.size()) < segments ||
      static_cast<long>(t->counts.size()) < segments)
    return bad("fewer strip or tile offsets than the picture needs");
  if (t->orientation >= 5 && t->orientation <= 8)
    return refused("orientation " + std::to_string(t->orientation) +
                   ", which cv2.imread fails to turn");
  return kOk;
}

// --------------------------------------------------------------- codecs

// libtiff's LZWDecode (or LZWDecodeCompat for the old style): the codes of
// src into out, until out is full or the end code
int lzw_decode(const uint8_t* src, long len, uint8_t* out, long want) {
  const bool old = len >= 2 && src[0] == 0 && (src[1] & 1);
  struct Entry {
    int prefix, length;
    uint8_t first, last;
  };
  std::vector<Entry> tab(4096);
  for (int i = 0; i < 256; ++i) tab[i] = {-1, 1, uint8_t(i), uint8_t(i)};
  int nbits = 9, free_ent = 258, old_code = -1;
  long pos = 0, filled = 0;
  uint64_t acc = 0;
  int have = 0;
  std::vector<uint8_t> str;
  auto next = [&]() -> int {
    while (have < nbits) {
      if (pos >= len) return -1;
      if (old) {
        acc |= static_cast<uint64_t>(src[pos++]) << have;
      } else {
        acc = (acc << 8) | src[pos++];
      }
      have += 8;
    }
    int code;
    if (old) {
      code = static_cast<int>(acc & ((1u << nbits) - 1));
      acc >>= nbits;
    } else {
      code = static_cast<int>((acc >> (have - nbits)) & ((1u << nbits) - 1));
    }
    have -= nbits;
    if (!old) acc &= (have ? ((uint64_t{1} << have) - 1) : 0);
    return code;
  };
  auto emit = [&](int code) {  // the string of code, at out + filled
    const int l = tab[code].length;
    const long room = want - filled;
    int c = code;
    for (int k = l - 1; k >= 0; --k) {
      if (k < room) out[filled + k] = tab[c].last;
      c = tab[c].prefix;
    }
    filled += std::min<long>(l, room);
  };
  while (filled < want) {
    const int code = next();
    if (code < 0) return bad("LZW data ends before the strip does");
    if (code == 257) break;
    if (code == 256) {
      nbits = 9;
      free_ent = 258;
      int c;
      do c = next(); while (c == 256);
      if (c < 0) return bad("LZW data ends before the strip does");
      if (c == 257) break;
      if (c > 255) return bad("corrupted LZW table");
      emit(c);
      old_code = c;
      continue;
    }
    if (old_code < 0) return bad("LZW data does not start with a clear code");
    if (code > free_ent || free_ent >= 4096)
      return bad("corrupted LZW table");
    const int base = code == free_ent ? old_code : code;
    tab[free_ent] = {old_code, tab[old_code].length + 1, tab[old_code].first,
                     tab[base].first};
    ++free_ent;
    emit(code);
    old_code = code;
    const int limit = (1 << nbits) - (old ? 0 : 1);
    if (free_ent >= limit && nbits < 12) ++nbits;
  }
  if (filled < want) return bad("LZW data ends before the strip does");
  return kOk;
}

int inflate_segment(const uint8_t* src, long len, uint8_t* out, long want) {
  z_stream z;
  std::memset(&z, 0, sizeof(z));
  if (inflateInit(&z) != Z_OK) return bad("zlib init");
  z.next_in = const_cast<Bytef*>(src);
  z.avail_in = static_cast<uInt>(len);
  z.next_out = out;
  z.avail_out = static_cast<uInt>(want);
  int st;
  do st = inflate(&z, Z_NO_FLUSH); while (st == Z_OK && z.avail_out > 0);
  const long got = want - z.avail_out;
  inflateEnd(&z);
  if (st != Z_OK && st != Z_STREAM_END && !(st == Z_BUF_ERROR && got == want))
    return bad("Deflate data: " + std::string(z.msg ? z.msg : "zlib error"));
  if (got < want) return bad("Deflate data ends before the strip does");
  return kOk;
}

int packbits_decode(const uint8_t* src, long len, uint8_t* out, long want) {
  long p = 0, o = 0;
  while (p < len && o < want) {
    const int c = static_cast<int8_t>(src[p++]);
    if (c < 0) {
      if (c == -128) continue;
      if (p >= len) break;
      const long run = std::min<long>(1 - c, want - o);
      std::memset(out + o, src[p++], run);
      o += run;
    } else {
      const long run = std::min<long>(std::min<long>(c + 1, len - p), want - o);
      std::memcpy(out + o, src + p, run);
      p += c + 1;
      o += run;
    }
  }
  if (o < want) return bad("PackBits data ends before the strip does");
  return kOk;
}

// ------------------------------------------------------------- decode

// the samples of the picture, before the photometric maps: (h, w, spp)
struct Samples {
  int h, w, spp;
  std::vector<uint16_t> v;
  uint16_t* at(int y, int x) {
    return v.data() + (static_cast<long>(y) * w + x) * spp;
  }
};

// one strip or tile (index seg, of plane `plane`) into the samples
int read_segment(const uint8_t* d, long n, const Tiff& t, long seg, int plane,
                 long y0, long x0, long seg_h, long seg_w, Samples* s) {
  const long off = t.offsets[seg], cnt = t.counts[seg];
  if (off < 0 || off > n || cnt < 0 || off + cnt > n)
    return bad("a strip or tile outside the file");
  const int per = t.planar == 2 ? 1 : t.spp;  // samples in the segment
  const long rows = std::min<long>(seg_h, t.h - y0);
  const long cols = std::min<long>(seg_w, t.w - x0);
  if (t.compression == 7) {
    std::vector<uint8_t> stream;
    if (t.jpeg_tables.size() > 4) {  // SOI .. tables .. (EOI) + (SOI) ..
      stream.assign(t.jpeg_tables.begin(), t.jpeg_tables.end() - 2);
      if (cnt < 2) return bad("an empty JPEG strip");
      stream.insert(stream.end(), d + off + 2, d + off + cnt);
    } else {
      stream.assign(d + off, d + off + cnt);
    }
    std::vector<uint8_t> px;
    int jh, jw, nc, h0, v0;
    const bool ycc = t.photometric == 6;
    const int st = jpeg_decode_tiff(stream.data(), static_cast<long>(stream.size()),
                                    ycc, &px, &jh, &jw, &nc, &h0, &v0);
    if (st) return st;
    if (nc != per || h0 != (ycc ? t.ycc_h : 1) || v0 != (ycc ? t.ycc_v : 1))
      return bad("improper JPEG sampling factors or components");
    if (jw < cols || jh < rows) return bad("a JPEG strip smaller than its place");
    for (long y = 0; y < rows; ++y)
      for (long x = 0; x < cols; ++x) {
        const uint8_t* p = px.data() + (y * jw + x) * per;
        uint16_t* q = s->at(static_cast<int>(y0 + y), static_cast<int>(x0 + x));
        for (int k = 0; k < per; ++k) q[per == 1 ? plane : k] = p[k];
      }
    return kOk;
  }
  const long row_bytes = (seg_w * per * t.bits + 7) / 8;
  const long raw_rows = t.tiled ? seg_h : rows;
  const long want = row_bytes * raw_rows;
  std::vector<uint8_t> src(d + off, d + off + cnt), buf(want);
  if (t.fill_order == 2)  // parse() lets it through uncompressed only
    for (auto& b : src) {
      b = static_cast<uint8_t>(((b * 0x0802LU & 0x22110LU) |
                                (b * 0x8020LU & 0x88440LU)) * 0x10101LU >> 16);
    }
  int st = kOk;
  switch (t.compression) {
    case 1:
      if (cnt < want) return bad("a strip or tile shorter than its rows");
      std::memcpy(buf.data(), src.data(), want);
      break;
    case 5: st = lzw_decode(src.data(), cnt, buf.data(), want); break;
    case 8: case 32946:
      st = inflate_segment(src.data(), cnt, buf.data(), want);
      break;
    default: st = packbits_decode(src.data(), cnt, buf.data(), want);
  }
  if (st) return st;
  const bool predict = t.predictor == 2 && (t.compression == 5 ||
                                            t.compression == 8 ||
                                            t.compression == 32946);
  const long nsamp = seg_w * per;
  if (t.bits == 16) {  // to native (little-endian) order, as libtiff swaps
    for (long i = 0; i < raw_rows * nsamp; ++i) {
      uint8_t* b = buf.data() + 2 * i;
      if (!t.le) std::swap(b[0], b[1]);
    }
  }
  if (predict)
    for (long y = 0; y < raw_rows; ++y) {
      uint8_t* row = buf.data() + y * row_bytes;
      for (long i = per; i < nsamp; ++i) {
        if (t.bits == 16) {
          const int v = (row[2 * i] | (row[2 * i + 1] << 8)) +
                        (row[2 * i - 2 * per] | (row[2 * i - 2 * per + 1] << 8));
          row[2 * i] = static_cast<uint8_t>(v);
          row[2 * i + 1] = static_cast<uint8_t>(v >> 8);
        } else {
          row[i] = static_cast<uint8_t>(row[i] + row[i - per]);
        }
      }
    }
  // libtiff's gray tile readers (putgreytile, putagreytile,
  // put16bitbwtile) step over the clipped part of a rightmost tile by its
  // pixel count in bytes: each row of such a tile after the first starts
  // there, at npix * samples * bytes + (tile width - npix)
  const int bytes = t.bits / 8;
  long stride = row_bytes;
  if (t.tiled && cols < seg_w && t.photometric <= 1 && bytes > 0)
    stride = cols * per * bytes + (seg_w - cols);
  for (long y = 0; y < rows; ++y) {
    const uint8_t* row = buf.data() + y * stride;
    if (t.bits == 16) {
      for (long x = 0; x < cols; ++x) {
        uint16_t* q = s->at(static_cast<int>(y0 + y), static_cast<int>(x0 + x));
        for (int k = 0; k < per; ++k) {
          const long i = 2 * (x * per + k);
          q[per == 1 ? plane : k] = static_cast<uint16_t>(row[i] | (row[i + 1] << 8));
        }
      }
      continue;
    }
    for (long x = 0; x < cols; ++x) {
      uint16_t* q = s->at(static_cast<int>(y0 + y), static_cast<int>(x0 + x));
      for (int k = 0; k < per; ++k) {
        const long i = x * per + k;
        int v;
        if (t.bits == 8) {
          v = row[i];
        } else {
          const long bit = i * t.bits;
          v = (row[bit >> 3] >> (8 - t.bits - (bit & 7))) & ((1 << t.bits) - 1);
        }
        q[per == 1 ? plane : k] = static_cast<uint16_t>(v);
      }
    }
  }
  return kOk;
}

int decode(const uint8_t* d, long n, const Tiff& t, uint8_t* out) {
  Samples s{static_cast<int>(t.h), static_cast<int>(t.w), t.spp, {}};
  s.v.assign(static_cast<size_t>(t.h) * t.w * t.spp, 0);
  const long sw = t.tiled ? t.tile_w : t.w;
  const long sh = t.tiled ? t.tile_h : std::min(t.rows_per_strip, t.h);
  const long across = (t.w + sw - 1) / sw, down = (t.h + sh - 1) / sh;
  const int planes = t.planar == 2 ? t.spp : 1;
  long seg = 0;
  for (int p = 0; p < planes; ++p)
    for (long by = 0; by < down; ++by)
      for (long bx = 0; bx < across; ++bx, ++seg) {
        const int st = read_segment(d, n, t, seg, p, by * sh, bx * sw, sh, sw,
                                    &s);
        if (st) return st;
      }
  // the photometric maps of tif_getimage.c
  const int b = t.bits;
  uint8_t cmap[3][256];
  if (t.photometric == 3) {
    const long entries = 1L << b;
    bool wide = false;
    for (long i = 0; i < 3 * entries; ++i) wide |= t.colormap[i] >= 256;
    for (int c = 0; c < 3; ++c)
      for (long i = 0; i < entries; ++i) {
        const uint32_t v = t.colormap[c * entries + i];
        cmap[c][i] = static_cast<uint8_t>(wide ? v >> 8 : v);
      }
  }
  const bool unassoc = t.extra == 2 && t.spp == 4 && t.photometric == 2;
  auto to8 = [&](uint32_t v) -> int {  // RGB samples
    return b == 16 ? static_cast<int>((v + 128) / 257) : static_cast<int>(v);
  };
  const int range = b == 16 ? 255 : (1 << b) - 1;
  for (int y = 0; y < s.h; ++y)
    for (int x = 0; x < s.w; ++x) {
      const uint16_t* q = s.at(y, x);
      uint8_t* o = out + (static_cast<long>(y) * s.w + x) * 3;
      switch (t.photometric) {
        case 0: case 1: {
          const int v = b == 16 ? q[0] >> 8 : q[0];
          const int g = t.photometric == 1 ? v * 255 / range
                                           : (range - v) * 255 / range;
          o[0] = o[1] = o[2] = static_cast<uint8_t>(g);
          break;
        }
        case 3:
          for (int c = 0; c < 3; ++c) o[c] = cmap[c][q[0]];
          break;
        default: {
          if (unassoc) {
            const int a = to8(q[3]);
            for (int c = 0; c < 3; ++c)
              o[c] = static_cast<uint8_t>((to8(q[c]) * a + 127) / 255);
          } else {
            for (int c = 0; c < 3; ++c) o[c] = static_cast<uint8_t>(to8(q[c]));
          }
        }
      }
    }
  // orientation 2-4: columns flipped within each tile (the whole width of a
  // strip), rows over the picture
  const int o = t.orientation;
  if (o == 2 || o == 3) {
    for (int y = 0; y < s.h; ++y) {
      uint8_t* row = out + static_cast<long>(y) * s.w * 3;
      for (long x0 = 0; x0 < s.w; x0 += sw) {
        long l = x0, r = std::min<long>(x0 + sw, s.w) - 1;
        for (; l < r; ++l, --r)
          for (int c = 0; c < 3; ++c) std::swap(row[3 * l + c], row[3 * r + c]);
      }
    }
  }
  if (o == 3 || o == 4) {
    const long rb = static_cast<long>(s.w) * 3;
    std::vector<uint8_t> tmp(rb);
    for (int y = 0; y < s.h / 2; ++y) {
      uint8_t* a = out + y * rb;
      uint8_t* z = out + (s.h - 1 - y) * rb;
      std::memcpy(tmp.data(), a, rb);
      std::memcpy(a, z, rb);
      std::memcpy(z, tmp.data(), rb);
    }
  }
  return kOk;
}

}  // namespace

bool is_tiff(const uint8_t* d, long n) {
  return n >= 4 && ((d[0] == 'I' && d[1] == 'I' && d[2] == 42 && d[3] == 0) ||
                    (d[0] == 'M' && d[1] == 'M' && d[2] == 0 && d[3] == 42) ||
                    (d[0] == 'I' && d[1] == 'I' && d[2] == 43 && d[3] == 0) ||
                    (d[0] == 'M' && d[1] == 'M' && d[2] == 0 && d[3] == 43));
}

int tiff_info(const uint8_t* d, long n, int* h, int* w) {
  Tiff t;
  const int st = parse(d, n, &t);
  if (st) return st;
  *h = static_cast<int>(t.h);
  *w = static_cast<int>(t.w);
  return kOk;
}

int tiff_decode(const uint8_t* d, long n, uint8_t* out, int h, int w) {
  Tiff t;
  const int st = parse(d, n, &t);
  if (st) return st;
  if (static_cast<int>(t.h) != h || static_cast<int>(t.w) != w) {
    set_error("TIFF size differs from the size asked for");
    return kSizeMismatch;
  }
  return decode(d, n, t, out);
}

}  // namespace sdt
