// TIFF decoder of the host library, to the pixels cv2.imread (IMREAD_COLOR,
// BGR turned to RGB) gives the JAX package's loader: OpenCV 5.0 reads such
// a file through libtiff 4.7's RGBA interface (TIFFReadRGBAStrip and
// TIFFReadRGBATile, tif_getimage.c), whose conversions this file repeats.
//
// * The first page of a classic TIFF or a BigTIFF (version 43, 8-byte
//   counts and offsets), either byte order; strips or tiles;
//   PlanarConfiguration 1 or 2.
// * Compression none, PackBits, LZW (libtiff's codes, and the old style it
//   still reads: LSB first, the width growing one code later), Deflate
//   (zlib), CCITT modified Huffman, Group 3 (1-D and 2-D) and Group 4
//   (ccitt_host.cpp), and JPEG (7) by the host JPEG decoders of
//   jpeg_host.cpp, each strip or tile a stream of its own with JPEGTables
//   merged in front. FillOrder 2 reverses the bits of the raw data first
//   (under JPEG cv2 fails to read the strips, and this file refuses it).
// * Predictor 2 under LZW and Deflate (libtiff ignores it under none and
//   PackBits), on 8- and 16-bit samples.
// * Signed samples (SampleFormat 2) read as the unsigned bits they hold, as
//   libtiff's RGBA reader takes them.
// * Photometric min-is-white and min-is-black (1, 8 or 16 bits; a second
//   sample, alpha, dropped; in separate planes, 8 or 16 bits, the first
//   plane is the gray, neither inverted for min-is-white nor mapped by v >>
//   8 but by (v + 128) / 257, and an unassociated alpha as the first extra
//   plane premultiplies it), RGB (8 or 16 bits; a fourth sample dropped, but
//   an unassociated alpha premultiplies the colour first, (v * a + 127) /
//   255, as tif_getimage.c does), palette (1, 4 or 8 bits; a colour map with
//   any entry of 256 or more taken as 16 bits and shifted down by 8), and
//   YCbCr inside JPEG (libtiff asks libjpeg for RGB); a JPEG stream under
//   photometric RGB is not colour-converted. 16-bit samples become
//   (v + 128) / 257 in RGB, v >> 8 in gray (libtiff's own two maps).
// * CMYK (photometric 5, InkSet 1, four 8-bit samples contiguous or in
//   planes): k = 255 - K, each of R, G, B = k * (255 - C) / 255.
// * YCbCr outside JPEG (photometric 6, 8 bits): contiguous data units of
//   h x v luma samples and one Cb and Cr each (subsampling 1x1, 1x2, 2x1,
//   2x2, 4x1, 4x2, 4x4) or 1x1 planes, each pixel taking its unit's chroma
//   (libtiff's RGBA reader does not interpolate, and ignores
//   YCbCrPositioning), turned to RGB by TIFFYCbCrToRGBInit's tables from
//   YCbCrCoefficients and ReferenceBlackWhite, in its float and fixed-point
//   steps. Two libtiff quirks at 4x4 are repeated: a strip is read only to
//   its rows times a scanline size rounded down (the rest is 0), and a
//   clipped tile's rows of units are skipped as if its units were 10 bytes.
// * Orientation 1-4 as libtiff's RGBA reader turns a strip or tile: rows
//   flipped over the whole picture, columns within each tile (over the whole
//   width for strips). cv2 reads no TIFF of orientation 5-8: it fails after
//   the decode when it turns the picture, so those raise here too.
//
// What cv2 reads and this file does not (JPEG 2000 inside TIFF, CIELab,
// ThunderScan, SGILog, CMYK inside JPEG) raises ImageDecodeError naming it
// with "not ported". What cv2 refuses as well raises saying so: the
// compressions its libtiff is built without (LZMA, ZSTD, WebP, old-style
// JPEG, PixarLog, LERC), float samples, 2-bit gray or palette, 4-bit gray,
// more than four samples, CMYK of other than four 8-bit samples or InkSet 1,
// YCbCr of other subsamplings.

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
  uint64_t u64(long p) const {
    return le ? u32(p) | (uint64_t{u32(p + 4)} << 32)
              : (uint64_t{u32(p)} << 32) | u32(p + 4);
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
  int inkset = 1;
  uint32_t t4_options = 0;
  float luma[3] = {0.299f, 0.587f, 0.114f};  // YCbCrCoefficients
  float ref_bw[6] = {0.0f, 255.0f, 128.0f, 255.0f, 128.0f, 255.0f};
  std::vector<uint64_t> offsets, counts;
  std::vector<uint32_t> colormap;
  std::vector<uint8_t> jpeg_tables;
};

// the compressions cv2's libtiff reads and the port does not
const char* compression_name(int c) {
  switch (c) {
    case 32809: return "ThunderScan compression (32809)";
    case 32908: return "Pixar compression (32908)";
    case 34676: case 34677: return "SGILog compression";
    case 34712: return "JPEG 2000 compression (34712)";
    case 32947: return "NeXT compression (32947)";
    default: return nullptr;
  }
}

// the compressions cv2's libtiff is built without ("... compression support
// is not configured")
const char* unconfigured_name(int c) {
  switch (c) {
    case 6: return "old-style JPEG compression (6)";
    case 32909: return "PixarLog compression (32909)";
    case 34887: return "LERC compression (34887)";
    case 34925: return "LZMA compression (34925)";
    case 50000: return "ZSTD compression (50000)";
    case 50001: return "WebP compression (50001)";
    default: return nullptr;
  }
}

// the first IFD's fields and the checks of what the decoder reads
int parse(const uint8_t* d, long n, Tiff* t) {
  if (n < 8) return bad("file ends inside its header");
  t->le = d[0] == 'I';
  Reader r{d, t->le};
  const bool big = r.u16(2) == 43;  // BigTIFF: 8-byte counts and offsets
  if (big && (n < 16 || r.u16(4) != 8 || r.u16(6) != 0))
    return bad("a BigTIFF header of other than 8-byte offsets");
  const uint64_t ifd = big ? r.u64(8) : r.u32(4);
  const long head = big ? 8 : 2, entry = big ? 20 : 12, word = big ? 8 : 4;
  if (ifd < 8 || ifd + head > static_cast<uint64_t>(n))
    return bad("first IFD outside the file");
  const uint64_t entries = big ? r.u64(ifd) : r.u16(ifd);
  if (entries > 65535 || static_cast<long>(ifd) + head + entry *
                             static_cast<long>(entries) > n)
    return bad("IFD runs past the file");
  static const int kSize[] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8,
                              4, 0, 0, 8, 8, 8};
  for (long e = 0; e < static_cast<long>(entries); ++e) {
    const long p = static_cast<long>(ifd) + head + entry * e;
    const uint32_t tag = r.u16(p), type = r.u16(p + 2);
    const uint64_t count = big ? r.u64(p + 4) : r.u32(p + 4);
    if (type < 1 || type > 18 || kSize[type] == 0) continue;  // libtiff skips
    if (count > (1u << 28)) return bad("a tag of too many values");
    const long bytes = static_cast<long>(kSize[type]) * static_cast<long>(count);
    const long field = p + (big ? 12 : 8);
    const uint64_t at64 = bytes <= word ? field
                          : big ? r.u64(field) : r.u32(field);
    if (at64 > static_cast<uint64_t>(n) || static_cast<long>(at64) + bytes > n)
      return bad("a tag's values outside the file");
    const long at = static_cast<long>(at64);
    auto value = [&](uint64_t i) -> uint64_t {
      switch (type) {
        case 3: case 8: return r.u16(at + 2L * i);
        case 4: case 9: case 13: return r.u32(at + 4L * i);
        case 16: case 17: case 18: return r.u64(at + 8L * i);
        default: return d[at + i];
      }
    };
    auto values = [&]() {
      std::vector<uint64_t> v(count);
      for (uint64_t i = 0; i < count; ++i) v[i] = value(i);
      return v;
    };
    auto rationals = [&](float* out, uint64_t k) {  // (float) num / den
      for (uint64_t i = 0; i < k && i < count && (type == 5 || type == 10);
           ++i) {
        const uint32_t num = r.u32(at + 8L * i), den = r.u32(at + 8L * i + 4);
        out[i] = den == 0 ? 0.0f
                 : type == 5 ? static_cast<float>(num) / static_cast<float>(den)
                 : static_cast<float>(static_cast<int32_t>(num)) /
                       static_cast<float>(static_cast<int32_t>(den));
      }
    };
    if (count == 0) continue;
    switch (tag) {
      case 256: t->w = static_cast<uint32_t>(value(0)); break;
      case 257: t->h = static_cast<uint32_t>(value(0)); break;
      case 258: {
        t->bits = static_cast<int>(value(0));
        for (uint32_t i = 1; i < count; ++i)
          if (value(i) != value(0))
            return not_ported("samples of different bit depths");
        break;
      }
      case 259: t->compression = static_cast<int>(value(0)); break;
      case 292: t->t4_options = static_cast<uint32_t>(value(0)); break;
      case 332: t->inkset = static_cast<int>(value(0)); break;
      case 529: rationals(t->luma, 3); break;
      case 532: rationals(t->ref_bw, 6); break;
      case 262: t->photometric = static_cast<int>(value(0)); break;
      case 266: t->fill_order = static_cast<int>(value(0)); break;
      case 273: case 324: t->offsets = values(); t->tiled |= tag == 324; break;
      case 274: t->orientation = static_cast<int>(value(0)); break;
      case 277: t->spp = static_cast<int>(value(0)); break;
      case 278: t->rows_per_strip = static_cast<uint32_t>(value(0)); break;
      case 279: case 325: t->counts = values(); break;
      case 284: t->planar = static_cast<int>(value(0)); break;
      case 317: t->predictor = static_cast<int>(value(0)); break;
      case 320: {
        const auto v = values();
        t->colormap.assign(v.begin(), v.end());
        break;
      }
      case 322: t->tile_w = static_cast<uint32_t>(value(0)); break;
      case 323: t->tile_h = static_cast<uint32_t>(value(0)); break;
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
  if (const char* c = unconfigured_name(t->compression))
    return refused(std::string(c) + ", which cv2's libtiff is built without");
  const int c = t->compression;
  const bool ccitt = c == 2 || c == 3 || c == 4;
  if (c != 1 && c != 5 && c != 7 && c != 8 && c != 32946 && c != 32773 &&
      !ccitt)
    return refused("compression " + std::to_string(c));
  if (t->sample_format == 3)
    return refused("float samples (SampleFormat 3)");
  if (t->sample_format != 1 && t->sample_format != 2)
    return refused("SampleFormat " + std::to_string(t->sample_format));
  if (t->photometric < 0) return bad("no PhotometricInterpretation");
  if (t->fill_order == 2 && c == 7)
    return refused("FillOrder 2 under JPEG compression");
  if (ccitt && (t->bits != 1 || t->spp != 1 || t->photometric > 1))
    return refused("CCITT compression of other than 1-bit gray");
  switch (t->photometric) {
    case 0: case 1: case 2: case 3: break;
    case 5:
      if (t->inkset != 1) return refused("CMYK of InkSet " +
                                         std::to_string(t->inkset));
      if (t->bits != 8 || t->spp != 4)
        return refused("CMYK of other than four 8-bit samples");
      if (c == 7) return not_ported("CMYK inside JPEG");
      break;
    case 6:
      if (c == 7) {
        if (t->planar != 1) return refused("YCbCr JPEG in separate planes");
        break;
      }
      if (t->bits != 8 || t->spp != 3)
        return refused("YCbCr of other than three 8-bit samples");
      if (t->planar == 2 ? t->ycc_h != 1 || t->ycc_v != 1
                         : !((t->ycc_h == 1 || t->ycc_h == 2 || t->ycc_h == 4) &&
                             (t->ycc_v == 1 || t->ycc_v == 2 || t->ycc_v == 4) &&
                             t->ycc_v <= std::max(t->ycc_h, 2)))
        return refused("YCbCr subsampling " + std::to_string(t->ycc_h) + "x" +
                       std::to_string(t->ycc_v) + " in planar configuration " +
                       std::to_string(t->planar));
      if (t->predictor != 1 && (t->ycc_h != 1 || t->ycc_v != 1))
        return not_ported("a predictor on subsampled YCbCr");
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
  const int colour = (t->photometric == 2 || t->photometric == 6) ? 3
                     : t->photometric == 5 ? 4 : 1;
  if (t->spp < colour) return bad("fewer samples than the photometric needs");
  if (t->planar == 2 && colour == 1 && t->spp > 1 && t->bits == 1)
    return refused("1-bit gray with extra samples in separate planes");
  if (t->spp > colour + 1 && colour == 1 && t->planar == 1)
    return refused("gray with " + std::to_string(t->spp - 1) +
                   " extra samples");
  const int b = t->bits;
  bool ok;
  switch (t->photometric) {
    case 0: case 1: ok = b == 1 || b == 8 || b == 16; break;
    case 3: ok = (b == 1 || b == 4 || b == 8) && t->spp == 1; break;
    case 5: case 6: ok = b == 8; break;
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
  if (t.offsets[seg] > static_cast<uint64_t>(n) ||
      t.counts[seg] > static_cast<uint64_t>(n) - t.offsets[seg])
    return bad("a strip or tile outside the file");
  const long off = static_cast<long>(t.offsets[seg]);
  const long cnt = static_cast<long>(t.counts[seg]);
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
  const long raw_rows = t.tiled ? seg_h : rows;
  // contiguous YCbCr outside JPEG: rows of data units, each h x v luma
  // samples, then Cb and Cr
  const bool units = t.photometric == 6 && t.planar == 1;
  const int uh = units ? t.ycc_h : 1, uv = units ? t.ycc_v : 1;
  const long unit_bytes = units ? uh * uv + 2 : 0;
  const long units_across = (seg_w + uh - 1) / uh;
  const long row_bytes = units ? units_across * unit_bytes
                               : (seg_w * per * t.bits + 7) / 8;
  const long stored_rows = units ? (raw_rows + uv - 1) / uv : raw_rows;
  const long want = row_bytes * stored_rows;
  std::vector<uint8_t> src(d + off, d + off + cnt), buf(want);
  if (t.fill_order == 2)  // the bits of every byte reversed
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
    case 2: case 3: case 4:
      st = ccitt_decode(src.data(), cnt, t.compression, t.t4_options, seg_w,
                        raw_rows, buf.data());
      break;
    default: st = packbits_decode(src.data(), cnt, buf.data(), want);
  }
  if (st) return st;
  if (units) {  // each pixel's luma sample and its unit's chroma
    // libtiff's strip reader asks for rows rounded up to v times the
    // scanline size, (a row of units) / v rounded down: the bytes past that
    // stay 0
    if (!t.tiled) {
      const long asked = (rows + uv - 1) / uv * uv * (row_bytes / uv);
      if (asked < want) std::fill(buf.begin() + asked, buf.end(), 0);
    }
    // in a clipped tile each row of units after the first starts after the
    // units the pixels use and the rest of the row, the rest counted as
    // (pixels / h) units of h * 2 + 2 bytes by putcontig8bitYCbCr44tile
    long stride = row_bytes;
    if (t.tiled && cols < seg_w) {
      const long skip = (seg_w - cols) / uh;
      stride = (cols + uh - 1) / uh * unit_bytes +
               skip * (uh == 4 && uv == 4 ? 10 : unit_bytes);
    }
    for (long y = 0; y < rows; ++y)
      for (long x = 0; x < cols; ++x) {
        const long at = (y / uv) * stride + (x / uh) * unit_bytes;
        if (at + unit_bytes > want) return bad("YCbCr units past the tile");
        const uint8_t* u = buf.data() + at;
        uint16_t* q = s->at(static_cast<int>(y0 + y), static_cast<int>(x0 + x));
        q[0] = u[(y % uv) * uh + x % uh];
        q[1] = u[uh * uv];
        q[2] = u[uh * uv + 1];
      }
    return kOk;
  }
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
  if (t.tiled && cols < seg_w && t.photometric <= 1 && bytes > 0 &&
      t.planar == 1)
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

// libtiff's TIFFYCbCrToRGBInit and TIFFYCbCrtoRGB (tif_color.c), in the
// same float and fixed-point steps
struct Ycc {
  static constexpr int kShift = 16;
  static constexpr int32_t kHalf = 1 << (kShift - 1);
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], y_tab[256];
  static int32_t fix(float x) {
    return static_cast<int32_t>(x * static_cast<float>(1L << kShift) + 0.5);
  }
  static float clampf(float f, float lo, float hi) {
    return f < lo ? lo : f > hi ? hi : f;
  }
  // Code2V(c, RB, RW, CR), then CLAMPw to +-128 * 32 and truncated
  static int32_t code2v(int c, float rb, float rw, float cr) {
    const float den = (rw - rb != 0) ? (rw - rb) : 1.0f;
    const float v = static_cast<float>(c - static_cast<int32_t>(rb)) * cr / den;
    return static_cast<int32_t>(clampf(v, -128.0f * 32, 128.0f * 32));
  }
  void init(const float* luma, const float* rbw) {
    const float f1 = 2 - 2 * luma[0];
    const int32_t d1 = fix(clampf(f1, 0.0f, 2.0f));
    const float f2 = luma[0] * f1 / luma[1];
    const int32_t d2 = -fix(clampf(f2, 0.0f, 2.0f));
    const float f3 = 2 - 2 * luma[2];
    const int32_t d3 = fix(clampf(f3, 0.0f, 2.0f));
    const float f4 = luma[2] * f3 / luma[1];
    const int32_t d4 = -fix(clampf(f4, 0.0f, 2.0f));
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      const int32_t cr = code2v(x, rbw[4] - 128.0f, rbw[5] - 128.0f, 127);
      const int32_t cb = code2v(x, rbw[2] - 128.0f, rbw[3] - 128.0f, 127);
      cr_r[i] = (d1 * cr + kHalf) >> kShift;
      cb_b[i] = (d3 * cb + kHalf) >> kShift;
      cr_g[i] = d2 * cr;
      cb_g[i] = d4 * cb + kHalf;
      y_tab[i] = code2v(x + 128, rbw[0], rbw[1], 255);
    }
  }
  void rgb(int y, int cb, int cr, uint8_t* o) const {
    auto clamp = [](int32_t v) {
      return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
    };
    o[0] = clamp(y_tab[y] + cr_r[cr]);
    o[1] = clamp(y_tab[y] + ((cb_g[cb] + cr_g[cr]) >> kShift));
    o[2] = clamp(y_tab[y] + cb_b[cb]);
  }
};

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
  // gray in separate planes: libtiff's RGB plane readers, with the gray
  // plane as all three
  const bool gray_planes = t.planar == 2 && t.photometric <= 1 && t.spp > 1;
  const bool gray_alpha = gray_planes && t.extra == 2;
  Ycc ycc;
  if (t.photometric == 6 && t.compression != 7) ycc.init(t.luma, t.ref_bw);
  auto to8 = [&](uint32_t v) -> int {  // RGB samples
    return b == 16 ? static_cast<int>((v + 128) / 257) : static_cast<int>(v);
  };
  const int range = b == 16 ? 255 : (1 << b) - 1;
  for (int y = 0; y < s.h; ++y)
    for (int x = 0; x < s.w; ++x) {
      const uint16_t* q = s.at(y, x);
      uint8_t* o = out + (static_cast<long>(y) * s.w + x) * 3;
      if (gray_planes) {
        int v = to8(q[0]);
        if (gray_alpha) v = (v * to8(q[1]) + 127) / 255;
        o[0] = o[1] = o[2] = static_cast<uint8_t>(v);
        continue;
      }
      switch (t.photometric) {
        case 5: {
          const int k = 255 - q[3];
          for (int c = 0; c < 3; ++c)
            o[c] = static_cast<uint8_t>(k * (255 - q[c]) / 255);
          break;
        }
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
        case 6:
          if (t.compression != 7) {  // the JPEG strips came as RGB
            ycc.rgb(q[0], q[1], q[2], o);
            break;
          }
          [[fallthrough]];
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
