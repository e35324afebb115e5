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
//   PackBits), on 8- and 16-bit samples, summed as tif_predict.c sums it:
//   the decoded bytes in rows of libtiff's row size (the scanline size in
//   strips, a row of tile samples in tiles), with a stride of the samples
//   per pixel; over YCbCr data units too, where a row that does not divide
//   the bytes, or is not whole pixels, leaves them undifferenced (libtiff
//   fails there and its RGBA reader goes on with the bytes).
// * ThunderScan (32809, tif_thunder.c: runs, 2- and 3-bit deltas, raw
//   pixels) in strips; its tiles read as zero samples (libtiff has no tile
//   decoder for it). SGILog (34676 and 34677, sgilog_host.cpp): LogL to
//   8-bit gray, LogLuv 32 and 24 to 8-bit RGB, as tif_luv.c gives them to
//   the RGBA reader.
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
//   another photometric is not colour-converted. 16-bit samples become
//   (v + 128) / 257 in RGB, v >> 8 in gray (libtiff's own two maps).
// * CMYK (photometric 5, InkSet 1, four 8-bit samples contiguous or in
//   planes, inside JPEG too, the components as they are coded, whatever an
//   Adobe marker says): k = 255 - K, each of R, G, B = k * (255 - C) / 255.
// * YCbCr outside JPEG (photometric 6, 8 bits): contiguous data units of
//   h x v luma samples and one Cb and Cr each (subsampling 1x1, 1x2, 2x1,
//   2x2, 4x1, 4x2, 4x4) or 1x1 planes, each pixel taking its unit's chroma
//   (libtiff's RGBA reader does not interpolate, and ignores
//   YCbCrPositioning), turned to RGB by TIFFYCbCrToRGBInit's tables from
//   YCbCrCoefficients and ReferenceBlackWhite, in its float and fixed-point
//   steps. Two libtiff quirks at 4x4 are repeated: a strip is read only to
//   its rows times a scanline size rounded down (the rest is 0), and a
//   clipped tile's rows of units are skipped as if its units were 10 bytes.
// * CIELab (photometric 8, three 8- or 16-bit samples, contiguous) by
//   initCIELabConversion: TIFFCIELab16ToXYZ with the WhitePoint's
//   reference white (D50 without one) and TIFFXYZToRGB on libtiff's sRGB
//   display, in their float steps.
// * Orientation 1-4 as libtiff's RGBA reader turns a strip or tile: rows
//   flipped over the whole picture, columns within each tile (over the whole
//   width for strips). 5-8 of a square picture: flipped as 1-4 first, then
//   turned as cv2 turns it (5 and 7 transposed, 6 and 8 about the other
//   diagonal); cv2 fails to turn a picture of 5-8 that is not square, so
//   that raises here too.
// * StripByteCounts as libtiff's directory reader leaves them: a missing
//   tag, a single strip's count of 0 (uncompressed: past the file's end or
//   short of the picture too) and uncompressed counts whose first two differ
//   are estimated anew (EstimateStripByteCounts); a count of 0 left, or one
//   past the file, raises, as does an uncompressed tile the data then runs
//   short of.
// * Damaged strips and tiles as cv2 reads them: each TIFFReadRGBAStrip or
//   TIFFReadRGBATile call starts from a buffer of zeros, and where the
//   codec fails after that buffer is allocated (LZW: a first code that is
//   not a clear code, a code not yet in the table, data or an end code
//   before the segment is full; Deflate data zlib fails on; PackBits data
//   cut short, a literal it cuts not copied at all; an uncompressed strip
//   short of its rows, of which nothing is copied) the reader goes on with
//   the bytes the codec wrote and the rest 0, neither summed by the
//   predictor nor byte-swapped; ThunderScan and SGILog likewise (a row of
//   too few or too many ThunderScan pixels cleared from where it failed;
//   SGILog's rows up to the one its data runs short of). CCITT and JPEG
//   strips that fail still raise.
//
// * Pixar (32908), NeXT (32947) and JPEG 2000 (34712) compression, which
//   cv2's libtiff knows but cannot decode ("Compression scheme N strip
//   decoding is not implemented"): its RGBA reader goes on with the
//   strip's buffer as allocated, all zeros, so cv2 reads the picture of
//   zero samples at the file's size (black for RGB and min-is-black, white
//   for min-is-white and CMYK, the colour map's first entry for a
//   palette), whatever the strips hold; every other rule (the layouts cv2
//   refuses, orientation, a strip outside the file) is that of the other
//   compressions.
//
// Every TIFF cv2 reads decodes here. What cv2 refuses raises
// ImageDecodeError saying so ("cv2 refuses it too"): the compressions its
// libtiff is built without (LZMA, ZSTD, WebP, old-style JPEG, PixarLog,
// LERC), float samples, a predictor other than 2 (3 on integer samples) or 2
// on samples under 8 bits, 2-bit gray or palette, 4-bit gray (ThunderScan's
// too), more than four samples, samples of different depths, CMYK of other
// than four 8-bit samples or InkSet 1, YCbCr of other subsamplings, CIELab
// in planes or with a fourth sample, photometric 4, 9, 10, 32803, 34892 and
// the rest, LogL or LogLuv without SGILog compression (and SGILog under any
// other photometric), no PhotometricInterpretation, orientation 5-8 on a
// picture that is not square. Damage cv2 reads no picture of raises naming
// it.

#include <zlib.h>

#include <algorithm>
#include <cmath>
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

// a strip or tile whose codec failed after libtiff's RGBA reader had
// allocated its buffer (TIFFReadRGBAStrip and TIFFReadRGBATile start each
// call with a buffer of zeros): the reader goes on with the bytes the codec
// wrote, the rest left 0, neither predictor nor byte swap applied
constexpr int kSegmentFailed = 100;

int failed() { return kSegmentFailed; }

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
  // WhitePoint; libtiff's default is D50's (Adobe's TIFF note)
  float white[2] = {96.4250f / (96.4250f + 100.0f + 82.4680f),
                    100.0f / (96.4250f + 100.0f + 82.4680f)};
  int sgilog = 0;  // kSgiLogL, kSgiLogLuv32 or kSgiLogLuv24 of host.h
  std::vector<uint64_t> offsets, counts;
  bool has_counts = false;
  std::vector<uint32_t> colormap;
  std::vector<uint8_t> jpeg_tables;
  // what libtiff's StripByteCounts estimate reads of the IFD: its entries,
  // the bytes of their values stored outside it, and whether one is of a
  // type of no known size
  long entries = 0;
  uint64_t outside = 0;
  bool unknown_type = false;
  bool big = false;
};

// the compressions cv2's libtiff knows and does not decode, read as zero
// samples
bool blank_compression(int c) {
  return c == 32908 || c == 32947 || c == 34712;
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

// contiguous YCbCr outside JPEG: rows of data units, each h x v luma
// samples and then Cb and Cr
bool ycc_units(const Tiff& t) {
  return t.photometric == 6 && t.planar == 1 && t.spp == 3 &&
         t.compression != 7;
}

// libtiff's TIFFScanlineSize64 (for YCbCr units, a row of units / v,
// rounded down) and TIFFVTileSize64 of a whole tile
uint64_t scanline_size(const Tiff& t) {
  if (ycc_units(t))
    return (uint64_t{t.w} + t.ycc_h - 1) / t.ycc_h *
           (t.ycc_h * t.ycc_v + 2) / t.ycc_v;
  const uint64_t per = t.planar == 1 ? t.spp : 1;
  return (uint64_t{t.w} * per * t.bits + 7) / 8;
}

uint64_t tile_size(const Tiff& t) {
  if (ycc_units(t))
    return (uint64_t{t.tile_w} + t.ycc_h - 1) / t.ycc_h *
           (t.ycc_h * t.ycc_v + 2) * ((t.tile_h + t.ycc_v - 1) / t.ycc_v);
  const uint64_t per = t.planar == 1 ? t.spp : 1;
  return t.tile_h * ((uint64_t{t.tile_w} * per * t.bits + 7) / 8);
}

// libtiff's TIFFStripSize64: the bytes of a whole strip
uint64_t strip_size(const Tiff& t) {
  const uint64_t rows = std::min(t.rows_per_strip, t.h);
  if (ycc_units(t))
    return (uint64_t{t.w} + t.ycc_h - 1) / t.ycc_h *
           (t.ycc_h * t.ycc_v + 2) * ((rows + t.ycc_v - 1) / t.ycc_v);
  return rows * scanline_size(t);
}

// StripByteCounts as libtiff's TIFFReadDirectory leaves them (tif_dirread.c):
// a missing tag (one strip or tile, or one per plane), the count of a
// single strip that is 0 (or, without compression, runs past the file's
// end or is shorter than the picture), and uncompressed counts whose first
// two differ (more than two strips or tiles) are estimated anew
// (EstimateStripByteCounts); the rest stand as written.
int strip_byte_counts(long n, Tiff* t) {
  const uint64_t size = static_cast<uint64_t>(n);
  const long across = t->tiled ? (t->w + t->tile_w - 1) / t->tile_w : 1;
  const long down = t->tiled ? (t->h + t->tile_h - 1) / t->tile_h
                             : (t->h + std::min(t->rows_per_strip, t->h) - 1) /
                                   std::min(t->rows_per_strip, t->h);
  const long segments = across * down * (t->planar == 2 ? t->spp : 1);
  if (static_cast<long>(t->offsets.size()) < segments)
    return bad("fewer strip or tile offsets than the picture needs");
  auto& counts = t->counts;
  bool estimate = false;
  if (!t->has_counts) {
    if (t->planar == 1 ? segments > 1 : segments != t->spp)
      return bad("no StripByteCounts for " + std::to_string(segments) +
                 " strips or tiles");
    estimate = true;
  } else if (static_cast<long>(counts.size()) < segments) {
    return bad("fewer strip or tile byte counts than the picture needs");
  } else if (segments == 1 && !t->tiled && t->offsets[0] != 0) {
    const uint64_t c0 = counts[0], o0 = t->offsets[0];
    estimate = c0 == 0 ||
               (t->compression == 1 &&
                (o0 > size || c0 > size - o0 || c0 < scanline_size(*t) * t->h));
  } else if (t->planar == 1 && segments > 2 && t->compression == 1 &&
             counts[0] != counts[1] && counts[0] != 0 && counts[1] != 0) {
    estimate = true;
  }
  if (!estimate) return kOk;
  counts.assign(segments, 0);
  if (t->compression != 1) {  // what the file holds past its IFD, shared
    if (t->unknown_type)
      return bad("a tag of a type of no known size beside a StripByteCounts "
                 "libtiff estimates");
    uint64_t space = (t->big ? 16 + 8 + 20 * t->entries + 8
                             : 8 + 2 + 12 * t->entries + 4) + t->outside;
    space = size < space ? size : size - space;
    if (t->planar == 2) space /= t->spp;
    std::fill(counts.begin(), counts.end(), space);
    const uint64_t last = t->offsets[segments - 1];
    if (last + counts.back() > size) counts.back() = last >= size ? 0 : size - last;
  } else if (t->tiled) {
    std::fill(counts.begin(), counts.end(), tile_size(*t));
  } else {  // whole rows: the picture's rows / strips, rounded down
    std::fill(counts.begin(), counts.end(),
              scanline_size(*t) * (t->h / static_cast<uint64_t>(down)));
  }
  return kOk;
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
  t->big = big;
  t->entries = static_cast<long>(entries);
  for (long e = 0; e < static_cast<long>(entries); ++e) {
    const long p = static_cast<long>(ifd) + head + entry * e;
    const uint32_t tag = r.u16(p), type = r.u16(p + 2);
    const uint64_t count = big ? r.u64(p + 4) : r.u32(p + 4);
    if (type < 1 || type > 18 || kSize[type] == 0) {  // libtiff skips it
      t->unknown_type = true;
      continue;
    }
    if (count <= (1u << 28) && kSize[type] * count > static_cast<uint64_t>(word))
      t->outside += kSize[type] * count;
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
            return refused("samples of different bit depths");
        break;
      }
      case 259: t->compression = static_cast<int>(value(0)); break;
      case 292: t->t4_options = static_cast<uint32_t>(value(0)); break;
      case 332: t->inkset = static_cast<int>(value(0)); break;
      case 318: rationals(t->white, 2); break;
      case 529: rationals(t->luma, 3); break;
      case 532: rationals(t->ref_bw, 6); break;
      case 262: t->photometric = static_cast<int>(value(0)); break;
      case 266: t->fill_order = static_cast<int>(value(0)); break;
      case 273: case 324: t->offsets = values(); t->tiled |= tag == 324; break;
      case 274: t->orientation = static_cast<int>(value(0)); break;
      case 277: t->spp = static_cast<int>(value(0)); break;
      case 278: t->rows_per_strip = static_cast<uint32_t>(value(0)); break;
      case 279: case 325:
        t->counts = values();
        t->has_counts = true;
        break;
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
  if (const char* c = unconfigured_name(t->compression))
    return refused(std::string(c) + ", which cv2's libtiff is built without");
  const int c = t->compression;
  const bool ccitt = c == 2 || c == 3 || c == 4;
  const bool sgilog = c == 34676 || c == 34677;
  if (c != 1 && c != 5 && c != 7 && c != 8 && c != 32946 && c != 32773 &&
      c != 32809 && !ccitt && !sgilog && !blank_compression(c))
    return refused("compression " + std::to_string(c));
  if (t->photometric < 0) return refused("no PhotometricInterpretation");
  const int ph = t->photometric;
  if (ph == 32844 || ph == 32845) {  // LogL, LogLuv: tif_luv.c's only
    if (ph == 32844 ? c != 34676 : !sgilog)
      return refused(ph == 32844 ? "LogL (photometric 32844) of other than "
                                   "SGILog compression (34676)"
                                 : "LogLuv (photometric 32845) of other than "
                                   "SGILog compression (34676 or 34677)");
    if (ph == 32845 && t->planar != 1)
      return refused("LogLuv in separate planes");
    if (t->spp != (ph == 32844 ? 1 : 3))
      return refused(std::string(ph == 32844 ? "LogL" : "LogLuv") + " of " +
                     std::to_string(t->spp) + " samples per pixel");
    // the file's own BitsPerSample and SampleFormat (libtiff writes 16 and
    // signed) pass the RGBA reader's checks first, and OpenCV's gray ones
    // for LogL
    const int fb = t->bits, ff = t->sample_format;
    if (ph == 32844 ? fb != 1 && fb != 8 && fb != 16
                    : fb != 1 && fb != 2 && fb != 4 && fb != 8 && fb != 16)
      return refused(std::string(ph == 32844 ? "LogL" : "LogLuv") +
                     " of BitsPerSample " + std::to_string(fb));
    if (ph == 32844 ? ff != 1 && ff != 2 : ff == 3)
      return refused(std::string(ph == 32844 ? "LogL" : "LogLuv") +
                     " of SampleFormat " + std::to_string(ff));
    // the RGBA reader asks tif_luv.c for 8-bit gray or RGB (its "little
    // white lie"), whatever the file's samples; SGILog has no predictor
    t->sgilog = ph == 32844 ? kSgiLogL : c == 34676 ? kSgiLogLuv32
                                                    : kSgiLogLuv24;
    t->photometric = ph == 32844 ? 1 : 2;
    t->bits = 8;
    t->sample_format = 1;
    t->predictor = 1;
  } else if (sgilog) {
    return refused("SGILog compression under photometric " +
                   std::to_string(ph) + ", not LogL or LogLuv");
  }
  if (t->sample_format == 3)
    return refused("float samples (SampleFormat 3)");
  if (t->sample_format != 1 && t->sample_format != 2)
    return refused("SampleFormat " + std::to_string(t->sample_format));
  if (t->fill_order == 2 && c == 7)
    return refused("FillOrder 2 under JPEG compression");
  if (ccitt && (t->bits != 1 || t->spp != 1 || t->photometric > 1))
    return refused("CCITT compression of other than 1-bit gray");
  if (c == 32809 && t->bits != 4)
    return refused("ThunderScan compression of " + std::to_string(t->bits) +
                   "-bit samples");
  switch (t->photometric) {
    case 0: case 1: case 2: case 3: break;
    case 4: return refused("a transparency mask (photometric 4)");
    case 5:
      if (t->inkset != 1) return refused("CMYK of InkSet " +
                                         std::to_string(t->inkset));
      if (t->bits != 8 || t->spp != 4)
        return refused("CMYK of other than four 8-bit samples");
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
      break;
    case 8:  // CIELab: initCIELabConversion's 8- and 16-bit putters only
      if (t->planar != 1) return refused("CIELab in separate planes");
      if (t->spp != 3)
        return refused("CIELab of " + std::to_string(t->spp) +
                       " samples per pixel");
      if (t->white[1] == 0.0f) return refused("CIELab of a WhitePoint y of 0");
      break;
    case 9: return refused("ICC CIELab (photometric 9)");
    case 10: return refused("ITU CIELab (photometric 10)");
    case 32803: return refused("a colour filter array (photometric 32803)");
    case 34892: return refused("linear raw (photometric 34892)");
    default:
      return refused("photometric " + std::to_string(t->photometric));
  }
  if (t->spp < 1 || t->spp > 4) return refused(std::to_string(t->spp) +
                                               " samples per pixel");
  if (t->planar != 1 && t->planar != 2) return bad("bad PlanarConfiguration");
  const int colour = (t->photometric == 2 || t->photometric == 6 ||
                      t->photometric == 8) ? 3
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
  if (t->predictor != 1 && (c == 5 || c == 8 || c == 32946)) {
    // tif_predict.c's PredictorSetup
    if (t->predictor == 3)
      return refused("the floating-point predictor (Predictor 3) on "
                     "integer samples");
    if (t->predictor != 2)
      return refused("Predictor " + std::to_string(t->predictor));
    if (b < 8)
      return refused("predictor 2 on " + std::to_string(b) + "-bit samples");
  }
  if (t->tiled) {
    if (t->tile_w == 0 || t->tile_h == 0 || t->tile_w % 16 || t->tile_h % 16 ||
        t->tile_w > 1u << 16 || t->tile_h > 1u << 16)
      return bad("bad tile size");
  } else if (t->rows_per_strip == 0) {
    return bad("RowsPerStrip of 0");
  }
  if (t->orientation >= 5 && t->orientation <= 8 && t->w != t->h)
    return refused("orientation " + std::to_string(t->orientation) +
                   " on a picture that is not square, which cv2.imread "
                   "fails to turn");
  return strip_byte_counts(n, t);
}

// --------------------------------------------------------------- codecs

// libtiff's LZWDecode (or LZWDecodeCompat for the old style): the codes of
// src into out, until out is full or the end code
constexpr int kLzwTable = 4096 + 1024;  // CSIZE of tif_lzw.c

int lzw_decode(const uint8_t* src, long len, uint8_t* out, long want) {
  const bool old = len >= 2 && src[0] == 0 && (src[1] & 1);
  struct Entry {
    int prefix, length;
    uint8_t first, last;
  };
  std::vector<Entry> tab(kLzwTable);
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
    if (code < 0) return failed();
    if (code == 257) break;
    if (code == 256) {
      nbits = 9;
      free_ent = 258;
      int c;
      do c = next(); while (c == 256);
      if (c < 0) return failed();
      if (c == 257) break;
      if (c > 255) return failed();
      emit(c);
      old_code = c;
      continue;
    }
    if (old_code < 0) return failed();
    if (code > free_ent || free_ent >= kLzwTable) return failed();
    const int base = code == free_ent ? old_code : code;
    tab[free_ent] = {old_code, tab[old_code].length + 1, tab[old_code].first,
                     tab[base].first};
    ++free_ent;
    emit(code);
    old_code = code;
    const int limit = (1 << nbits) - (old ? 0 : 1);
    if (free_ent >= limit && nbits < 12) ++nbits;
  }
  if (filled < want) return failed();
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
    return failed();
  if (got < want) return failed();
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
      // a literal the data cuts short is not copied at all
      const long run = std::min<long>(c + 1, want - o);
      if (len - p < run) break;
      std::memcpy(out + o, src + p, run);
      p += c + 1;
      o += run;
    }
  }
  if (o < want) return failed();
  return kOk;
}

// libtiff's ThunderDecodeRow (tif_thunder.c): 4-bit pixels, rows of the
// picture's width `scanline` bytes apart, each coded as bytes of a 2-bit
// code and 6 bits of data: a run of the last pixel (its count in the data),
// three 2-bit or two 3-bit deltas from the last pixel (a skip code for
// none), or a raw pixel. A row of too few or too many pixels fails the
// segment, the rest of that row cleared.
int thunder_decode(const uint8_t* src, long len, long width, long scanline,
                   long want, uint8_t* out) {
  static const int kDelta2[4] = {0, 1, 0, -1};
  static const int kDelta3[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  if (scanline <= 0 || want % scanline)
    return bad("ThunderScan: fractional scanlines");
  const uint8_t* bp = src;
  long cc = len;
  for (long r0 = 0; r0 < want; r0 += scanline) {
    uint8_t* op = out + r0;
    unsigned lastpixel = 0;
    long npixels = 0;
    auto set = [&](unsigned v) {
      lastpixel = v & 0xf;
      if (npixels < width) {
        if (npixels++ & 1)
          *op++ |= static_cast<uint8_t>(lastpixel);
        else
          op[0] = static_cast<uint8_t>(lastpixel << 4);
      }
    };
    while (cc > 0 && npixels < width) {
      int n = *bp++;
      --cc;
      switch (n & 0xc0) {
        case 0x00:  // a run of the last pixel, n & 0x3f long
          n &= 0x3f;
          if (npixels & 1) {
            op[0] |= static_cast<uint8_t>(lastpixel);
            lastpixel = *op++;
            ++npixels;
            --n;
          } else {
            lastpixel |= lastpixel << 4;
          }
          npixels += n;
          if (npixels <= width)
            for (; n > 0; n -= 2) *op++ = static_cast<uint8_t>(lastpixel);
          if (n == -1) *--op &= 0xf0;
          lastpixel &= 0xf;
          break;
        case 0x40:  // three 2-bit deltas
          for (int sh = 4; sh >= 0; sh -= 2) {
            const int delta = (n >> sh) & 3;
            if (delta != 2) set(lastpixel + kDelta2[delta]);
          }
          break;
        case 0x80:  // two 3-bit deltas
          for (int sh = 3; sh >= 0; sh -= 3) {
            const int delta = (n >> sh) & 7;
            if (delta != 4) set(lastpixel + kDelta3[delta]);
          }
          break;
        default: set(static_cast<unsigned>(n)); break;  // a raw pixel
      }
    }
    if (npixels != width) {  // the rest of the row cleared, the strip failed
      uint8_t* end = out + r0 + (width + 1) / 2;
      if (op < end) std::memset(op, 0, end - op);
      return failed();
    }
  }
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
  // TIFFFillStrip / TIFFFillTile: a count of 0 fails, one over 1 MiB and
  // past 10 times the segment's size plus 4,096 is cut to that, and the
  // bytes must lie inside the file
  uint64_t count = t.counts[seg];
  if (count == 0) return bad("a strip or tile of no bytes");
  const uint64_t full = t.tiled ? tile_size(t) : strip_size(t);
  if (count > (1u << 20) && full != 0 && (count - 4096) / 10 > full)
    count = full * 10 + 4096;
  if (t.offsets[seg] > static_cast<uint64_t>(n) ||
      count > static_cast<uint64_t>(n) - t.offsets[seg])
    return bad("a strip or tile outside the file");
  const long off = static_cast<long>(t.offsets[seg]);
  const long cnt = static_cast<long>(count);
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
  const bool units = ycc_units(t);
  const int uh = units ? t.ycc_h : 1, uv = units ? t.ycc_v : 1;
  const long unit_bytes = units ? uh * uv + 2 : 0;
  const long units_across = (seg_w + uh - 1) / uh;
  const long row_bytes = units ? units_across * unit_bytes
                               : (seg_w * per * t.bits + 7) / 8;
  const long stored_rows = units ? (raw_rows + uv - 1) / uv : raw_rows;
  const long want = row_bytes * stored_rows;
  // the bytes libtiff decodes: all of a tile; a strip's rows times the
  // scanline size, for YCbCr units the rows rounded up to v times a row of
  // units / v rounded down (gtStripContig), the rest of the buffer 0
  const long asked = t.tiled || !units
                         ? want
                         : std::min(want, (rows + uv - 1) / uv * uv *
                                              (row_bytes / uv));
  std::vector<uint8_t> src(d + off, d + off + cnt), buf(want, 0);
  if (t.fill_order == 2)  // the bits of every byte reversed
    for (auto& b : src) {
      b = static_cast<uint8_t>(((b * 0x0802LU & 0x22110LU) |
                                (b * 0x8020LU & 0x88440LU)) * 0x10101LU >> 16);
    }
  int st = kOk;
  // under the blank compressions buf stays zero, and so it does for
  // ThunderScan tiles (tif_thunder.c decodes strips only)
  if (!blank_compression(t.compression) &&
      !(t.compression == 32809 && t.tiled)) switch (t.compression) {
    case 1:  // a short tile fails before the buffer is allocated (cv2
             // reads no picture); DumpModeDecode copies nothing of a short
             // strip
      if (cnt < asked && t.tiled) return bad("a tile shorter than its rows");
      if (cnt < asked) st = failed();
      else std::memcpy(buf.data(), src.data(), asked);
      break;
    case 5: st = lzw_decode(src.data(), cnt, buf.data(), asked); break;
    case 8: case 32946:
      st = inflate_segment(src.data(), cnt, buf.data(), asked);
      break;
    case 2: case 3: case 4:
      st = ccitt_decode(src.data(), cnt, t.compression, t.t4_options, seg_w,
                        raw_rows, buf.data());
      break;
    case 32809:
      st = thunder_decode(src.data(), cnt, t.w,
                          static_cast<long>(scanline_size(t)), asked,
                          buf.data());
      break;
    case 34676: case 34677:  // the rows before the one the data runs
                             // short of are kept
      st = sgilog_decode(src.data(), cnt, t.sgilog, seg_w, raw_rows,
                         buf.data());
      if (st == kCorrupt) st = failed();
      break;
    default: st = packbits_decode(src.data(), cnt, buf.data(), asked);
  }
  const bool whole = st != kSegmentFailed;
  if (!whole) st = kOk;
  if (st) return st;
  const long nsamp = seg_w * per;
  if (t.bits == 16 && whole) {  // to native (little-endian) order, as libtiff swaps
    for (long i = 0; i < raw_rows * nsamp; ++i) {
      uint8_t* b = buf.data() + 2 * i;
      if (!t.le) std::swap(b[0], b[1]);
    }
  }
  if (whole && t.predictor == 2 &&
      (t.compression == 5 || t.compression == 8 || t.compression == 32946)) {
    // tif_predict.c's PredictorDecodeTile: the decoded bytes in rows of
    // libtiff's row size (the scanline size in strips, a row of tile
    // samples in tiles, whatever YCbCr's data units), each row summed with
    // a stride of the samples per pixel. Where the bytes do not divide into
    // rows, or a row into pixels, libtiff fails before it sums and its
    // RGBA reader goes on with the bytes as decoded.
    const long rowsize = t.tiled ? (seg_w * per * t.bits + 7) / 8
                                 : static_cast<long>(scanline_size(t));
    const int bytes = t.bits / 8;
    if (rowsize > 0 && asked % rowsize == 0 && rowsize % (per * bytes) == 0)
      for (long r0 = 0; r0 < asked; r0 += rowsize) {
        uint8_t* row = buf.data() + r0;
        for (long i = per; i < rowsize / bytes; ++i) {
          if (bytes == 2) {
            const int v = (row[2 * i] | (row[2 * i + 1] << 8)) +
                          (row[2 * i - 2 * per] | (row[2 * i - 2 * per + 1] << 8));
            row[2 * i] = static_cast<uint8_t>(v);
            row[2 * i + 1] = static_cast<uint8_t>(v >> 8);
          } else {
            row[i] = static_cast<uint8_t>(row[i] + row[i - per]);
          }
        }
      }
  }
  if (units) {  // each pixel's luma sample and its unit's chroma
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
  // libtiff's gray tile readers (putgreytile, putagreytile,
  // put16bitbwtile) step over the clipped part of a rightmost tile by its
  // pixel count in bytes: each row of such a tile after the first starts
  // there, at npix * samples * bytes + (tile width - npix); one sample in
  // separate planes is read as contiguous
  const int bytes = t.bits / 8;
  long stride = row_bytes;
  if (t.tiled && cols < seg_w && t.photometric <= 1 && bytes > 0 &&
      (t.planar == 1 || t.spp == 1))
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

// libtiff's CIE L*a*b* to RGB (tif_color.c) as initCIELabConversion sets it
// up: TIFFCIELabToRGBInit with the sRGB display of tif_getimage.c and the
// reference white of the WhitePoint (Y of 100), then TIFFCIELab16ToXYZ (8-bit
// samples scaled by 257 and 256) and TIFFXYZToRGB, in their float steps
struct CieLab {
  static constexpr int kRange = 1500;  // CIELABTORGB_TABLE_RANGE
  float table[kRange + 1];  // the same for R, G and B on this display
  float step, x0, y0, z0;
  void init(const float* white) {
    const double gamma = 1.0 / 2.4F;
    step = (100.0F - 1.0F) / kRange;
    for (int i = 0; i <= kRange; ++i)
      table[i] = 255u * static_cast<float>(
                            std::pow(static_cast<double>(i) / kRange, gamma));
    y0 = 100.0F;
    x0 = white[0] / white[1] * y0;
    z0 = (1.0F - white[0] - white[1]) / white[1] * y0;
  }
  uint8_t channel(float yc) const {
    yc = yc > 1.0F ? yc : 1.0F;
    yc = yc < 100.0F ? yc : 100.0F;
    int i = static_cast<int>((yc - 1.0F) / step);
    i = std::min(kRange, i);
    const float f = table[i];
    const uint32_t v = static_cast<uint32_t>(f > 0 ? f + 0.5 : f - 0.5);
    return static_cast<uint8_t>(std::min<uint32_t>(v, 255));
  }
  void rgb(uint32_t l, int32_t a, int32_t b, uint8_t* o) const {
    const float L = static_cast<float>(l) * 100.0F / 65535.0F;
    float cby, tmp, X, Y, Z;
    if (L < 8.856F) {
      Y = (L * y0) / 903.292F;
      cby = 7.787F * (Y / y0) + 16.0F / 116.0F;
    } else {
      cby = (L + 16.0F) / 116.0F;
      Y = y0 * cby * cby * cby;
    }
    tmp = static_cast<float>(a) / 256.0F / 500.0F + cby;
    X = tmp < 0.2069F ? x0 * (tmp - 0.13793F) / 7.787F : x0 * tmp * tmp * tmp;
    tmp = cby - static_cast<float>(b) / 256.0F / 200.0F;
    Z = tmp < 0.2069F ? z0 * (tmp - 0.13793F) / 7.787F : z0 * tmp * tmp * tmp;
    o[0] = channel(3.2410F * X + -1.5374F * Y + -0.4986F * Z);
    o[1] = channel(-0.9692F * X + 1.8760F * Y + 0.0416F * Z);
    o[2] = channel(0.0556F * X + -0.2040F * Y + 1.0570F * Z);
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
  CieLab lab;
  if (t.photometric == 8) lab.init(t.white);
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
        case 8:  // L unsigned, a and b signed
          if (b == 8)
            lab.rgb(q[0] * 257u, static_cast<int8_t>(q[1]) * 256,
                    static_cast<int8_t>(q[2]) * 256, o);
          else
            lab.rgb(q[0], static_cast<int16_t>(q[1]), static_cast<int16_t>(q[2]),
                    o);
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
  // orientation 2-4 (and 6-8 first as 2-4): columns flipped within each
  // tile (the whole width of a strip), rows over the picture
  const int o = t.orientation > 4 && t.orientation <= 8 ? t.orientation - 4
                                                        : t.orientation;
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
  // then cv2 turns a square picture of orientation 5-8: 5 and 7 about the
  // main diagonal (transposed), 6 and 8 about the other one
  if (t.orientation >= 5 && t.orientation <= 8) {
    const long side = s.w;
    const bool main = t.orientation == 5 || t.orientation == 7;
    for (long y = 0; y < side; ++y)
      for (long x = main ? y + 1 : 0; main ? x < side : x < side - 1 - y; ++x) {
        const long ty = main ? x : side - 1 - x, tx = main ? y : side - 1 - y;
        for (int c = 0; c < 3; ++c)
          std::swap(out[(y * side + x) * 3 + c], out[(ty * side + tx) * 3 + c]);
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
