// Host library of the port: image decode, dispatched by signature (PNG
// here, JPEG by the library's own decoders in jpeg_host.cpp or the back
// end of host.h, BMP / PNM / TIFF / WebP by bmp_pnm_host.cpp, tiff_host.cpp
// and webp_host.cpp, and a "not ported" error naming any other format cv2
// reads), JPEG encode, bilinear resize, affine warp, the pixel loops of the
// colour ops, and a threaded prefetch loader.
//
// Counterpart of semi_detr_tpu/native/dataloader.cpp, plus the pixel work
// that the JAX package leaves to cv2 and Pillow. Every function reproduces
// a numpy plain version of the port (data/augment.py, data/image_io.py)
// bit for bit: the same float32 operations in the same order, each one
// rounded (the library is built with -ffp-contract=off, so no a * b + c is
// fused into an FMA), np.rint as round half to even, float -> uint8 as
// truncation.
//
// Each call writes into a buffer the caller allocates, touches no Python
// object and may run on any thread; ctypes releases the GIL for the call.

#include <zlib.h>

#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "host.h"

namespace sdt {

namespace {
thread_local std::string t_error;
}

void set_error(const std::string& msg) { t_error = msg; }


// ---------------------------------------------------------- RGB -> YCbCr
// libjpeg-turbo's jccolor.c (rgb_ycc_convert, 16-bit fixed point) and
// jcsample.c (h2v2_downsample: the mean of each 2x2 block with the
// rounding bias 1, 2, 1, 2, ... along a row; the last column and row
// repeated where the size is odd).

namespace {

struct RgbYccTables {
  int32_t r_y[256], g_y[256], b_y[256], r_cb[256], g_cb[256], b_cb[256],
      g_cr[256], b_cr[256];
  RgbYccTables() {
    auto fix = [](double x) { return static_cast<int32_t>(x * 65536 + 0.5); };
    const int32_t half = 1 << 15, offset = 128 << 16;
    for (int32_t i = 0; i < 256; ++i) {
      r_y[i] = fix(0.29900) * i;
      g_y[i] = fix(0.58700) * i;
      b_y[i] = fix(0.11400) * i + half;
      r_cb[i] = -fix(0.16874) * i;
      g_cb[i] = -fix(0.33126) * i;
      // half - 1: 255 stays 255 (also r_cr)
      b_cb[i] = fix(0.50000) * i + offset + half - 1;
      g_cr[i] = -fix(0.41869) * i;
      b_cr[i] = -fix(0.08131) * i;
    }
  }
};

}  // namespace

void rgb_to_ycc420(const uint8_t* rgb, int h, int w, uint8_t* y, uint8_t* cb,
                   uint8_t* cr) {
  static const RgbYccTables t;
  const int cw = (w + 1) / 2;
  // two full-resolution chroma rows, each one column longer where w is odd
  std::vector<uint8_t> full(4 * static_cast<size_t>(cw) * 2);
  uint8_t* fcb[2] = {full.data(), full.data() + 2 * cw};
  uint8_t* fcr[2] = {full.data() + 4 * cw, full.data() + 6 * cw};
  for (int r = 0; r < h; r += 2) {
    for (int k = 0; k < 2; ++k) {
      const int row = r + k < h ? r + k : h - 1;
      const uint8_t* p = rgb + static_cast<long>(row) * w * 3;
      uint8_t* yr = y + static_cast<long>(row) * w;
      for (int x = 0; x < w; ++x) {
        const int R = p[3 * x], G = p[3 * x + 1], B = p[3 * x + 2];
        yr[x] = static_cast<uint8_t>((t.r_y[R] + t.g_y[G] + t.b_y[B]) >> 16);
        fcb[k][x] = static_cast<uint8_t>((t.r_cb[R] + t.g_cb[G] + t.b_cb[B]) >>
                                         16);
        fcr[k][x] = static_cast<uint8_t>((t.b_cb[R] + t.g_cr[G] + t.b_cr[B]) >>
                                         16);
      }
      if (w % 2) {
        fcb[k][w] = fcb[k][w - 1];
        fcr[k][w] = fcr[k][w - 1];
      }
    }
    uint8_t* ob = cb + static_cast<long>(r / 2) * cw;
    uint8_t* orr = cr + static_cast<long>(r / 2) * cw;
    auto mean4 = [](const uint8_t* a, const uint8_t* b, int bias) {
      return static_cast<uint8_t>((a[0] + a[1] + b[0] + b[1] + bias) >> 2);
    };
    int bias = 1;
    for (int j = 0; j < cw; ++j) {
      ob[j] = mean4(fcb[0] + 2 * j, fcb[1] + 2 * j, bias);
      orr[j] = mean4(fcr[0] + 2 * j, fcr[1] + 2 * j, bias);
      bias ^= 3;
    }
  }
}


// ------------------------------------------------------------------ PNG
// What libpng gives the JAX package's loader (png_set_expand,
// png_set_strip_16, png_set_strip_alpha, png_set_gray_to_rgb): gray at
// bit depths 1, 2, 4, 8 and 16, palette at 1, 2, 4 and 8, gray + alpha,
// RGB and RGBA at 8 and 16, non-interlaced or Adam7, to 8-bit RGB. Gray
// below 8 bits is scaled as png_do_expand scales it (x255, x85, x17),
// palette indices are unpacked most significant bits first, 16 bits keep
// their high byte, alpha and tRNS change no pixel once alpha is stripped.
// data/image_io.decode_png is the numpy plain version: zlib's inflate and
// the row filters here, each Adam7 pass filtered on its own rows.

namespace {

const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

bool is_png(const uint8_t* d, long n) {
  return n >= 8 && std::memcmp(d, kPngSig, 8) == 0;
}

bool is_jpeg(const uint8_t* d, long n) {
  return n >= 3 && d[0] == 0xFF && d[1] == 0xD8 && d[2] == 0xFF;
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int png_channels(int ctype) {
  switch (ctype) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

// the bit depths the PNG specification allows for a colour type
bool png_depth_ok(int ctype, int depth) {
  switch (ctype) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 ||
                   depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

struct PngHeader {
  uint32_t w = 0, h = 0;
  int depth = 0, ctype = 0, compression = 0, filter = 0, interlace = 0;
};

std::string chunk_name(const uint8_t* t) {
  return std::string(reinterpret_cast<const char*>(t), 4);
}

// Walks the chunks (CRC checked), stopping after IHDR when header_only.
int png_chunks(const uint8_t* d, long n, bool header_only, PngHeader* hdr,
               std::vector<uint8_t>* idat, std::vector<uint8_t>* plte) {
  long pos = 8;
  bool have_header = false;
  while (pos < n) {
    if (pos + 12 > n) {
      set_error("PNG stream ends inside a chunk");
      return kCorrupt;
    }
    const uint32_t len = be32(d + pos);
    const uint8_t* type = d + pos + 4;
    const uint8_t* body = d + pos + 8;
    if (static_cast<long>(len) > n - pos - 12) {
      set_error("PNG chunk '" + chunk_name(type) +
                "' runs past the end of the stream");
      return kCorrupt;
    }
    uLong crc = crc32(0L, type, 4);
    crc = crc32(crc, body, len);
    if (crc != be32(body + len)) {
      set_error("PNG chunk '" + chunk_name(type) + "': bad CRC");
      return kCorrupt;
    }
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len != 13) {
        set_error("PNG IHDR of " + std::to_string(len) + " bytes");
        return kCorrupt;
      }
      hdr->w = be32(body);
      hdr->h = be32(body + 4);
      hdr->depth = body[8];
      hdr->ctype = body[9];
      hdr->compression = body[10];
      hdr->filter = body[11];
      hdr->interlace = body[12];
      have_header = true;
      if (header_only) break;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      plte->assign(body, body + len);
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat->insert(idat->end(), body, body + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + static_cast<long>(len);
  }
  if (!have_header) {
    set_error("PNG without IHDR");
    return kCorrupt;
  }
  if (!png_depth_ok(hdr->ctype, hdr->depth) || hdr->compression ||
      hdr->filter || hdr->interlace > 1) {
    set_error("PNG of bit depth " + std::to_string(hdr->depth) +
              ", colour type " + std::to_string(hdr->ctype) +
              ", compression " + std::to_string(hdr->compression) +
              ", filter " + std::to_string(hdr->filter) + ", interlace " +
              std::to_string(hdr->interlace) +
              ": not a combination the PNG specification defines");
    return kCorrupt;
  }
  if (hdr->w == 0 || hdr->h == 0 || hdr->w > 0x7fffffffu ||
      hdr->h > 0x7fffffffu) {
    set_error("PNG of " + std::to_string(hdr->h) + "x" +
              std::to_string(hdr->w) + " pixels");
    return kCorrupt;
  }
  return kOk;
}

int png_info(const uint8_t* d, long n, int* h, int* w) {
  PngHeader hdr;
  std::vector<uint8_t> idat, plte;
  const int st = png_chunks(d, n, true, &hdr, &idat, &plte);
  if (st) return st;
  *h = static_cast<int>(hdr.h);
  *w = static_cast<int>(hdr.w);
  return kOk;
}

// Adam7's passes: (x0, y0, dx, dy); a non-interlaced image is one pass
const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                          {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                          {0, 1, 1, 2}};
const int kWhole[1][4] = {{0, 0, 1, 1}};

}  // namespace

}  // namespace sdt

extern "C" {

using namespace sdt;

const char* sdt_last_error() { return t_error.c_str(); }

const char* sdt_jpeg_backend() { return jpeg_backend(); }

// Undo the per-row filters of PNG rows (all five: None, Sub, Up, Average,
// Paeth). raw: h rows of 1 filter byte + row_bytes bytes; bpp: the bytes
// of a complete pixel, at least 1. Returns 0, or y + 1 for a row y whose
// filter type is unknown.
int sdt_png_unfilter(const uint8_t* raw, int h, long row_bytes, int bpp,
                     uint8_t* out) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = raw + static_cast<long>(y) * (row_bytes + 1);
    const int ftype = src[0];
    const uint8_t* line = src + 1;
    uint8_t* cur = out + static_cast<long>(y) * row_bytes;
    const uint8_t* prev = y ? cur - row_bytes : nullptr;
    const long first = bpp < row_bytes ? bpp : row_bytes;
    switch (ftype) {
      case 0:
        std::memcpy(cur, line, row_bytes);
        break;
      case 1:  // Sub
        std::memcpy(cur, line, first);
        for (long x = bpp; x < row_bytes; ++x)
          cur[x] = static_cast<uint8_t>(line[x] + cur[x - bpp]);
        break;
      case 2:  // Up
        for (long x = 0; x < row_bytes; ++x)
          cur[x] = static_cast<uint8_t>(line[x] + (prev ? prev[x] : 0));
        break;
      case 3:  // Average
        for (long x = 0; x < row_bytes; ++x) {
          const int a = x >= bpp ? cur[x - bpp] : 0;
          const int b = prev ? prev[x] : 0;
          cur[x] = static_cast<uint8_t>(line[x] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (long x = 0; x < row_bytes; ++x) {
          const int a = x >= bpp ? cur[x - bpp] : 0;
          const int b = prev ? prev[x] : 0;
          const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[x] = static_cast<uint8_t>(line[x] + pred);
        }
        break;
      default:
        set_error("PNG row " + std::to_string(y) + ": unknown filter type " +
                  std::to_string(ftype));
        return y + 1;
    }
  }
  return 0;
}

int sdt_png_decode(const uint8_t* d, long n, uint8_t* out, int h, int w) {
  PngHeader hdr;
  std::vector<uint8_t> idat, plte;
  int st = png_chunks(d, n, false, &hdr, &idat, &plte);
  if (st) return st;
  if (static_cast<int>(hdr.h) != h || static_cast<int>(hdr.w) != w) {
    set_error("PNG size differs from the size asked for");
    return kSizeMismatch;
  }
  const int ch = png_channels(hdr.ctype), depth = hdr.depth;
  const int bits = ch * depth, bpp = bits >= 8 ? bits / 8 : 1;
  const int (*passes)[4] = hdr.interlace ? kAdam7 : kWhole;
  const int npass = hdr.interlace ? 7 : 1;
  // each pass's size; an empty pass has no bytes, not even filter bytes
  long pw[7], ph[7], row_bytes[7];
  size_t expected = 0;
  for (int p = 0; p < npass; ++p) {
    const int* a = passes[p];
    pw[p] = w > a[0] ? (w - a[0] + a[2] - 1) / a[2] : 0;
    ph[p] = h > a[1] ? (h - a[1] + a[3] - 1) / a[3] : 0;
    row_bytes[p] = (pw[p] * bits + 7) / 8;
    if (pw[p] && ph[p]) expected += ph[p] * (row_bytes[p] + 1);
  }
  // one byte more than expected: a stream that inflates to more is caught
  std::vector<uint8_t> raw(expected + 1);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) {
    set_error("zlib inflateInit failed");
    return kCorrupt;
  }
  zs.next_in = idat.data();
  zs.avail_in = static_cast<uInt>(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = static_cast<uInt>(raw.size());
  const int zrc = inflate(&zs, Z_FINISH);
  const size_t got = zs.total_out;
  inflateEnd(&zs);
  if (zrc != Z_STREAM_END || got != expected) {
    set_error("PNG data holds " + std::to_string(got) +
              (zrc == Z_STREAM_END ? "" : " or more (damaged or truncated)") +
              " bytes, expected " + std::to_string(expected));
    return kCorrupt;
  }
  if (hdr.ctype == 3 && plte.empty()) {
    set_error("palette PNG without PLTE");
    return kCorrupt;
  }
  const long entries = static_cast<long>(plte.size()) / 3;
  // gray below 8 bits to 8: 255 / (2^depth - 1)
  const int scale = depth == 1 ? 255 : depth == 2 ? 85 : depth == 4 ? 17 : 1;
  const int mask = (1 << (depth < 8 ? depth : 8)) - 1;
  // sample i of a row, reduced to 8 bits (a palette index stays one)
  auto sample = [&](const uint8_t* row, long i) -> int {
    if (depth == 8) return row[i];
    if (depth == 16) return row[2 * i];  // png_set_strip_16: the high byte
    const long bit = i * depth;
    return (row[bit >> 3] >> (8 - depth - (bit & 7))) & mask;
  };
  std::vector<uint8_t> px;
  const uint8_t* src = raw.data();
  for (int p = 0; p < npass; ++p) {
    if (!pw[p] || !ph[p]) continue;
    px.resize(static_cast<size_t>(ph[p]) * row_bytes[p]);
    if (sdt_png_unfilter(src, static_cast<int>(ph[p]), row_bytes[p], bpp,
                         px.data()))
      return kCorrupt;
    src += ph[p] * (row_bytes[p] + 1);
    const int* a = passes[p];
    for (long y = 0; y < ph[p]; ++y) {
      const uint8_t* row = px.data() + y * row_bytes[p];
      uint8_t* orow = out + (static_cast<long>(a[1]) + y * a[3]) * w * 3;
      for (long x = 0; x < pw[p]; ++x) {
        uint8_t* o = orow + (a[0] + x * a[2]) * 3;
        if (hdr.ctype == 3) {
          const int idx = sample(row, x);
          if (idx >= entries) {
            set_error("PNG palette index " + std::to_string(idx) +
                      " outside its " + std::to_string(entries) +
                      " entries");
            return kCorrupt;
          }
          std::memcpy(o, plte.data() + 3 * idx, 3);
        } else if (ch <= 2) {  // gray (+ alpha): repeated
          o[0] = o[1] = o[2] =
              static_cast<uint8_t>(sample(row, x * ch) * scale);
        } else {  // RGB (+ alpha)
          o[0] = static_cast<uint8_t>(sample(row, x * ch));
          o[1] = static_cast<uint8_t>(sample(row, x * ch + 1));
          o[2] = static_cast<uint8_t>(sample(row, x * ch + 2));
        }
      }
    }
  }
  return kOk;
}

static int unknown_format() {
  set_error("neither a JPEG nor a PNG stream, nor BMP, PNM, PAM, TIFF, "
            "WebP, GIF, Sun raster, PFM, HDR, JPEG 2000, AVIF or another "
            "format cv2 reads");
  return kUnknownFormat;
}

// (h, w) of a stream of any format the library decodes, by its signature,
// as decoded (a JPEG stream CMYK or YCCK, a TIFF or a WebP one turned by
// its orientation as cv2 turns them).
int sdt_image_info(const uint8_t* d, long n, int* h, int* w) {
  if (is_png(d, n)) return png_info(d, n, h, w);
  if (is_jpeg(d, n)) {
    if (jpeg_host_info(d, n, h, w) == kOk) return kOk;
    if (const char* why = jpeg_refusal(d, n)) {
      set_error(why);
      return kUnsupported;
    }
    return jpeg_info(d, n, h, w);
  }
  if (is_bmp(d, n)) return bmp_info(d, n, h, w);
  if (is_pnm(d, n)) return pnm_info(d, n, h, w);
  if (is_tiff(d, n)) return tiff_info(d, n, h, w);
  if (is_webp(d, n)) return webp_info(d, n, h, w);
  if (is_pam(d, n)) return pam_info(d, n, h, w);
  if (is_gif(d, n)) return gif_info(d, n, h, w);
  if (is_sun_raster(d, n)) return sun_raster_info(d, n, h, w);
  if (is_pfm(d, n)) return pfm_info(d, n, h, w);
  if (is_hdr(d, n)) return hdr_info(d, n, h, w);
  if (is_jpeg2000(d, n)) return jpeg2000_info(d, n, h, w);
  if (is_avif(d, n)) return avif_info(d, n, h, w);
  return unknown_format();
}

// Decode a stream of (h, w) pixels into out (h, w, 3) RGB. A JPEG stream
// the library's own decoders take goes to them on either back end, and a
// fault there fails the decode; the back end decodes only the rest, after
// jpeg_check. Every other format is the library's own.
int sdt_decode(const uint8_t* d, long n, uint8_t* out, int h, int w) {
  if (is_png(d, n)) return sdt_png_decode(d, n, out, h, w);
  if (is_jpeg(d, n)) {
    if (jpeg_host_kind(d, n) != kOther)
      return jpeg_decode_host(d, n, out, h, w);
    if (const char* why = jpeg_refusal(d, n)) {
      set_error(why);
      return kUnsupported;
    }
    const int st = jpeg_check(d, n);
    return st ? st : jpeg_decode(d, n, out, h, w);
  }
  if (is_bmp(d, n)) return bmp_decode(d, n, out, h, w);
  if (is_pnm(d, n)) return pnm_decode(d, n, out, h, w);
  if (is_tiff(d, n)) return tiff_decode(d, n, out, h, w);
  if (is_webp(d, n)) return webp_decode(d, n, out, h, w);
  if (is_pam(d, n)) return pam_decode(d, n, out, h, w);
  if (is_gif(d, n)) return gif_decode(d, n, out, h, w);
  if (is_sun_raster(d, n)) return sun_raster_decode(d, n, out, h, w);
  if (is_pfm(d, n)) return pfm_decode(d, n, out, h, w);
  if (is_hdr(d, n)) return hdr_decode(d, n, out, h, w);
  if (is_jpeg2000(d, n)) return jpeg2000_decode(d, n, out, h, w);
  if (is_avif(d, n)) return avif_decode(d, n, out, h, w);
  return unknown_format();
}

int sdt_encode_jpeg(const uint8_t* rgb, int h, int w, uint8_t** out,
                    long* size) {
  return jpeg_encode(rgb, h, w, out, size);
}

void sdt_free(void* p) { std::free(p); }

// sdt::rgb_to_ycc420 for the tests
void sdt_rgb_to_ycc420(const uint8_t* rgb, int h, int w, uint8_t* y,
                       uint8_t* cb, uint8_t* cr) {
  rgb_to_ycc420(rgb, h, w, y, cb, cr);
}

// 0 for a whole JPEG stream, else kCorrupt (the fault in sdt_last_error)
int sdt_jpeg_check(const uint8_t* d, long n) { return jpeg_check(d, n); }

// the host decoder that takes the stream (sdt::jpeg_host_kind): 0 none,
// 1 sequential, 2 progressive, 3 sequential arithmetic, 4 progressive
// arithmetic
int sdt_jpeg_host_kind(const uint8_t* d, long n) {
  return jpeg_host_kind(d, n);
}

// libjpeg's colour space guess for such a stream, "" for another
const char* sdt_jpeg_host_colour(const uint8_t* d, long n) {
  const char* c = jpeg_host_colour(d, n);
  return c ? c : "";
}

// the back end's own decode of any JPEG stream, after the check (the
// route sdt_decode takes for the streams jpeg_host_kind refuses)
int sdt_decode_jpeg_backend(const uint8_t* d, long n, uint8_t* out, int h,
                            int w) {
  const int st = jpeg_check(d, n);
  return st ? st : jpeg_decode(d, n, out, h, w);
}

// the host decoders of one kind each, on either back end, for the tests
int sdt_decode_jpeg_sequential(const uint8_t* d, long n, uint8_t* out, int h,
                               int w) {
  return jpeg_decode_sequential(d, n, out, h, w);
}

int sdt_decode_jpeg_progressive(const uint8_t* d, long n, uint8_t* out,
                                int h, int w) {
  return jpeg_decode_progressive(d, n, out, h, w);
}

int sdt_decode_jpeg_arithmetic(const uint8_t* d, long n, uint8_t* out,
                               int h, int w) {
  return jpeg_decode_arithmetic(d, n, out, h, w);
}

// sdt::ycc_to_rgb for the tests: planes y (h, w), cb and cr (ch, cw)
void sdt_ycc_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                    int h, int w, int ch, int cw, int hs, int vs,
                    uint8_t* out) {
  ycc_to_rgb(y, cb, cr, h, w, ch, cw, hs, vs, out);
}

// ------------------------------------------------------------ resize
// Bilinear, half-pixel centres, the formula of semi_detr_tpu/native/
// dataloader.cpp (sdt_resize_bilinear), for any channel count. Each source
// row's horizontal pass (top and bottom there) is computed once and kept
// while consecutive output rows read it: the same floats, fewer passes.
void sdt_resize_bilinear(const uint8_t* src, int sh, int sw, int c,
                         uint8_t* dst, int dh, int dw) {
  const float fy = static_cast<float>(sh) / dh;
  const float fx = static_cast<float>(sw) / dw;
  const long n = static_cast<long>(dw) * c;
  std::vector<int> xa(n), xb(n);
  std::vector<float> wr(n), wl(n);  // wx and 1 - wx of each output value
  for (int x = 0; x < dw; ++x) {
    float sxf = (x + 0.5f) * fx - 0.5f;
    if (sxf < 0) sxf = 0;
    int x0 = static_cast<int>(sxf);
    if (x0 > sw - 1) x0 = sw - 1;
    const int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
    const float wx = sxf - x0;
    for (int k = 0; k < c; ++k) {
      xa[x * c + k] = x0 * c + k;
      xb[x * c + k] = x1 * c + k;
      wr[x * c + k] = wx;
      wl[x * c + k] = 1 - wx;
    }
  }
  // the horizontal passes of the two source rows last used
  std::vector<float> rows[2] = {std::vector<float>(n), std::vector<float>(n)};
  int held[2] = {-1, -1};
  auto pass = [&](int r) -> const float* {
    if (held[0] == r) return rows[0].data();
    if (held[1] == r) return rows[1].data();
    // replace the older row: rows come in order and y1 is y0 or y0 + 1,
    // so the older one is never the y0 that a y1 is fetched beside
    const int slot = held[0] < held[1] ? 0 : 1;
    const uint8_t* s_row = src + static_cast<long>(r) * sw * c;
    float* h = rows[slot].data();
    for (long i = 0; i < n; ++i)
      h[i] = s_row[xa[i]] * wl[i] + s_row[xb[i]] * wr[i];
    held[slot] = r;
    return h;
  };
  for (int y = 0; y < dh; ++y) {
    float syf = (y + 0.5f) * fy - 0.5f;
    if (syf < 0) syf = 0;
    int y0 = static_cast<int>(syf);
    if (y0 > sh - 1) y0 = sh - 1;
    const int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    const float wy = syf - y0;
    const float* top = pass(y0);
    const float* bot = pass(y1);
    uint8_t* drow = dst + static_cast<long>(y) * n;
    const float wt = 1 - wy;
    for (long i = 0; i < n; ++i)
      drow[i] = static_cast<uint8_t>(top[i] * wt + bot[i] * wy + 0.5f);
  }
}

}  // extern "C"

// -------------------------------------------------------------- warp

namespace sdt {
namespace {

// floor(v), exact: a float of magnitude 2**23 or more is an integer
inline float floor_exact(float v) {
  if (!(std::fabs(v) < 8388608.0f)) return v;
  const float t = static_cast<float>(static_cast<int>(v));
  return t > v ? t - 1.0f : t;
}

// np.rint (half to even) of |v| < 2**22: adding and removing 1.5 * 2**23
// leaves the float grid at integers, and IEEE round-to-nearest-even puts
// v on the nearest one (without -ffast-math the compiler keeps both adds)
inline float rint_small(float v) {
  const float magic = 12582912.0f;
  const float t = v + magic;
  return t - magic;
}

}  // namespace
}  // namespace sdt

extern "C" {

// data/augment.warp_affine: destination pixel (x, y) samples the source at
// m @ (x, y, 1) (m: the destination -> source map, float32), taps outside
// the image read `fill`.
void sdt_warp_affine(const uint8_t* src, int h, int w, int c, const float* m,
                     int fill, uint8_t* dst) {
  const float fillf = static_cast<float>(fill);
  const float wf = static_cast<float>(w), hf = static_cast<float>(h);
  const long stride = static_cast<long>(w) * c;
  auto clip_tap = [](float t, float hi) {
    return static_cast<int>(t < -1.0f ? -1.0f : (t > hi ? hi : t));
  };
  // taps and fill lie in [0, 255], and so does the interpolation
  auto lerp2 = [](float v00, float v01, float v10, float v11, float fx,
                  float fy) {
    const float top = v00 + fx * (v01 - v00);
    const float bot = v10 + fx * (v11 - v10);
    const float out = rint_small(top + fy * (bot - top));
    return static_cast<uint8_t>(out < 0.0f ? 0.0f
                                           : (out > 255.0f ? 255.0f : out));
  };
  for (int y = 0; y < h; ++y) {
    const float yf = static_cast<float>(y);
    const float bx = m[1] * yf + m[2];
    const float by = m[4] * yf + m[5];
    uint8_t* drow = dst + static_cast<long>(y) * stride;
    for (int x = 0; x < w; ++x) {
      const float xf = static_cast<float>(x);
      const float sx = m[0] * xf + bx;
      const float sy = m[3] * xf + by;
      const float x0 = floor_exact(sx), y0 = floor_exact(sy);
      const float fx = sx - x0, fy = sy - y0;
      uint8_t* o = drow + static_cast<long>(x) * c;
      if (x0 >= 0.0f && x0 < wf - 1.0f && y0 >= 0.0f && y0 < hf - 1.0f) {
        // all four taps inside the image
        const uint8_t* p = src + static_cast<long>(y0) * stride +
                           static_cast<long>(x0) * c;
        const uint8_t* q = p + stride;
        for (int k = 0; k < c; ++k)
          o[k] = lerp2(p[k], p[k + c], q[k], q[k + c], fx, fy);
        continue;
      }
      const int xi[2] = {clip_tap(x0, wf), clip_tap(x0 + 1.0f, wf)};
      const int yi[2] = {clip_tap(y0, hf), clip_tap(y0 + 1.0f, hf)};
      const uint8_t* tap[2][2];
      for (int a = 0; a < 2; ++a)
        for (int b = 0; b < 2; ++b)
          tap[a][b] = (yi[a] < 0 || yi[a] >= h || xi[b] < 0 || xi[b] >= w)
                          ? nullptr
                          : src + yi[a] * stride +
                                static_cast<long>(xi[b]) * c;
      for (int k = 0; k < c; ++k) {
        float v[2][2];
        for (int a = 0; a < 2; ++a)
          for (int b = 0; b < 2; ++b)
            v[a][b] = tap[a][b] ? static_cast<float>(tap[a][b][k]) : fillf;
        o[k] = lerp2(v[0][0], v[0][1], v[1][0], v[1][1], fx, fy);
      }
    }
  }
}


// ------------------------------------------------------------ colour
// The pixel loops of data/augment.apply_color_op (Pillow's algorithms).

// per-channel histograms: hist[k * 256 + v] counts value v of channel k
void sdt_histogram(const uint8_t* img, long n, int c, int64_t* hist) {
  std::memset(hist, 0, sizeof(int64_t) * 256 * c);
  for (long i = 0; i < n; ++i)
    for (int k = 0; k < c; ++k) ++hist[k * 256 + img[i * c + k]];
}

// out = lut[k][img] per channel k (lut: c tables of 256 entries)
void sdt_apply_lut(const uint8_t* img, long n, int c, const uint8_t* lut,
                   uint8_t* out) {
  for (long i = 0; i < n; ++i)
    for (int k = 0; k < c; ++k) out[i * c + k] = lut[k * 256 + img[i * c + k]];
}

// RGB -> L: ITU-R 601-2 luma in 16-bit fixed point, rounded
void sdt_gray(const uint8_t* img, long n, uint8_t* out) {
  for (long i = 0; i < n; ++i) {
    const uint32_t v = img[3 * i] * 19595u + img[3 * i + 1] * 38470u +
                       img[3 * i + 2] * 7471u + 0x8000u;
    out[i] = static_cast<uint8_t>(v >> 16);
  }
}

// Image.blend(degenerate, img, alpha): d + alpha * (img - d) in single
// precision, clipped to [0, 255] and truncated. The degenerate value of
// pixel i, channel k is deg[i * deg_px + k * deg_ch] (strides 0 broadcast).
void sdt_blend(const uint8_t* deg, long deg_px, long deg_ch,
               const uint8_t* img, long n, int c, float alpha, uint8_t* out) {
  auto one = [alpha](int d, int v) {
    float r = static_cast<float>(d) + alpha * static_cast<float>(v - d);
    r = r < 0.0f ? 0.0f : (r > 255.0f ? 255.0f : r);
    return static_cast<uint8_t>(r);
  };
  const long count = n * c;
  if (deg_px == c && deg_ch == 1) {  // a full image
    for (long i = 0; i < count; ++i) out[i] = one(deg[i], img[i]);
  } else if (deg_px == 0 && deg_ch == 0) {  // one value
    const int d = deg[0];
    for (long i = 0; i < count; ++i) out[i] = one(d, img[i]);
  } else {
    for (long i = 0; i < n; ++i)
      for (int k = 0; k < c; ++k)
        out[i * c + k] = one(deg[i * deg_px + k * deg_ch], img[i * c + k]);
  }
}

// ImageFilter.SMOOTH (1 1 1 / 1 5 1 / 1 1 1, / 13): float32 sums in
// Filter.c's order, + 0.5, clipped and truncated; border pixels kept.
void sdt_smooth(const uint8_t* img, int h, int w, int c, uint8_t* out) {
  std::memcpy(out, img, static_cast<size_t>(h) * w * c);
  if (h < 3 || w < 3) return;
  const float k1 = 1.0f / 13.0f, k5 = 5.0f / 13.0f;
  const long stride = static_cast<long>(w) * c;
  // within a row, the values of the interior pixels are one run of bytes:
  // value i has its left and right neighbours at i - c and i + c
  const long first = c, last = stride - c;
  for (int y = 1; y < h - 1; ++y) {
    const uint8_t* up = img + (y - 1) * stride;
    const uint8_t* mid = up + stride;
    const uint8_t* dn = mid + stride;
    uint8_t* o = out + y * stride;
    for (long i = first; i < last; ++i) {
      float ss = 0.5f + ((static_cast<float>(dn[i - c]) * k1 +
                          static_cast<float>(dn[i]) * k1) +
                         static_cast<float>(dn[i + c]) * k1);
      ss = ss + ((static_cast<float>(mid[i - c]) * k1 +
                  static_cast<float>(mid[i]) * k5) +
                 static_cast<float>(mid[i + c]) * k1);
      ss = ss + ((static_cast<float>(up[i - c]) * k1 +
                  static_cast<float>(up[i]) * k1) +
                 static_cast<float>(up[i + c]) * k1);
      ss = ss < 0.0f ? 0.0f : (ss > 255.0f ? 255.0f : ss);
      o[i] = static_cast<uint8_t>(ss);
    }
  }
}

// values below thr kept, the others inverted
void sdt_solarize(const uint8_t* img, long count, int thr, uint8_t* out) {
  for (long i = 0; i < count; ++i)
    out[i] = img[i] < thr ? img[i] : static_cast<uint8_t>(255 - img[i]);
}

void sdt_posterize(const uint8_t* img, long count, int mask, uint8_t* out) {
  const uint8_t m = static_cast<uint8_t>(mask);
  for (long i = 0; i < count; ++i) out[i] = img[i] & m;
}

}  // extern "C"

// ---------------------------------------------------- prefetch loader
// Read, decode and resize in a pool of threads, results in completion order
// (semi_detr_tpu/native/dataloader.cpp's Loader).

namespace sdt {
namespace {

struct Task {
  long index;
  std::string path;
  int target_h, target_w;  // 0: keep the decoded size
};

struct Result {
  long index = -1;
  std::vector<uint8_t> pixels;
  int h = 0, w = 0, src_h = 0, src_w = 0;
  int status = kOk;
  std::string message;
};

int read_file(const std::string& path, std::vector<uint8_t>* buf) {
  std::FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) {
    set_error("cannot open the file");
    return kOpen;
  }
  int st = kOk;
  if (std::fseek(f, 0, SEEK_END) != 0) st = kRead;
  const long size = st ? -1 : std::ftell(f);
  if (size < 0 || std::fseek(f, 0, SEEK_SET) != 0) st = kRead;
  if (!st) {
    buf->resize(size);
    if (std::fread(buf->data(), 1, size, f) != static_cast<size_t>(size))
      st = kRead;
  }
  std::fclose(f);
  if (st) set_error("cannot read the file to its end");
  return st;
}

struct Loader {
  std::vector<std::thread> workers;
  std::deque<Task> tasks;
  std::deque<Result> results;
  Result current;  // the result sdt_loader_next handed out last
  std::mutex mu;
  std::condition_variable cv_task, cv_result;
  bool stop = false;
  long max_pixels;

  Loader(int n_threads, long max_px) : max_pixels(max_px) {
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this] { run(); });
  }

  void load(const Task& t, std::vector<uint8_t>* raw,
            std::vector<uint8_t>* decoded, Result* r) {
    r->status = read_file(t.path, raw);
    if (r->status) return;
    const uint8_t* d = raw->data();
    const long n = static_cast<long>(raw->size());
    r->status = sdt_image_info(d, n, &r->src_h, &r->src_w);
    if (r->status) return;
    if (static_cast<long>(r->src_h) * r->src_w > max_pixels) {
      set_error("image of " + std::to_string(r->src_h) + "x" +
                std::to_string(r->src_w) + " pixels, more than allowed");
      r->status = kTooLarge;
      return;
    }
    decoded->resize(static_cast<size_t>(r->src_h) * r->src_w * 3);
    r->status = sdt_decode(d, n, decoded->data(), r->src_h, r->src_w);
    if (r->status) return;
    r->h = t.target_h > 0 ? t.target_h : r->src_h;
    r->w = t.target_w > 0 ? t.target_w : r->src_w;
    if (r->h == r->src_h && r->w == r->src_w) {
      r->pixels.swap(*decoded);
    } else {
      r->pixels.resize(static_cast<size_t>(r->h) * r->w * 3);
      sdt_resize_bilinear(decoded->data(), r->src_h, r->src_w, 3,
                          r->pixels.data(), r->h, r->w);
    }
  }

  void run() {
    std::vector<uint8_t> raw, decoded;
    while (true) {
      Task t;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_task.wait(lk, [this] { return stop || !tasks.empty(); });
        if (stop) break;
        t = std::move(tasks.front());
        tasks.pop_front();
      }
      Result r;
      r.index = t.index;
      load(t, &raw, &decoded, &r);
      if (r.status) r.message = t_error;
      {
        std::lock_guard<std::mutex> lk(mu);
        results.push_back(std::move(r));
      }
      cv_result.notify_one();
    }
  }
};

}  // namespace
}  // namespace sdt

extern "C" {

void* sdt_loader_create(int n_threads, long max_pixels) {
  return new Loader(n_threads, max_pixels);
}

void sdt_loader_submit(void* loader, long index, const char* path,
                       int target_h, int target_w) {
  Loader* l = static_cast<Loader*>(loader);
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->tasks.push_back(Task{index, path, target_h, target_w});
  }
  l->cv_task.notify_one();
}

// Blocks for the next finished task (the caller knows one is outstanding)
// and keeps it as the current result: its index, size, source size and
// status; on failure the message (at most cap - 1 bytes) in msg.
int sdt_loader_next(void* loader, long* index, int* h, int* w, int* src_h,
                    int* src_w, char* msg, int cap) {
  Loader* l = static_cast<Loader*>(loader);
  {
    std::unique_lock<std::mutex> lk(l->mu);
    l->cv_result.wait(lk, [l] { return !l->results.empty(); });
    l->current = std::move(l->results.front());
    l->results.pop_front();
  }
  const Result& r = l->current;
  *index = r.index;
  *h = r.h;
  *w = r.w;
  *src_h = r.src_h;
  *src_w = r.src_w;
  std::snprintf(msg, cap, "%s", r.message.c_str());
  return r.status;
}

// Copies the current result's pixels (h * w * 3 bytes) and releases them.
void sdt_loader_copy(void* loader, uint8_t* out) {
  Loader* l = static_cast<Loader*>(loader);
  std::memcpy(out, l->current.pixels.data(), l->current.pixels.size());
  std::vector<uint8_t>().swap(l->current.pixels);
}

// Drops the tasks not yet started, waits for the running ones and frees
// the loader.
void sdt_loader_destroy(void* loader) {
  Loader* l = static_cast<Loader*>(loader);
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->stop = true;
    l->tasks.clear();
  }
  l->cv_task.notify_all();
  for (auto& t : l->workers) t.join();
  delete l;
}

}  // extern "C"
