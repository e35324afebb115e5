// SGILog decoder of the host library's TIFF reader (tiff_host.cpp), as
// libtiff's tif_luv.c decodes a strip or tile for its RGBA reader, which
// asks for 8-bit output (SGILOGDATAFMT_8BIT):
//
// * LogL (compression 34676, photometric 32844): 16-bit log luminance,
//   each row coded as its high bytes, then its low bytes, in runs (a byte
//   of 128 + n - 2, then the byte to repeat n times) and literal strings (a
//   byte of n, then n bytes); the luminance Y = 2 ^ ((Le + 0.5) / 256 - 64)
//   (negative where the sign bit is set, 0 for Le 0) becomes the gray
//   (int) (256 sqrt(Y)), 0 at or below 0 and 255 from 1 up (L16toGry).
// * LogLuv 32 (34676, photometric 32845): words of 16-bit log luminance
//   and 8-bit u' and v' (in 1 / 410 steps), coded as four byte strings of
//   the same runs.
// * LogLuv 24 (34677): packed 3-byte words of 10-bit log luminance (Y = 2
//   ^ ((Le + 0.5) / 64 - 12)) and a 14-bit index into the (u', v') grid of
//   sgilog_tables.h (uv_decode; past the grid, the neutral u', v').
//
// LogLuv becomes XYZ in libtiff's double steps, rounded to float, and RGB
// by XYZtoRGB24 (CCIR-709 primaries, a gamma of 2: (int) (256 sqrt(c))).
// A row that ends before its pixels do fails as libtiff fails it.

#include <cmath>
#include <cstdint>
#include <string>
#include <vector>

#include "host.h"
#include "sgilog_tables.h"

namespace sdt {

namespace {

constexpr double kLn2 = 0.69314718055994530942;  // M_LN2
constexpr double kUvScale = 410.;
constexpr double kUNeu = 0.210526316, kVNeu = 0.473684211;

double logl16_to_y(int p16) {
  const int le = p16 & 0x7fff;
  if (!le) return 0.;
  const double y = std::exp(kLn2 / 256. * (le + .5) - kLn2 * 64.);
  return !(p16 & 0x8000) ? y : -y;
}

double logl10_to_y(int p10) {
  if (p10 == 0) return 0.;
  return std::exp(kLn2 / 64. * (p10 + .5) - kLn2 * 12.);
}

uint8_t gamma8(double c) {
  return static_cast<uint8_t>(c <= 0. ? 0 : c >= 1. ? 255
                              : static_cast<int>(256. * std::sqrt(c)));
}

void xyz_to_rgb24(const float* xyz, uint8_t* rgb) {
  const double r = 2.690 * xyz[0] + -1.276 * xyz[1] + -0.414 * xyz[2];
  const double g = -1.022 * xyz[0] + 1.978 * xyz[1] + 0.044 * xyz[2];
  const double b = 0.061 * xyz[0] + -0.224 * xyz[1] + 1.163 * xyz[2];
  rgb[0] = gamma8(r);
  rgb[1] = gamma8(g);
  rgb[2] = gamma8(b);
}

void uv_to_xyz(double L, double u, double v, float* xyz) {
  const double s = 1. / (6. * u - 16. * v + 12.);
  const double x = 9. * u * s;
  const double y = 4. * v * s;
  xyz[0] = static_cast<float>(x / y * L);
  xyz[1] = static_cast<float>(L);
  xyz[2] = static_cast<float>((1. - x - y) / y * L);
}

void luv32_to_rgb(uint32_t p, uint8_t* rgb) {
  float xyz[3] = {0.f, 0.f, 0.f};
  const double L = logl16_to_y(static_cast<int32_t>(p) >> 16);
  if (L > 0.)
    uv_to_xyz(L, 1. / kUvScale * ((p >> 8 & 0xff) + .5),
              1. / kUvScale * ((p & 0xff) + .5), xyz);
  xyz_to_rgb24(xyz, rgb);
}

void luv24_to_rgb(uint32_t p, uint8_t* rgb) {
  float xyz[3] = {0.f, 0.f, 0.f};
  const double L = logl10_to_y(p >> 14 & 0x3ff);
  if (L > 0.) {
    const int c = static_cast<int>(p & 0x3fff);
    double u = kUNeu, v = kVNeu;
    if (c < sgilog::kUvNdivs) {  // uv_decode's binary search
      int lower = 0, upper = sgilog::kUvNvs;
      while (upper - lower > 1) {
        const int vi = (lower + upper) >> 1;
        const int ui = c - sgilog::kUvRow[vi].ncum;
        if (ui > 0) {
          lower = vi;
        } else if (ui < 0) {
          upper = vi;
        } else {
          lower = vi;
          break;
        }
      }
      const int ui = c - sgilog::kUvRow[lower].ncum;
      u = sgilog::kUvRow[lower].ustart + (ui + .5) * sgilog::kUvSqsiz;
      v = sgilog::kUvVstart + (lower + .5) * sgilog::kUvSqsiz;
    }
    uv_to_xyz(L, u, v, xyz);
  }
  xyz_to_rgb24(xyz, rgb);
}

// the byte strings of one row of LogL16Decode / LogLuvDecode32: `planes`
// strings, the first the most significant, OR-ed into words
template <typename Word>
bool run_strings(const uint8_t** bp, long* cc, Word* tp, long npixels,
                 int planes) {
  for (int k = 0; k < npixels; ++k) tp[k] = 0;
  for (int shft = 8 * (planes - 1); shft >= 0; shft -= 8) {
    long i = 0;
    while (i < npixels && *cc > 0) {
      if (**bp >= 128) {  // a run
        if (*cc < 2) break;
        int rc = *(*bp)++ + (2 - 128);
        const Word b = static_cast<Word>(static_cast<uint32_t>(*(*bp)++)
                                         << shft);
        *cc -= 2;
        while (rc-- && i < npixels) tp[i++] |= b;
      } else {  // a literal string (a nul is a no-op)
        int rc = *(*bp)++;
        while (--*cc && rc-- && i < npixels)
          tp[i++] |= static_cast<Word>(static_cast<uint32_t>(*(*bp)++)
                                       << shft);
      }
    }
    if (i != npixels) return false;
  }
  return true;
}

}  // namespace

int sgilog_decode(const uint8_t* src, long len, int kind, long width,
                  long rows, uint8_t* out) {
  const uint8_t* bp = src;
  long cc = len;
  std::vector<uint32_t> words(width);
  std::vector<int16_t> l16(width);
  for (long y = 0; y < rows; ++y) {
    bool ok;
    if (kind == kSgiLogL) {
      ok = run_strings(&bp, &cc, l16.data(), width, 2);
      if (ok)
        for (long x = 0; x < width; ++x)
          out[y * width + x] = gamma8(logl16_to_y(l16[x]));
    } else if (kind == kSgiLogLuv32) {
      ok = run_strings(&bp, &cc, words.data(), width, 4);
      if (ok)
        for (long x = 0; x < width; ++x)
          luv32_to_rgb(words[x], out + 3 * (y * width + x));
    } else {
      long i = 0;
      for (; i < width && cc >= 3; ++i, bp += 3, cc -= 3)
        words[i] = static_cast<uint32_t>(bp[0]) << 16 | bp[1] << 8 | bp[2];
      ok = i == width;
      if (ok)
        for (long x = 0; x < width; ++x)
          luv24_to_rgb(words[x], out + 3 * (y * width + x));
    }
    if (!ok) {
      set_error("TIFF: damaged data: SGILog data ends before row " +
                std::to_string(y) + " of the strip does");
      return kCorrupt;
    }
  }
  return kOk;
}

}  // namespace sdt
