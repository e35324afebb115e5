// PFM and Radiance HDR decoders of the host library, to the pixels
// cv2.imread (IMREAD_COLOR, BGR turned to RGB) gives the JAX package's
// loader: OpenCV 5.0's PFMDecoder (grfmt_pfm.cpp) and HdrDecoder
// (grfmt_hdr.cpp over its rgbe.cpp). Both read float pixels and cv2 turns
// them to 8 bits by Mat::convertTo, whose rounding this file repeats in the
// same float32 operations: cvRound (the nearest, ties to even; NaN and
// values outside the int range give INT_MIN), then saturation to 0..255,
// so a NaN, an infinity or a value of 2 ** 31 or more reads 0.
//
// PFM: "PF\n" (three samples; "Pf", one sample, cv2 returns a one-channel
// picture that the JAX loader's colour conversion refuses), then width,
// height and scale, each ended by one whitespace byte; little-endian
// samples where the scale is negative, rows bottom-up; each sample times
// (float) (1 / |scale|), then rounded as above.
//
// HDR: rgbe.cpp's header (lines of fgets' 128-byte buffer up to a blank
// line, one of them "FORMAT=32-bit_rle_rgbe"), then "-Y H +X W" (no other
// orientation); scanlines in the new run-length encoding (02 02, the width,
// four components of runs and literals) until the first that is not, from
// which the rest of the picture is read as flat RGBE pixels (the whole
// picture where W < 8 or W > 32767; old-style run-length pixels are read as
// flat pixels too, so a file that holds such runs ends short). RGBE e > 0 is
// m * 2 ** (e - 136) in float, then times 255.0f and rounded as above.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "host.h"

namespace sdt {

namespace {

// saturate_cast<uchar>(float) as OpenCV computes it
uint8_t to_u8(float v) {
  int32_t i;
  if (!(v >= -2147483648.0f && v < 2147483648.0f)) {
    i = INT32_MIN;
  } else {
    i = static_cast<int32_t>(std::nearbyint(v));
  }
  return static_cast<uint8_t>(i < 0 ? 0 : i > 255 ? 255 : i);
}

int pfm_bad(const std::string& what) {
  set_error("PFM: damaged data: " + what);
  return kCorrupt;
}

int pfm_refused(const std::string& what) {
  set_error("PFM: " + what + " (cv2 refuses it too)");
  return kUnsupported;
}

struct Pfm {
  int w, h, ch;
  double scale;
  long data;
};

// PFMDecoder's read_number: bytes up to one whitespace byte, as a string
bool pfm_token(const uint8_t* d, long n, long* p, std::string* tok) {
  tok->clear();
  while (*p < n) {
    const uint8_t c = d[(*p)++];
    if (c >= 128) return false;
    if (std::isspace(c)) return true;
    tok->push_back(static_cast<char>(c));
    if (tok->size() >= 2048) return true;
  }
  return false;
}

int pfm_parse(const uint8_t* d, long n, Pfm* f) {
  if (n < 3 || d[2] != '\n') return pfm_bad("a header that does not parse");
  f->ch = d[1] == 'F' ? 3 : 1;
  long p = 3;
  std::string w, h, s;
  if (!pfm_token(d, n, &p, &w) || !pfm_token(d, n, &p, &h) ||
      !pfm_token(d, n, &p, &s))
    return pfm_bad("a header that does not parse");
  const long wi = std::atol(w.c_str()), hi = std::atol(h.c_str());
  if (wi <= 0 || hi <= 0 || wi > (1L << 24) || hi > (1L << 24))
    return pfm_refused("a size of " + w + "x" + h);
  f->w = static_cast<int>(wi);
  f->h = static_cast<int>(hi);
  f->scale = std::atof(s.c_str());
  f->data = p;
  if (f->ch == 1)
    return pfm_refused("one-channel PFM (Pf), which cv2 returns as one "
                       "channel");
  if (!(std::fabs(f->scale) > 0.0)) return pfm_refused("a scale of " + s);
  return kOk;
}

int pfm_pixels(const uint8_t* d, long n, const Pfm& f, uint8_t* out) {
  const long row = static_cast<long>(f.w) * f.ch;
  if (f.data + 4 * row * f.h > n) return pfm_bad("file ends before its pixels");
  const bool big = f.scale >= 0.0;
  const float a = static_cast<float>(1.0 / std::fabs(f.scale));
  for (int y = 0; y < f.h; ++y) {  // rows bottom-up
    const uint8_t* s = d + f.data + 4 * row * (f.h - 1 - y);
    uint8_t* o = out + static_cast<long>(y) * row;
    for (long i = 0; i < row; ++i, s += 4) {
      const uint32_t u = big ? (uint32_t{s[0]} << 24) | (s[1] << 16) |
                                   (s[2] << 8) | s[3]
                             : (uint32_t{s[3]} << 24) | (s[2] << 16) |
                                   (s[1] << 8) | s[0];
      float v;
      std::memcpy(&v, &u, 4);
      o[i] = to_u8(v * a);
    }
  }
  return kOk;
}

int hdr_bad(const std::string& what) {
  set_error("HDR: damaged data: " + what);
  return kCorrupt;
}

struct Hdr {
  int w, h;
  long data;
};

// fgets into a 128-byte buffer: up to and with a newline, or 127 bytes
bool hdr_line(const uint8_t* d, long n, long* p, std::string* line) {
  line->clear();
  if (*p >= n) return false;
  while (*p < n && line->size() < 127) {
    const char c = static_cast<char>(d[(*p)++]);
    line->push_back(c);
    if (c == '\n') break;
  }
  return true;
}

// sscanf's %d at *s (leading whitespace, a sign, at least one digit)
bool scan_int(const char** s, long* v) {
  const char* q = *s;
  while (std::isspace(static_cast<unsigned char>(*q))) ++q;
  char* end;
  *v = std::strtol(q, &end, 10);
  if (end == q) return false;
  *s = end;
  return true;
}

int hdr_parse(const uint8_t* d, long n, Hdr* h) {
  long p = 0;
  std::string line;
  bool format = false;
  if (!hdr_line(d, n, &p, &line)) return hdr_bad("file ends inside its header");
  while (!(line.empty() || line[0] == '\0' || line[0] == '\n')) {
    if (line == "FORMAT=32-bit_rle_rgbe\n") format = true;
    if (!hdr_line(d, n, &p, &line))
      return hdr_bad("file ends inside its header");
  }
  if (!format) {
    set_error("HDR: no FORMAT=32-bit_rle_rgbe line (cv2 refuses it too)");
    return kUnsupported;
  }
  if (!hdr_line(d, n, &p, &line)) return hdr_bad("file ends inside its header");
  // sscanf(buf, "-Y %d +X %d", &height, &width) == 2
  const char* s = line.c_str();
  long hh = 0, ww = 0;
  bool ok = s[0] == '-' && s[1] == 'Y';
  if (ok) {
    s += 2;
    ok = scan_int(&s, &hh);
  }
  if (ok) {
    while (std::isspace(static_cast<unsigned char>(*s))) ++s;
    ok = s[0] == '+' && s[1] == 'X';
    if (ok) {
      s += 2;
      ok = scan_int(&s, &ww);
    }
  }
  if (!ok) {
    set_error("HDR: a resolution line other than \"-Y H +X W\" (cv2 refuses "
              "it too)");
    return kUnsupported;
  }
  if (hh <= 0 || ww <= 0 || hh > (1L << 24) || ww > (1L << 24)) {
    set_error("HDR: a size of " + std::to_string(hh) + "x" +
              std::to_string(ww) + " (cv2 refuses it too)");
    return kUnsupported;
  }
  h->h = static_cast<int>(hh);
  h->w = static_cast<int>(ww);
  h->data = p;
  return kOk;
}

// rgbe2float's scale of each exponent byte: (float) ldexp(1.0, e - 136)
struct RgbeScale {
  float f[256];
  RgbeScale() {
    for (int e = 0; e < 256; ++e)
      f[e] = static_cast<float>(std::ldexp(1.0, e - (128 + 8)));
  }
};

void rgbe_put(const uint8_t* e, uint8_t* o) {
  static const RgbeScale scale;
  if (!e[3]) {
    o[0] = o[1] = o[2] = 0;
    return;
  }
  const float f = scale.f[e[3]];
  for (int c = 0; c < 3; ++c) o[c] = to_u8(static_cast<float>(e[c] * f) * 255.0f);
}

int hdr_pixels(const uint8_t* d, long n, const Hdr& h, uint8_t* out) {
  long p = h.data;
  const long total = static_cast<long>(h.w) * h.h;
  auto flat = [&](long from) -> int {  // RGBE_ReadPixels
    const long want = total - from;
    if (p + 4 * want > n) {
      for (long q = p; q + 4 <= n; q += 4)
        if (d[q] == 1 && d[q + 1] == 1 && d[q + 2] == 1) {  // old-style run
          set_error("HDR: old-style run-length pixels, which cv2 reads as "
                    "flat pixels, so the file ends before its pixels (cv2 "
                    "refuses it too)");
          return kUnsupported;
        }
      return hdr_bad("file ends before its pixels");
    }
    for (long i = 0; i < want; ++i) rgbe_put(d + p + 4 * i, out + 3 * (from + i));
    return kOk;
  };
  if (h.w < 8 || h.w > 0x7fff) return flat(0);
  std::vector<uint8_t> line(4L * h.w);
  for (int y = 0; y < h.h; ++y) {
    if (p + 4 > n) return hdr_bad("file ends before its pixels");
    const uint8_t* e = d + p;
    if (e[0] != 2 || e[1] != 2 || (e[2] & 0x80)) return flat(static_cast<long>(y) * h.w);
    if (((e[2] << 8) | e[3]) != h.w) return hdr_bad("wrong scanline width");
    p += 4;
    for (int c = 0; c < 4; ++c) {
      uint8_t* q = line.data() + static_cast<long>(c) * h.w;
      uint8_t* end = q + h.w;
      while (q < end) {
        if (p + 2 > n) return hdr_bad("file ends inside a scanline");
        int count = d[p];
        if (count > 128) {
          count -= 128;
          if (count > end - q) return hdr_bad("bad scanline data");
          std::memset(q, d[p + 1], count);
          q += count;
          p += 2;
        } else {
          if (count == 0 || count > end - q) return hdr_bad("bad scanline data");
          if (p + 1 + count > n) return hdr_bad("file ends inside a scanline");
          std::memcpy(q, d + p + 1, count);
          q += count;
          p += 1 + count;
        }
      }
    }
    uint8_t* o = out + static_cast<long>(y) * h.w * 3;
    for (int x = 0; x < h.w; ++x) {
      const uint8_t e4[4] = {line[x], line[h.w + x], line[2L * h.w + x],
                             line[3L * h.w + x]};
      rgbe_put(e4, o + 3 * x);
    }
  }
  return kOk;
}

}  // namespace

bool is_pfm(const uint8_t* d, long n) {
  return n >= 3 && d[0] == 'P' && (d[1] == 'F' || d[1] == 'f') &&
         std::isspace(d[2]);
}

int pfm_info(const uint8_t* d, long n, int* h, int* w) {
  Pfm f;
  const int st = pfm_parse(d, n, &f);
  if (st) return st;
  *h = f.h;
  *w = f.w;
  return kOk;
}

int pfm_decode(const uint8_t* d, long n, uint8_t* out, int h, int w) {
  Pfm f;
  const int st = pfm_parse(d, n, &f);
  if (st) return st;
  if (f.h != h || f.w != w) {
    set_error("PFM size differs from the size asked for");
    return kSizeMismatch;
  }
  return pfm_pixels(d, n, f, out);
}

bool is_hdr(const uint8_t* d, long n) {
  return (n >= 10 && std::memcmp(d, "#?RADIANCE", 10) == 0) ||
         (n >= 6 && std::memcmp(d, "#?RGBE", 6) == 0);
}

int hdr_info(const uint8_t* d, long n, int* h, int* w) {
  Hdr r;
  const int st = hdr_parse(d, n, &r);
  if (st) return st;
  *h = r.h;
  *w = r.w;
  return kOk;
}

int hdr_decode(const uint8_t* d, long n, uint8_t* out, int h, int w) {
  Hdr r;
  const int st = hdr_parse(d, n, &r);
  if (st) return st;
  if (r.h != h || r.w != w) {
    set_error("HDR size differs from the size asked for");
    return kSizeMismatch;
  }
  return hdr_pixels(d, n, r, out);
}

}  // namespace sdt
