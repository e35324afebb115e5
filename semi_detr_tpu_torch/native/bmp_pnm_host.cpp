// BMP and PNM decoders of the host library, to the pixels cv2.imread
// (IMREAD_COLOR, BGR turned to RGB) gives the JAX package's loader for these
// files: OpenCV 5.0's BmpDecoder and PxMDecoder, quirks included.
//
// BMP: the OS/2 1.x core header (12 bytes) and every header of at least 36
// bytes (Windows 3.x, OS/2 2.x, V4, V5), top-down or bottom-up; 1, 4 and 8
// bits through a palette (entries past the ones the file holds are black),
// 16 bits as 5-5-5 (BI_RGB, or BI_BITFIELDS with those masks) or 5-6-5
// (BI_BITFIELDS), each field shifted up without filling its low bits; 24
// bits; 32 bits as B, G, R and a dropped fourth byte whatever the masks;
// RLE8 and RLE4 with OpenCV's run semantics (a run that would cross the end
// of its row fails; the pixels an end of line, a delta or an end of bitmap
// skips are palette entry 0; RLE4's end of bitmap fills only the rest of
// its row and reading goes on). OpenCV reads the 16-bit masks from the 12
// bytes after the whole info header, so a V4 or V5 header's own masks are
// not the ones it checks.
//
// PNM: P1-P6. ASCII samples (P1, P2, P3) above maxval are clamped to it,
// then a maxval below 256 scales them by 255 / maxval (rounded down); binary
// samples (P5, P6) of a maxval below 256 are taken as they are; a maxval of
// 256-65535 gives 16-bit samples (big-endian in P5 / P6) whose high byte is
// the pixel. P1 and P4 bits of 1 are black.
//
// PAM (P7), OpenCV's PAMDecoder: header lines of WIDTH, HEIGHT, DEPTH 1-4,
// MAXVAL 1-65535 and TUPLTYPE up to ENDHDR, comments skipped. The tuple
// type must fit the depth (BLACKANDWHITE or GRAYSCALE 1, GRAYSCALE_ALPHA 2,
// RGB 3, RGB_ALPHA 4); without one, depth 1 or 3 of a maxval below 256 is
// gray or RGB and the rest is refused. Samples are bytes, or big-endian
// 16-bit words above maxval 255 of which the high byte is the pixel (no
// scaling to maxval). cv2's quirks: an RGB tuple reaches cv2's BGR picture
// unswapped, so the red sample reads as blue; a maxval of 1 takes each
// row's sample bytes as packed bits (pixel x is bit 7 - x % 8 of byte
// x / 8: 255 where set); GRAYSCALE_ALPHA and RGB_ALPHA give the first
// sample, or the first three, of each pixel, where cv2 converts only the
// first w / depth pixels of a row and leaves the rest of its picture
// unset (the JAX loader's pixels there are whatever memory held).

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "host.h"

namespace sdt {

namespace {

int bad(const char* fmt, const std::string& what) {
  set_error(std::string(fmt) + ": " + what);
  return kCorrupt;
}

uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}

uint16_t le16(const uint8_t* p) { return uint16_t(p[0] | (p[1] << 8)); }

// ------------------------------------------------------------------- BMP

enum BmpCode { kBiRgb = 0, kRle8 = 1, kRle4 = 2, kBitfields = 3 };

struct Bmp {
  int w = 0, h = 0, bpp = 0, code = 0;  // bpp 15: 5-5-5
  bool top_down = false;
  long offset = 0;
  uint8_t pal[256][3];  // RGB
};

int bmp_header(const uint8_t* d, long n, Bmp* b) {
  if (n < 18) return bad("BMP", "file ends inside its header");
  b->offset = le32(d + 10);
  const long size = le32(d + 14);
  std::memset(b->pal, 0, sizeof(b->pal));
  if (size >= 36) {
    if (n < 14 + 36) return bad("BMP", "file ends inside its header");
    b->w = static_cast<int32_t>(le32(d + 18));
    const int32_t h = static_cast<int32_t>(le32(d + 22));
    b->bpp = le16(d + 28);
    const uint32_t code = le32(d + 30);
    const uint32_t used = le32(d + 46);
    if (code > kBitfields) return bad("BMP", "unknown compression");
    b->code = static_cast<int>(code);
    b->top_down = h < 0;
    b->h = h < 0 ? -h : h;
    const int bpp = b->bpp;
    const bool ok =
        b->w > 0 && h != 0 && h != INT32_MIN &&
        (((bpp == 1 || bpp == 4 || bpp == 8 || bpp == 24 || bpp == 32) &&
          code == kBiRgb) ||
         ((bpp == 16 || bpp == 32) && (code == kBiRgb || code == kBitfields)) ||
         (bpp == 4 && code == kRle4) || (bpp == 8 && code == kRle8));
    if (!ok) {
      set_error("BMP: " + std::to_string(bpp) + " bits under compression " +
                std::to_string(code) + " (cv2 reads neither)");
      return kUnsupported;
    }
    const long after = 14 + size;
    if (bpp <= 8) {
      if (used > 256) return bad("BMP", "more than 256 palette entries");
      const long count = used ? used : (1L << bpp);
      if (after + 4 * count > n) return bad("BMP", "file ends in its palette");
      for (long i = 0; i < count; ++i) {
        const uint8_t* e = d + after + 4 * i;
        b->pal[i][0] = e[2];
        b->pal[i][1] = e[1];
        b->pal[i][2] = e[0];
      }
    } else if (bpp == 16 && code == kBitfields) {
      if (after + 12 > n) return bad("BMP", "file ends in its bit masks");
      const uint32_t r = le32(d + after), g = le32(d + after + 4),
                     bl = le32(d + after + 8);
      if (bl == 0x1f && g == 0x3e0 && r == 0x7c00) {
        b->bpp = 15;
      } else if (!(bl == 0x1f && g == 0x7e0 && r == 0xf800)) {
        set_error("BMP: 16-bit masks other than 5-5-5 and 5-6-5 (cv2 reads "
                  "neither)");
        return kUnsupported;
      }
    } else if (bpp == 16) {
      b->bpp = 15;
    }
  } else if (size == 12) {
    if (n < 14 + 12) return bad("BMP", "file ends inside its header");
    b->w = le16(d + 18);
    b->h = le16(d + 20);
    b->bpp = le16(d + 24);
    b->code = kBiRgb;
    const int bpp = b->bpp;
    if (!(b->w > 0 && b->h > 0 &&
          (bpp == 1 || bpp == 4 || bpp == 8 || bpp == 24 || bpp == 32))) {
      set_error("BMP: an OS/2 core header of " + std::to_string(bpp) +
                " bits (cv2 reads none)");
      return kUnsupported;
    }
    if (bpp <= 8) {
      const long count = 1L << bpp;
      if (26 + 3 * count > n) return bad("BMP", "file ends in its palette");
      for (long i = 0; i < count; ++i) {
        const uint8_t* e = d + 26 + 3 * i;
        b->pal[i][0] = e[2];
        b->pal[i][1] = e[1];
        b->pal[i][2] = e[0];
      }
    }
  } else {
    set_error("BMP: an info header of " + std::to_string(size) +
              " bytes (cv2 reads none)");
    return kUnsupported;
  }
  if (b->offset < 14 || b->offset > n) return bad("BMP", "bad data offset");
  return kOk;
}

// OpenCV's run-length decode: `data` walks rows of w pixels from the first
// one the file stores; reaching a row's end moves to the next (*y counts
// them). Returns kOk, or kCorrupt for a run past its row or data that ends
// before the picture does.
struct RleOut {
  uint8_t* out;
  int w, h;
  bool top_down;
  int y = 0, x = 0;
  uint8_t* px() {
    const int row = top_down ? y : h - 1 - y;
    return out + (static_cast<long>(row) * w + x) * 3;
  }
  // FillUniColor: count pixels of colour c, moving on to the next row at a
  // row's end; stops when the rows run out
  void fill(long count, const uint8_t* c) {
    do {
      const long here = std::min<long>(count, w - x);
      for (long i = 0; i < here; ++i) {
        std::memcpy(px(), c, 3);
        ++x;
      }
      count -= here;
      if (x >= w) {
        x = 0;
        if (++y >= h) break;
      }
    } while (count > 0);
  }
};

int bmp_rle(const uint8_t* d, long n, const Bmp& b, uint8_t* out) {
  RleOut o{out, b.w, b.h, b.top_down};
  long pos = b.offset;
  const bool four = b.code == kRle4;
  bool line_end_flag = false;
  auto ended = [&]() { return bad("BMP", "RLE data ends before the picture"); };
  for (;;) {
    if (pos + 2 > n) return ended();
    int len = d[pos], code = d[pos + 1];
    pos += 2;
    if (len) {  // encoded run
      if (o.x + len > b.w) return bad("BMP", "an RLE run past its row");
      if (four) {
        const uint8_t* c[2] = {b.pal[code >> 4], b.pal[code & 15]};
        for (int i = 0; i < len; ++i) {
          std::memcpy(o.px(), c[i & 1], 3);
          ++o.x;
        }
      } else {
        const int prev = o.y;
        o.fill(len, b.pal[code]);
        line_end_flag = o.y != prev;
        if (o.y >= b.h) break;
      }
    } else if (code > 2) {  // absolute run
      if (o.x + code > b.w) return bad("BMP", "an RLE run past its row");
      const long sz = four ? (((code + 1) >> 1) + 1) & ~1 : (code + 1) & ~1;
      if (pos + sz > n) return ended();
      for (int i = 0; i < code; ++i) {
        const int v = four ? (d[pos + i / 2] >> (i & 1 ? 0 : 4)) & 15
                           : d[pos + i];
        std::memcpy(o.px(), b.pal[v], 3);
        ++o.x;
      }
      pos += sz;
      if (!four) line_end_flag = false;
    } else {  // 0 end of line, 1 end of bitmap, 2 delta
      long xs = b.w - o.x, ys = b.h - o.y;
      if (four) {
        if (code == 2) {
          if (pos + 2 > n) return ended();
          xs = d[pos];
          pos += 2;
        }
        o.fill(xs, b.pal[0]);  // OpenCV fills x_shift3 alone here
        if (o.y >= b.h) break;
        continue;
      }
      if (code || !line_end_flag || xs < b.w) {
        if (code == 2) {
          if (pos + 2 > n) return ended();
          xs = d[pos];
          ys = d[pos + 1];
          pos += 2;
        }
        if (code) xs += ys * b.w;
        if (o.y >= b.h) break;
        o.fill(xs, b.pal[0]);
        if (o.y >= b.h) break;
      }
      line_end_flag = false;
      if (o.y >= b.h) break;
    }
  }
  return kOk;
}

int bmp_pixels(const uint8_t* d, long n, const Bmp& b, uint8_t* out) {
  if (b.code == kRle8 || b.code == kRle4) return bmp_rle(d, n, b, out);
  const int bits = b.bpp == 15 ? 16 : b.bpp;
  const long stride = ((static_cast<long>(b.w) * bits + 7) / 8 + 3) & ~3L;
  if (b.offset + stride * b.h > n)
    return bad("BMP", "file ends before its last row");
  for (int r = 0; r < b.h; ++r) {
    const uint8_t* s = d + b.offset + stride * r;
    uint8_t* o = out + static_cast<long>(b.top_down ? r : b.h - 1 - r) *
                           b.w * 3;
    for (int x = 0; x < b.w; ++x, o += 3) {
      switch (b.bpp) {
        case 1: case 4: case 8: {
          const long bit = static_cast<long>(x) * b.bpp;
          const int v = (s[bit >> 3] >> (8 - b.bpp - (bit & 7))) &
                        ((1 << b.bpp) - 1);
          std::memcpy(o, b.pal[v], 3);
          break;
        }
        case 15: case 16: {
          const int t = le16(s + 2 * x);
          o[2] = static_cast<uint8_t>(t << 3);
          if (b.bpp == 15) {
            o[1] = static_cast<uint8_t>((t >> 2) & ~7);
            o[0] = static_cast<uint8_t>((t >> 7) & ~7);
          } else {
            o[1] = static_cast<uint8_t>((t >> 3) & ~3);
            o[0] = static_cast<uint8_t>((t >> 8) & ~7);
          }
          break;
        }
        default: {  // 24, 32: B, G, R (and a dropped byte)
          const uint8_t* p = s + static_cast<long>(x) * (b.bpp / 8);
          o[0] = p[2];
          o[1] = p[1];
          o[2] = p[0];
        }
      }
    }
  }
  return kOk;
}

// ------------------------------------------------------------------- PNM

struct Pnm {
  int kind = 0, w = 0, h = 0, maxval = 1;
  long data = 0;  // first byte after the header
};

// OpenCV's ReadNumber: whitespace and '#' comments skipped, the digits
// read (at most max_digits of them where it is > 0), the byte after them
// consumed; -1 at the end of the data or on another byte
long read_number(const uint8_t* d, long n, long* pos, int max_digits = 0) {
  auto get = [&]() { return *pos < n ? d[(*pos)++] : -1; };
  int c = get();
  while (c >= 0 && !std::isdigit(c)) {
    if (c == '#') {
      do c = get(); while (c >= 0 && c != '\n' && c != '\r');
      if (c < 0) return -1;
      c = get();
    } else if (std::isspace(c)) {
      while (c >= 0 && std::isspace(c)) c = get();
    } else {
      return -1;
    }
  }
  if (c < 0) return -1;
  long v = 0;
  int digits = 0;
  do {
    v = v * 10 + (c - '0');
    if (v > 2147483647L) return -1;
    if (max_digits && ++digits >= max_digits) break;
    c = get();
  } while (c >= 0 && std::isdigit(c));
  return v;
}

int pnm_header(const uint8_t* d, long n, Pnm* p) {
  p->kind = d[1] - '0';
  long pos = 2;
  const long w = read_number(d, n, &pos), h = read_number(d, n, &pos);
  long maxval = 1;
  if (p->kind != 1 && p->kind != 4) maxval = read_number(d, n, &pos);
  if (w < 0 || h < 0 || maxval < 0)
    return bad("PNM", "a header that does not parse");
  if (w == 0 || h == 0 || maxval == 0 || maxval > 65535)
    return bad("PNM", "a size or maxval out of range");
  if (w > 65535 * 16L || h > 65535 * 16L)
    return bad("PNM", "a size out of range");
  p->w = static_cast<int>(w);
  p->h = static_cast<int>(h);
  p->maxval = static_cast<int>(maxval);
  p->data = pos;
  return kOk;
}

int pnm_pixels(const uint8_t* d, long n, const Pnm& p, uint8_t* out) {
  const int ch = (p.kind == 3 || p.kind == 6) ? 3 : 1;
  const bool wide = p.maxval > 255;
  const long count = static_cast<long>(p.w) * p.h * ch;
  auto put = [&](long i, int v) {  // sample i (of the file's channels)
    if (ch == 3) {
      out[i] = static_cast<uint8_t>(v);
    } else {
      uint8_t* o = out + 3 * i;
      o[0] = o[1] = o[2] = static_cast<uint8_t>(v);
    }
  };
  long pos = p.data;
  if (p.kind == 4) {
    const long row = (p.w + 7) / 8;
    if (pos + row * p.h > n) return bad("PNM", "file ends before its data");
    for (int y = 0; y < p.h; ++y)
      for (int x = 0; x < p.w; ++x)
        put(static_cast<long>(y) * p.w + x,
            (d[pos + y * row + x / 8] >> (7 - x % 8)) & 1 ? 0 : 255);
    return kOk;
  }
  if (p.kind >= 5) {
    const int bytes = wide ? 2 : 1;
    if (pos + count * bytes > n) return bad("PNM", "file ends before its data");
    for (long i = 0; i < count; ++i)
      put(i, wide ? d[pos + 2 * i] : d[pos + i]);
    return kOk;
  }
  for (long i = 0; i < count; ++i) {  // ASCII
    long v = read_number(d, n, &pos, p.kind == 1 ? 1 : 0);
    if (v < 0) return bad("PNM", "ASCII data ends or does not parse");
    if (v > p.maxval) v = p.maxval;
    if (p.kind == 1) {
      put(i, v ? 0 : 255);
    } else {
      put(i, wide ? static_cast<int>(v >> 8)
                  : static_cast<int>(v * 255 / p.maxval));
    }
  }
  return kOk;
}

// ------------------------------------------------------------------- PAM

struct Pam {
  int w = 0, h = 0, depth = 0, maxval = 0;
  long data = 0;
};

int pam_refused(const std::string& what) {
  set_error("PAM: " + what + " (cv2 refuses it too)");
  return kUnsupported;
}

// OpenCV's ReadPAMHeaderLine: a field name of at most 8 bytes and its value,
// the rest of the line; *name is empty for a comment
bool pam_line(const uint8_t* d, long n, long* p, std::string* name,
              std::string* value) {
  auto get = [&]() -> int { return *p < n ? d[(*p)++] : -1; };
  int c;
  do c = get(); while (c >= 0 && std::isspace(c));
  if (c < 0) return false;
  name->clear();
  value->clear();
  if (c == '#') {
    do c = get(); while (c >= 0 && c != '\n' && c != '\r');
    return c >= 0;
  }
  for (int i = 0; i < 8 && c >= 0 && !std::isspace(c); ++i) {
    name->push_back(static_cast<char>(c));
    c = get();
  }
  if (c < 0 || !std::isspace(c)) return false;
  if (c == '\n' || c == '\r') return true;
  do c = get(); while (c >= 0 && std::isspace(c));
  while (c >= 0 && c != '\n' && c != '\r') {
    value->push_back(static_cast<char>(c));
    if (value->size() >= 255) return false;
    c = get();
  }
  return c >= 0;
}

int pam_header(const uint8_t* d, long n, Pam* m) {
  long p = 3;
  bool end = false, hw = false, hh = false, hd = false, hm = false;
  std::string name, value, tupl;
  bool has_tupl = false;
  while (!end) {
    if (!pam_line(d, n, &p, &name, &value))
      return bad("PAM", "a header that does not parse");
    const long v = std::atol(value.c_str());
    if (name.empty()) continue;  // a comment
    if (name == "ENDHDR") {
      end = true;
    } else if (name == "WIDTH") {
      m->w = static_cast<int>(v), hw = true;
    } else if (name == "HEIGHT") {
      m->h = static_cast<int>(v), hh = true;
    } else if (name == "DEPTH") {
      m->depth = static_cast<int>(v), hd = true;
    } else if (name == "MAXVAL") {
      m->maxval = static_cast<int>(v), hm = true;
    } else if (name == "TUPLTYPE") {
      tupl = value, has_tupl = true;
    } else {
      return bad("PAM", "an unknown header field " + name);
    }
  }
  if (!hw || !hh || !hd || !hm) return bad("PAM", "a header field missing");
  if (m->w <= 0 || m->h <= 0 || m->w > 65535 * 16 || m->h > 65535 * 16)
    return bad("PAM", "a size out of range");
  if (m->depth < 1 || m->depth > 4)
    return pam_refused("depth " + std::to_string(m->depth));
  if (m->maxval < 1 || m->maxval > 65535)
    return pam_refused("maxval " + std::to_string(m->maxval));
  int want;
  if (!has_tupl) {
    if (m->maxval > 255 || (m->depth != 1 && m->depth != 3))
      return pam_refused("no TUPLTYPE at depth " + std::to_string(m->depth) +
                         ", maxval " + std::to_string(m->maxval));
    want = m->depth;
  } else if (tupl == "BLACKANDWHITE" || tupl == "GRAYSCALE") {
    want = 1;
  } else if (tupl == "GRAYSCALE_ALPHA") {
    want = 2;
  } else if (tupl == "RGB") {
    want = 3;
  } else if (tupl == "RGB_ALPHA") {
    want = 4;
  } else {
    return pam_refused("TUPLTYPE " + tupl);
  }
  if (want != m->depth)
    return pam_refused("TUPLTYPE " + tupl + " at depth " +
                       std::to_string(m->depth));
  m->data = p;
  return kOk;
}

int pam_pixels(const uint8_t* d, long n, const Pam& m, uint8_t* out) {
  const int bytes = m.maxval > 255 ? 2 : 1;
  const long row = static_cast<long>(m.w) * m.depth * bytes;
  if (m.data + row * m.h > n) return bad("PAM", "file ends before its data");
  for (int y = 0; y < m.h; ++y) {
    const uint8_t* s = d + m.data + y * row;
    uint8_t* o = out + static_cast<long>(y) * m.w * 3;
    for (int x = 0; x < m.w; ++x, o += 3) {
      if (m.maxval == 1) {  // packed bits, as cv2 takes them
        o[0] = o[1] = o[2] = (s[x >> 3] >> (7 - (x & 7))) & 1 ? 255 : 0;
        continue;
      }
      const uint8_t* q = s + static_cast<long>(x) * m.depth * bytes;
      auto at = [&](int k) { return q[k * bytes]; };  // the high byte
      if (m.depth <= 2) {
        o[0] = o[1] = o[2] = at(0);
      } else if (m.depth == 3) {  // unswapped into cv2's BGR
        o[0] = at(2), o[1] = at(1), o[2] = at(0);
      } else {
        o[0] = at(0), o[1] = at(1), o[2] = at(2);
      }
    }
  }
  return kOk;
}

}  // namespace

bool is_pam(const uint8_t* d, long n) {
  return n >= 3 && d[0] == 'P' && d[1] == '7' && std::isspace(d[2]);
}

int pam_info(const uint8_t* d, long n, int* h, int* w) {
  Pam m;
  const int st = pam_header(d, n, &m);
  if (st) return st;
  *h = m.h;
  *w = m.w;
  return kOk;
}

int pam_decode(const uint8_t* d, long n, uint8_t* out, int h, int w) {
  Pam m;
  const int st = pam_header(d, n, &m);
  if (st) return st;
  if (m.h != h || m.w != w) {
    set_error("PAM size differs from the size asked for");
    return kSizeMismatch;
  }
  return pam_pixels(d, n, m, out);
}

bool is_bmp(const uint8_t* d, long n) {
  return n >= 2 && d[0] == 'B' && d[1] == 'M';
}

bool is_pnm(const uint8_t* d, long n) {
  return n >= 3 && d[0] == 'P' && d[1] >= '1' && d[1] <= '6' &&
         std::isspace(d[2]);
}

int bmp_info(const uint8_t* d, long n, int* h, int* w) {
  Bmp b;
  const int st = bmp_header(d, n, &b);
  if (st) return st;
  *h = b.h;
  *w = b.w;
  return kOk;
}

int bmp_decode(const uint8_t* d, long n, uint8_t* out, int h, int w) {
  Bmp b;
  const int st = bmp_header(d, n, &b);
  if (st) return st;
  if (b.h != h || b.w != w) {
    set_error("BMP size differs from the size asked for");
    return kSizeMismatch;
  }
  return bmp_pixels(d, n, b, out);
}

int pnm_info(const uint8_t* d, long n, int* h, int* w) {
  Pnm p;
  const int st = pnm_header(d, n, &p);
  if (st) return st;
  *h = p.h;
  *w = p.w;
  return kOk;
}

int pnm_decode(const uint8_t* d, long n, uint8_t* out, int h, int w) {
  Pnm p;
  const int st = pnm_header(d, n, &p);
  if (st) return st;
  if (p.h != h || p.w != w) {
    set_error("PNM size differs from the size asked for");
    return kSizeMismatch;
  }
  return pnm_pixels(d, n, p, out);
}

}  // namespace sdt
