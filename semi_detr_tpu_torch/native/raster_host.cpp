// Sun raster decoder of the host library, to the pixels cv2.imread
// (IMREAD_COLOR, BGR turned to RGB) gives the JAX package's loader:
// OpenCV 5.0's SunRasterDecoder (grfmt_sunras.cpp).
//
// * Types 0 (old) and 1 (standard), at depths 1, 8, 24 and 32; each row
//   padded to 16 bits, and the file must hold every row. cv2 5.0 refuses
//   the byte-encoded (RLE, type 2) and RGB-order (type 3) types: its header
//   check compares the decoder's pixel type, not the file's, with them.
// * An equal-RGB colour map (map type 1) of 1 to 3 * 2 ** depth bytes at
//   depths 1 and 8: n = length / 3 entries, red, green and blue in planes
//   of n; entries past them are black. Without a map, depth 1 is 0 black
//   and 1 white and depth 8 is gray. Map type 2, or a map at 24 or 32
//   bits, is refused.
// * 24 bits: B, G, R; 32 bits: a pad byte, then B, G, R.

#include <cstdint>
#include <cstring>
#include <string>

#include "host.h"

namespace sdt {

namespace {

uint32_t be32(const uint8_t* p) {
  return (uint32_t{p[0]} << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
}

int refused(const std::string& what) {
  set_error("Sun raster: " + what + " (cv2 refuses it too)");
  return kUnsupported;
}

struct Ras {
  int w, h, depth, type, maptype;
  long maplength;
};

int parse(const uint8_t* d, long n, Ras* r) {
  if (n < 32) {
    set_error("Sun raster: damaged data: file ends inside its header");
    return kCorrupt;
  }
  const uint32_t w = be32(d + 4), h = be32(d + 8);
  r->depth = static_cast<int>(be32(d + 12));
  r->type = static_cast<int>(be32(d + 20));
  r->maptype = static_cast<int>(be32(d + 24));
  r->maplength = static_cast<long>(be32(d + 28));
  if (w == 0 || h == 0 || w > (1u << 24) || h > (1u << 24))
    return refused("a size of " + std::to_string(w) + "x" + std::to_string(h));
  r->w = static_cast<int>(w);
  r->h = static_cast<int>(h);
  if (r->depth != 1 && r->depth != 8 && r->depth != 24 && r->depth != 32)
    return refused("depth " + std::to_string(r->depth));
  if (r->type == 2) return refused("byte-encoded (RLE) type 2");
  if (r->type == 3) return refused("RGB-order type 3");
  if (r->type != 0 && r->type != 1)
    return refused("type " + std::to_string(r->type));
  const long pal = r->depth <= 8 ? 3L << r->depth : 0;
  const bool none = r->maptype == 0 && r->maplength == 0;
  const bool rgb = r->maptype == 1 && r->maplength > 0 &&
                   r->maplength <= pal && r->depth <= 8;
  if (!none && !rgb)
    return refused("map type " + std::to_string(r->maptype) +
                   " of " + std::to_string(r->maplength) + " bytes at depth " +
                   std::to_string(r->depth));
  return kOk;
}

int decode(const uint8_t* d, long n, const Ras& r, uint8_t* out) {
  const long pitch = ((static_cast<long>(r.w) * r.depth + 7) / 8 + 1) & ~1L;
  const long at = 32 + r.maplength;
  if (at + pitch * r.h > n) {
    set_error("Sun raster: damaged data: file ends before its pixels");
    return kCorrupt;
  }
  uint8_t pal[256][3];
  std::memset(pal, 0, sizeof(pal));
  if (r.maplength) {
    const long k = r.maplength / 3;
    for (long i = 0; i < k; ++i)
      for (int c = 0; c < 3; ++c) pal[i][c] = d[32 + c * k + i];
  } else if (r.depth == 1) {
    std::memset(pal[1], 255, 3);
  } else if (r.depth == 8) {
    for (int i = 0; i < 256; ++i) pal[i][0] = pal[i][1] = pal[i][2] = i;
  }
  for (int y = 0; y < r.h; ++y) {
    const uint8_t* s = d + at + y * pitch;
    uint8_t* o = out + static_cast<long>(y) * r.w * 3;
    for (int x = 0; x < r.w; ++x, o += 3) {
      switch (r.depth) {
        case 1: std::memcpy(o, pal[(s[x >> 3] >> (7 - (x & 7))) & 1], 3); break;
        case 8: std::memcpy(o, pal[s[x]], 3); break;
        case 24:
          o[0] = s[3 * x + 2], o[1] = s[3 * x + 1], o[2] = s[3 * x];
          break;
        default:
          o[0] = s[4 * x + 3], o[1] = s[4 * x + 2], o[2] = s[4 * x + 1];
      }
    }
  }
  return kOk;
}

}  // namespace

bool is_sun_raster(const uint8_t* d, long n) {
  return n >= 4 && be32(d) == 0x59A66A95u;
}

int sun_raster_info(const uint8_t* d, long n, int* h, int* w) {
  Ras r;
  const int st = parse(d, n, &r);
  if (st) return st;
  *h = r.h;
  *w = r.w;
  return kOk;
}

int sun_raster_decode(const uint8_t* d, long n, uint8_t* out, int h, int w) {
  Ras r;
  const int st = parse(d, n, &r);
  if (st) return st;
  if (r.h != h || r.w != w) {
    set_error("Sun raster size differs from the size asked for");
    return kSizeMismatch;
  }
  return decode(d, n, r, out);
}

}  // namespace sdt
