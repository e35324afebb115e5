// WebP decoder of the host library, to the pixels cv2.imread (IMREAD_COLOR,
// BGR turned to RGB) gives the JAX package's loader: OpenCV 5.0 reads WebP
// through libwebp (WebPDecodeBGRInto, or WebPAnimDecoder for an
// animation), then turns the picture by the EXIF orientation.
//
// * The RIFF container as libwebp's ParseHeadersInternal reads it: a simple
//   file (one `VP8 ` or `VP8L` chunk) or an extended one (`VP8X`, its
//   optional chunks walked, `ALPH` among them: IMREAD_COLOR drops alpha as
//   it is, without compositing, so the alpha plane is never decoded). An
//   animation gives its first frame on a canvas of zeros, as
//   WebPAnimDecoder gives it (the first frame is never blended). The `EXIF`
//   chunk's orientation (tag 0x0112 of IFD0) turns the picture as cv2 turns
//   it (jpeg_host.cpp's orient).
// * VP8L (lossless): the prefix codes (simple and normal, with their code
//   length codes) and their meta groups over an entropy image, backward
//   references with the 120 two-dimensional distance codes, the colour
//   cache, and the inverse transforms in reverse order: predictor (14
//   modes), cross colour, subtract green, colour indexing with bundled
//   pixels.
// * VP8 (lossy key frames, RFC 6386) as libwebp decodes them: the boolean
//   decoder, segment and filter headers, intra modes (16x16, 4x4, chroma),
//   token decoding with the default probabilities and their updates,
//   dequantization, the inverse WHT and DCT (libwebp's TransformOne), the
//   simple and normal loop filters over the unfiltered prediction, then
//   YUV 4:2:0 to RGB by libwebp's "fancy" upsampler (the 9-3-3-1 filter of
//   each pair of rows) and its 14-bit fixed-point conversion (VP8YUVToR, G,
//   B).
//
// Damage (a bad chunk size, a truncated stream, an invalid prefix code, a
// reference before the first pixel, a VP8 partition that runs out) raises
// ImageDecodeError naming the fault; nothing comes back blank.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "host.h"
#include "webp_tables.h"

namespace sdt {

namespace {

int bad(const std::string& what) {
  set_error("WebP: damaged data: " + what);
  return kCorrupt;
}

uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
uint32_t le32(const uint8_t* p) { return le24(p) | (uint32_t(p[3]) << 24); }

// ============================================================ container

struct Image {
  const uint8_t* data = nullptr;  // the VP8 or VP8L payload
  long size = 0;
  bool lossless = false;
  int width = 0, height = 0;      // of the frame's bitstream
  int canvas_w = 0, canvas_h = 0; // the picture cv2 returns before turning
  int x_off = 0, y_off = 0;       // the frame on the canvas
  int orientation = 1;
};

// the bitstream's own size: VP8's key frame header or VP8L's header
int bitstream_size(const uint8_t* d, long n, bool lossless, int* w, int* h) {
  if (lossless) {
    if (n < 5 || d[0] != 0x2f) return bad("bad VP8L signature");
    const uint32_t bits = le32(d + 1);
    *w = static_cast<int>((bits & 0x3fff) + 1);
    *h = static_cast<int>(((bits >> 14) & 0x3fff) + 1);
    if ((bits >> 29) != 0) return bad("unknown VP8L version");
    return kOk;
  }
  if (n < 10) return bad("VP8 data ends inside its frame header");
  const uint32_t tag = le24(d);
  if (tag & 1) return bad("not a key frame");
  if (((tag >> 1) & 7) > 3) return bad("unknown VP8 profile");
  if (!((tag >> 4) & 1)) return bad("a frame not to be shown");
  if ((tag >> 5) >= static_cast<uint32_t>(n)) return bad("bad partition length");
  if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a)
    return bad("bad VP8 start code");
  *w = static_cast<int>(le16(d + 6) & 0x3fff);
  *h = static_cast<int>(le16(d + 8) & 0x3fff);
  if (*w == 0 || *h == 0) return bad("a VP8 frame of no pixels");
  return kOk;
}

int exif_orientation(const uint8_t* t, long n) {
  if (n >= 6 && std::memcmp(t, "Exif\0\0", 6) == 0) {
    t += 6;
    n -= 6;
  }
  if (n < 8) return 1;
  const bool le = t[0] == 'I' && t[1] == 'I';
  if (!le && !(t[0] == 'M' && t[1] == 'M')) return 1;
  auto u16 = [&](long p) {
    return le ? t[p] | (t[p + 1] << 8) : (t[p] << 8) | t[p + 1];
  };
  auto u32 = [&](long p) {
    return le ? static_cast<long>(u16(p)) | (static_cast<long>(u16(p + 2)) << 16)
              : (static_cast<long>(u16(p)) << 16) | u16(p + 2);
  };
  const long ifd = u32(4);
  if (ifd < 8 || ifd + 2 > n) return 1;
  const int entries = u16(ifd);
  for (int e = 0; e < entries; ++e) {
    const long p = ifd + 2 + 12L * e;
    if (p + 12 > n) return 1;
    if (u16(p) == 0x0112) {
      const int o = u16(p + 8);
      return o >= 1 && o <= 8 ? o : 1;
    }
  }
  return 1;
}

// libwebp's ParseHeadersInternal and WebPDemux's frame walk: the first
// frame's bitstream, the canvas and the EXIF orientation
int parse_container(const uint8_t* d, long n, Image* im) {
  if (n < 12 || std::memcmp(d, "RIFF", 4) || std::memcmp(d + 8, "WEBP", 4))
    return bad("not a RIFF WEBP file");
  const uint32_t riff = le32(d + 4);
  if (riff < 12) return bad("RIFF size too small");
  if (riff > 0xfffffff6u - 8) return bad("RIFF size too large");
  if (static_cast<long>(riff) > n - 8) return bad("file shorter than its RIFF size");
  n = riff + 8;
  long pos = 12;
  bool extended = false, animated = false;
  auto chunk = [&](long p, uint32_t* size) -> const uint8_t* {
    if (p + 8 > n) return nullptr;
    *size = le32(d + p + 4);
    if (*size > 0xfffffff6u || p + 8 + static_cast<long>(*size) > n)
      return nullptr;
    return d + p;
  };
  uint32_t size;
  const uint8_t* c = chunk(pos, &size);
  if (!c) return bad("a chunk runs past the file");
  if (!std::memcmp(c, "VP8X", 4)) {
    if (size < 10) return bad("VP8X chunk too small");
    extended = true;
    animated = (c[8] & 0x02) != 0;
    im->canvas_w = static_cast<int>(le24(c + 12) + 1);
    im->canvas_h = static_cast<int>(le24(c + 15) + 1);
    if (static_cast<uint64_t>(im->canvas_w) * im->canvas_h >= (uint64_t{1} << 32))
      return bad("a canvas too large");
    pos += 8 + size + (size & 1);
  }
  const uint8_t* found = nullptr;
  for (; pos < n; ) {
    c = chunk(pos, &size);
    if (!c) return bad("a chunk runs past the file");
    const long body = pos + 8;
    if (!std::memcmp(c, "EXIF", 4)) {
      im->orientation = exif_orientation(d + body, size);
    } else if (!found && animated && !std::memcmp(c, "ANMF", 4)) {
      if (size < 16) return bad("ANMF chunk too small");
      im->x_off = static_cast<int>(le24(d + body) * 2);
      im->y_off = static_cast<int>(le24(d + body + 3) * 2);
      const int fw = static_cast<int>(le24(d + body + 6) + 1);
      const int fh = static_cast<int>(le24(d + body + 9) + 1);
      // the frame's own chunks: ALPH, then VP8 or VP8L
      long q = body + 16;
      const long end = body + size;
      while (q + 8 <= end) {
        const uint32_t s = le32(d + q + 4);
        if (q + 8 + static_cast<long>(s) > end) return bad("a frame chunk runs past its frame");
        if (!std::memcmp(d + q, "VP8 ", 4) || !std::memcmp(d + q, "VP8L", 4)) {
          found = d + q;
          break;
        }
        if (std::memcmp(d + q, "ALPH", 4)) return bad("an unknown chunk inside a frame");
        q += 8 + s + (s & 1);
      }
      if (!found) return bad("a frame without a bitstream");
      im->lossless = !std::memcmp(found, "VP8L", 4);
      im->data = found + 8;
      im->size = le32(found + 4);
      int st = bitstream_size(im->data, im->size, im->lossless, &im->width,
                              &im->height);
      if (st) return st;
      if (im->width != fw || im->height != fh)
        return bad("a frame's size differs from its bitstream's");
      if (im->x_off + fw > im->canvas_w || im->y_off + fh > im->canvas_h)
        return bad("a frame outside its canvas");
    } else if (!found && !animated &&
               (!std::memcmp(c, "VP8 ", 4) || !std::memcmp(c, "VP8L", 4))) {
      found = c;
      im->lossless = !std::memcmp(c, "VP8L", 4);
      im->data = d + body;
      im->size = size;
      int st = bitstream_size(im->data, im->size, im->lossless, &im->width,
                              &im->height);
      if (st) return st;
      if (!extended) {
        im->canvas_w = im->width;
        im->canvas_h = im->height;
        break;  // a simple file: nothing after the bitstream is read
      }
      if (im->width != im->canvas_w || im->height != im->canvas_h)
        return bad("the VP8X canvas differs from the image");
    } else if (!extended) {
      return bad("a simple file whose first chunk is not VP8 or VP8L");
    }
    pos += 8 + size + (size & 1);
  }
  if (!found) return bad(animated ? "an animation without frames"
                                  : "no VP8 or VP8L chunk");
  return kOk;
}

// ================================================================ VP8L

// LSB-first bit reader; eos once a bit past the end is consumed (zeros
// are read there)
struct LBits {
  const uint8_t* d;
  long n, pos = 0, used = 0;
  uint64_t val = 0;
  int have = 0;
  bool eos = false;
  void fill(int k) {
    while (have < k) {
      if (pos < n) val |= static_cast<uint64_t>(d[pos]) << have;
      ++pos;
      have += 8;
    }
  }
  uint32_t peek(int k) {
    fill(k);
    return static_cast<uint32_t>(val & ((uint64_t{1} << k) - 1));
  }
  uint32_t get(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    val >>= k;
    have -= k;
    used += k;
    if (used > 8 * n) eos = true;
    return v;
  }
};

// a canonical prefix code (lengths 0-15), read LSB first: codes of at most
// kRoot bits by table, longer ones bit by bit; one used symbol: no bits
struct Prefix {
  static constexpr int kRoot = 8;
  int single = -1;
  std::vector<uint16_t> table;        // (length << 12) | symbol, 0: longer
  std::vector<int> count, first_code, first_index;
  std::vector<uint16_t> sorted;
  bool build(const std::vector<int>& lengths) {
    int used = 0;
    count.assign(16, 0);
    for (int l : lengths)
      if (l) {
        ++count[l];
        ++used;
      }
    if (used == 0) return false;
    sorted.clear();
    for (int l = 1; l < 16; ++l)
      for (size_t s = 0; s < lengths.size(); ++s)
        if (lengths[s] == l) sorted.push_back(static_cast<uint16_t>(s));
    if (used == 1) {
      single = sorted[0];
      return true;
    }
    // complete: the Kraft sum is exactly 1
    long open = 1;
    for (int l = 1; l < 16; ++l) {
      open = 2 * open - count[l];
      if (open < 0) return false;
    }
    if (open != 0) return false;
    first_code.assign(17, 0);
    first_index.assign(17, 0);
    int code = 0, index = 0;
    for (int l = 1; l < 16; ++l) {
      first_code[l] = code;
      first_index[l] = index;
      code = (code + count[l]) << 1;
      index += count[l];
    }
    table.assign(1 << kRoot, 0);
    index = 0;
    for (int l = 1; l < 16; ++l) {
      for (int k = 0; k < count[l]; ++k, ++index) {
        if (l > kRoot) continue;
        const int c = first_code[l] + k;
        int rev = 0;
        for (int b = 0; b < l; ++b) rev |= ((c >> b) & 1) << (l - 1 - b);
        for (int fill = rev; fill < (1 << kRoot); fill += 1 << l)
          table[fill] = static_cast<uint16_t>((l << 12) | sorted[index]);
      }
    }
    return true;
  }
  int read(LBits* b) const {
    if (single >= 0) return single;
    const uint16_t e = table[b->peek(kRoot)];
    if (e) {
      b->get(e >> 12);
      return e & 0xfff;
    }
    int code = 0;
    for (int l = 1; l < 16; ++l) {
      code = (code << 1) | static_cast<int>(b->get(1));
      if (code - first_code[l] < count[l])
        return sorted[first_index[l] + code - first_code[l]];
    }
    return -1;
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                  7,  8,  9, 10, 11, 12, 13, 14, 15};

// (x, y) of the 120 short distance codes
const int8_t kPlane[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2},
    {2, 1},  {-2, 1}, {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3},
    {3, 1},  {-3, 1}, {2, 3},  {-2, 3}, {3, 2},  {-3, 2}, {0, 4},  {4, 0},
    {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3}, {2, 4},  {-2, 4},
    {4, 2},  {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2},
    {4, 4},  {-4, 4}, {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},
    {1, 6},  {-1, 6}, {6, 1},  {-6, 1}, {2, 6},  {-2, 6}, {6, 2},  {-6, 2},
    {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6}, {6, 3},  {-6, 3},
    {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6},  {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2},
    {3, 7},  {-3, 7}, {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5},
    {8, 0},  {4, 7},  {-4, 7}, {7, 4},  {-7, 4}, {8, 1},  {8, 2},  {6, 6},
    {-6, 6}, {8, 3},  {5, 7},  {-5, 7}, {7, 5},  {-7, 5}, {8, 4},  {6, 7},
    {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

struct Lossless {
  LBits b;
  int seen = 0;  // transform types read
  explicit Lossless(const uint8_t* d, long n) : b{d, n} {}

  bool read_code(int alphabet, Prefix* p) {
    std::vector<int> lengths(std::max(alphabet, 256), 0);
    if (b.get(1)) {  // simple
      const int num = static_cast<int>(b.get(1)) + 1;
      const int first8 = static_cast<int>(b.get(1));
      lengths[b.get(first8 ? 8 : 1)] = 1;
      if (num == 2) lengths[b.get(8)] = 1;
    } else {
      std::vector<int> cl(19, 0);
      const int num = static_cast<int>(b.get(4)) + 4;
      for (int i = 0; i < num; ++i) cl[kCodeLengthOrder[i]] = static_cast<int>(b.get(3));
      Prefix lc;
      if (!lc.build(cl)) return false;
      int max_symbol = alphabet;
      if (b.get(1)) {
        const int nbits = 2 + 2 * static_cast<int>(b.get(3));
        max_symbol = 2 + static_cast<int>(b.get(nbits));
        if (max_symbol > alphabet) return false;
      }
      int prev = 8, s = 0;
      while (s < alphabet) {
        if (max_symbol-- == 0) break;
        const int code = lc.read(&b);
        if (code < 0) return false;
        if (code < 16) {
          lengths[s++] = code;
          if (code) prev = code;
        } else {
          static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
          const int repeat = static_cast<int>(b.get(kExtra[code - 16])) +
                             kOffset[code - 16];
          if (s + repeat > alphabet) return false;
          for (int k = 0; k < repeat; ++k) lengths[s++] = code == 16 ? prev : 0;
        }
      }
    }
    if (b.eos) return false;
    lengths.resize(alphabet);
    return p->build(lengths);
  }

  // one entropy-coded image of xsize x ysize ARGB pixels; top: the main
  // image (its transforms and meta prefix codes)
  int image(int xsize, int ysize, bool top, std::vector<uint32_t>* out,
            std::vector<std::pair<int, std::vector<uint32_t>>>* transforms,
            std::vector<int>* widths, std::vector<int>* bits_of) {
    int w = xsize;
    if (top) {
      while (b.get(1)) {
        const int type = static_cast<int>(b.get(2));
        if (seen & (1 << type)) return bad("a VP8L transform twice");
        seen |= 1 << type;
        std::vector<uint32_t> data;
        int bits = 0;
        widths->push_back(w);
        if (type == 0 || type == 1) {
          bits = static_cast<int>(b.get(3)) + 2;
          const int st = image((w + (1 << bits) - 1) >> bits,
                               (ysize + (1 << bits) - 1) >> bits, false, &data,
                               nullptr, nullptr, nullptr);
          if (st) return st;
        } else if (type == 3) {
          const int colours = static_cast<int>(b.get(8)) + 1;
          bits = colours > 16 ? 0 : colours > 4 ? 1 : colours > 2 ? 2 : 3;
          std::vector<uint32_t> table;
          const int st = image(colours, 1, false, &table, nullptr, nullptr,
                               nullptr);
          if (st) return st;
          data.assign(1u << (8 >> bits), 0);
          data[0] = table[0];
          for (int i = 1; i < colours; ++i) {  // deltas, per byte
            uint32_t v = 0;
            for (int s = 0; s < 32; s += 8)
              v |= (((table[i] >> s) + (data[i - 1] >> s)) & 0xff) << s;
            data[i] = v;
          }
          w = (w + (1 << bits) - 1) >> bits;
        }
        bits_of->push_back(bits);
        transforms->push_back({type, std::move(data)});
      }
    }
    int cache_bits = 0;
    if (b.get(1)) {
      cache_bits = static_cast<int>(b.get(4));
      if (cache_bits < 1 || cache_bits > 11) return bad("bad colour cache size");
    }
    std::vector<uint32_t> groups_img;
    int group_bits = 0, groups = 1, group_w = 1;
    if (top && b.get(1)) {
      group_bits = static_cast<int>(b.get(3)) + 2;
      group_w = (w + (1 << group_bits) - 1) >> group_bits;
      const int st = image(group_w, (ysize + (1 << group_bits) - 1) >> group_bits,
                           false, &groups_img, nullptr, nullptr, nullptr);
      if (st) return st;
      for (auto& g : groups_img) {
        g = (g >> 8) & 0xffff;
        groups = std::max(groups, static_cast<int>(g) + 1);
      }
    }
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    static const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};
    std::vector<Prefix> codes(5 * groups);
    for (int g = 0; g < groups; ++g)
      for (int j = 0; j < 5; ++j)
        if (!read_code(kAlphabet[j] + (j == 0 ? cache_size : 0),
                       &codes[5 * g + j]))
          return bad("an invalid prefix code");
    std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
    out->assign(static_cast<size_t>(w) * ysize, 0);
    uint32_t* px = out->data();
    const long total = static_cast<long>(w) * ysize;
    long i = 0;
    auto insert = [&](uint32_t v) {
      if (cache_bits) cache[(0x1e35a7bdu * v) >> (32 - cache_bits)] = v;
    };
    auto length_of = [&](int sym) -> long {
      if (sym < 4) return sym + 1;
      const int extra = (sym - 2) >> 1;
      const long offset = static_cast<long>(2 + (sym & 1)) << extra;
      return offset + b.get(extra) + 1;
    };
    while (i < total) {
      const int x = static_cast<int>(i % w), y = static_cast<int>(i / w);
      const Prefix* c = codes.data();
      if (group_bits)
        c += 5 * groups_img[(y >> group_bits) * group_w + (x >> group_bits)];
      const int s = c[0].read(&b);
      if (s < 0) return bad("a bad prefix code");
      if (s < 256) {
        const int red = c[1].read(&b), blue = c[2].read(&b),
                  alpha = c[3].read(&b);
        if (red < 0 || blue < 0 || alpha < 0) return bad("a bad prefix code");
        px[i] = (static_cast<uint32_t>(alpha) << 24) | (red << 16) | (s << 8) |
                blue;
        insert(px[i++]);
      } else if (s < 256 + 24) {
        const long len = length_of(s - 256);
        const int dsym = c[4].read(&b);
        if (dsym < 0) return bad("a bad prefix code");
        const long code = length_of(dsym);
        long dist;
        if (code > 120) {
          dist = code - 120;
        } else {
          dist = kPlane[code - 1][1] * static_cast<long>(w) + kPlane[code - 1][0];
          if (dist < 1) dist = 1;
        }
        if (b.eos) break;
        if (dist > i || len > total - i) return bad("a backward reference out of the image");
        for (long k = 0; k < len; ++k, ++i) {
          px[i] = px[i - dist];
          insert(px[i]);
        }
      } else {
        const int key = s - 256 - 24;
        if (key >= cache_size) return bad("a colour cache index out of range");
        px[i] = cache[key];
        insert(px[i++]);
      }
      if (b.eos) break;
    }
    if (b.eos) return bad("VP8L data ends early");
    return kOk;
  }
};

inline uint32_t add_px(uint32_t a, uint32_t b) {
  return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
         (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
}
inline uint32_t avg2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int ch(uint32_t v, int s) { return (v >> s) & 0xff; }
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TR, uint32_t TL) {
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return avg2(avg2(L, TR), T);
    case 6: return avg2(L, TL);
    case 7: return avg2(L, T);
    case 8: return avg2(TL, T);
    case 9: return avg2(T, TR);
    case 10: return avg2(avg2(L, TL), avg2(T, TR));
    case 11: {
      int pa_minus_pb = 0;
      for (int s = 0; s < 32; s += 8)
        pa_minus_pb += std::abs(ch(L, s) - ch(TL, s)) -
                       std::abs(ch(T, s) - ch(TL, s));
      return pa_minus_pb <= 0 ? T : L;
    }
    case 12: {
      uint32_t v = 0;
      for (int s = 0; s < 32; s += 8)
        v |= static_cast<uint32_t>(clip255(ch(L, s) + ch(T, s) - ch(TL, s))) << s;
      return v;
    }
    case 13: {
      const uint32_t a = avg2(L, T);
      uint32_t v = 0;
      for (int s = 0; s < 32; s += 8) {
        const int x = ch(a, s);
        v |= static_cast<uint32_t>(clip255(x + (x - ch(TL, s)) / 2)) << s;
      }
      return v;
    }
    default: return 0xff000000u;  // 0, and 14, 15
  }
}

int decode_lossless(const Image& im, std::vector<uint32_t>* argb) {
  Lossless dec(im.data + 5, im.size - 5);
  std::vector<std::pair<int, std::vector<uint32_t>>> transforms;
  std::vector<int> widths, bits;
  std::vector<uint32_t> px;
  const int h = im.height;
  int st = dec.image(im.width, h, true, &px, &transforms, &widths, &bits);
  if (st) return st;
  for (int t = static_cast<int>(transforms.size()) - 1; t >= 0; --t) {
    const int type = transforms[t].first, w = widths[t], tb = bits[t];
    const std::vector<uint32_t>& data = transforms[t].second;
    if (type == 0) {  // predictor
      const int tiles = (w + (1 << tb) - 1) >> tb;
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          uint32_t* p = px.data() + static_cast<long>(y) * w + x;
          uint32_t pred;
          if (y == 0) {
            pred = x == 0 ? 0xff000000u : p[-1];
          } else if (x == 0) {
            pred = p[-w];
          } else {
            const int mode = (data[(y >> tb) * tiles + (x >> tb)] >> 8) & 0xf;
            pred = predict(mode, p[-1], p[-w], p[-w + 1], p[-w - 1]);
          }
          *p = add_px(*p, pred);
        }
    } else if (type == 1) {  // cross colour
      const int tiles = (w + (1 << tb) - 1) >> tb;
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          uint32_t& p = px[static_cast<long>(y) * w + x];
          const uint32_t m = data[(y >> tb) * tiles + (x >> tb)];
          const int8_t g2r = static_cast<int8_t>(m & 0xff),
                       g2b = static_cast<int8_t>((m >> 8) & 0xff),
                       r2b = static_cast<int8_t>((m >> 16) & 0xff);
          const int8_t green = static_cast<int8_t>(p >> 8);
          int red = (p >> 16) & 0xff, blue = p & 0xff;
          red = (red + ((g2r * green) >> 5)) & 0xff;
          blue = (blue + ((g2b * green) >> 5)) & 0xff;
          blue = (blue + ((r2b * static_cast<int8_t>(red)) >> 5)) & 0xff;
          p = (p & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) | blue;
        }
    } else if (type == 2) {  // subtract green
      for (auto& p : px) {
        const uint32_t g = (p >> 8) & 0xff;
        p = (p & 0xff00ff00u) | ((((p >> 16) + g) & 0xff) << 16) |
            ((p + g) & 0xff);
      }
    } else {  // colour indexing: px holds packed indices (width w >> tb)
      const int packed_w = (w + (1 << tb) - 1) >> tb;
      const int bpp = 8 >> tb;
      std::vector<uint32_t> outp(static_cast<size_t>(w) * h);
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          const uint32_t packed = (px[static_cast<long>(y) * packed_w + (x >> tb)] >> 8) & 0xff;
          const int idx = (packed >> ((x & ((1 << tb) - 1)) * bpp)) & ((1 << bpp) - 1);
          outp[static_cast<long>(y) * w + x] = data[idx];
        }
      px.swap(outp);
    }
  }
  argb->swap(px);
  return kOk;
}

// ================================================================= VP8

using vp8::kAcTable;
using vp8::kBModesProba;
using vp8::kCoeffsProba0;
using vp8::kCoeffsUpdateProba;
using vp8::kDcTable;

// libwebp's VP8BitReader: range kept minus one, bytes loaded as needed, eof
// once a bit is asked for after the data's last one
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;
  bool eof = false;
  void init(const uint8_t* p, long n) {
    buf = p;
    end = p + n;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    while (bits < 0 && !eof) load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * static_cast<uint32_t>(prob)) >> 8;
    const uint32_t v = static_cast<uint32_t>(value >> pos);
    const int b = v > split;
    if (b) {
      r -= split;
      value -= static_cast<uint64_t>(split + 1) << pos;
    } else {
      r = split + 1;
    }
    int shift = 0;
    while ((r << shift) < 128) ++shift;
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  int value_bits(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = value_bits(n);
    return bit(0x80) ? -v : v;
  }
};

enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
       B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED,
       DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
       TM_PRED = B_TM_PRED, DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };

const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

constexpr int BPS = 32;  // libwebp's work buffer stride

struct Quant {
  int y1[2], y2[2], uv[2];
};

struct FInfo {
  int limit = 0, ilevel = 0, hev = 0;
  bool inner = false;
};

struct MBInfo {  // what a macroblock keeps until its reconstruction
  bool i4 = false;
  uint8_t imodes[16];
  uint8_t uvmode = 0;
  int segment = 0;
  bool skip = false;
  int16_t coeffs[384];
  uint8_t nz_code[24];  // per block: 0 none, else transform
};

struct Lossy {
  int w = 0, h = 0, mbw = 0, mbh = 0;
  BoolReader br;
  std::vector<BoolReader> parts;
  // headers
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t seg_proba[3] = {255, 255, 255};
  bool simple = false;
  int level = 0, sharpness = 0, filter_type = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  Quant dqm[4];
  uint8_t proba[4][8][3][11];
  bool use_skip = false;
  int skip_p = 0;
  FInfo fstrengths[4][2];
  // planes of mbw * 16 x mbh * 16 (chroma half)
  std::vector<uint8_t> Y, U, V;
  int ys = 0, uvs = 0;

  int headers(const uint8_t* d, long n) {
    const uint32_t tag = le24(d);
    const long part0 = tag >> 5;
    w = static_cast<int>(le16(d + 6) & 0x3fff);
    h = static_cast<int>(le16(d + 8) & 0x3fff);
    mbw = (w + 15) >> 4;
    mbh = (h + 15) >> 4;
    const uint8_t* p = d + 10;
    long left = n - 10;
    if (part0 > left) return bad("bad partition length");
    br.init(p, part0);
    p += part0;
    left -= part0;
    br.bit(0x80);  // colour space
    br.bit(0x80);  // clamping type
    use_segment = br.bit(0x80);
    if (use_segment) {
      update_map = br.bit(0x80);
      if (br.bit(0x80)) {
        absolute_delta = br.bit(0x80);
        for (int s = 0; s < 4; ++s)
          quantizer[s] = br.bit(0x80) ? br.signed_value(7) : 0;
        for (int s = 0; s < 4; ++s)
          filter_strength[s] = br.bit(0x80) ? br.signed_value(6) : 0;
      }
      if (update_map)
        for (int s = 0; s < 3; ++s)
          seg_proba[s] = static_cast<uint8_t>(br.bit(0x80) ? br.value_bits(8) : 255);
    }
    if (br.eof) return bad("cannot parse the segment header");
    simple = br.bit(0x80);
    level = br.value_bits(6);
    sharpness = br.value_bits(3);
    use_lf_delta = br.bit(0x80);
    if (use_lf_delta && br.bit(0x80)) {
      for (int i = 0; i < 4; ++i)
        if (br.bit(0x80)) ref_lf_delta[i] = br.signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br.bit(0x80)) mode_lf_delta[i] = br.signed_value(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    if (br.eof) return bad("cannot parse the filter header");
    // partitions
    const int last = (1 << br.value_bits(2)) - 1;
    if (left < 3L * last) return bad("cannot parse the partitions");
    const uint8_t* sz = p;
    const uint8_t* start = p + 3 * last;
    long size_left = left - 3 * last;
    parts.assign(last + 1, BoolReader());
    for (int k = 0; k < last; ++k) {
      long psize = le24(sz + 3 * k);
      if (psize > size_left) psize = size_left;
      parts[k].init(start, psize);
      start += psize;
      size_left -= psize;
    }
    parts[last].init(start, size_left);
    if (start >= d + n) return bad("the last partition is empty (truncated)");
    // quantizers
    const int base_q0 = br.value_bits(7);
    auto dq = [&]() { return br.bit(0x80) ? br.signed_value(4) : 0; };
    const int dqy1_dc = dq(), dqy2_dc = dq(), dqy2_ac = dq(), dquv_dc = dq(),
              dquv_ac = dq();
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment) {
        q = quantizer[i];
        if (!absolute_delta) q += base_q0;
      } else {
        if (i > 0) {
          dqm[i] = dqm[0];
          continue;
        }
        q = base_q0;
      }
      Quant& m = dqm[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
    br.bit(0x80);  // refresh the entropy probabilities: ignored
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p2 = 0; p2 < 11; ++p2)
            proba[t][b][c][p2] = static_cast<uint8_t>(
                br.bit(kCoeffsUpdateProba[t][b][c][p2]) ? br.value_bits(8)
                                                       : kCoeffsProba0[t][b][c][p2]);
    use_skip = br.bit(0x80);
    if (use_skip) skip_p = br.value_bits(8);
    if (br.eof) return bad("cannot parse the token probabilities");
    // the filter strengths of each segment, for 16x16 and 4x4 macroblocks
    if (filter_type > 0) {
      for (int s = 0; s < 4; ++s) {
        int base = level;
        if (use_segment) {
          base = filter_strength[s];
          if (!absolute_delta) base += level;
        }
        for (int i4 = 0; i4 <= 1; ++i4) {
          FInfo& f = fstrengths[s][i4];
          int lv = base;
          if (use_lf_delta) {
            lv += ref_lf_delta[0];
            if (i4) lv += mode_lf_delta[0];
          }
          lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
          if (lv > 0) {
            int il = lv;
            if (sharpness > 0) {
              il >>= sharpness > 4 ? 2 : 1;
              if (il > 9 - sharpness) il = 9 - sharpness;
            }
            if (il < 1) il = 1;
            f.ilevel = il;
            f.limit = 2 * lv + il;
            f.hev = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
          } else {
            f.limit = 0;
          }
          f.inner = i4;
        }
      }
    }
    return kOk;
  }

  int large_value(BoolReader* b, const uint8_t* p) {
    int v;
    if (!b->bit(p[3])) {
      v = !b->bit(p[4]) ? 2 : 3 + b->bit(p[5]);
    } else if (!b->bit(p[6])) {
      if (!b->bit(p[7])) {
        v = 5 + b->bit(159);
      } else {
        v = 7 + 2 * b->bit(165);
        v += b->bit(145);
      }
    } else {
      const int bit1 = b->bit(p[8]);
      const int bit0 = b->bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* t = kCat3456[cat]; *t; ++t) v += v + b->bit(*t);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // GetCoeffs: the tokens of one block from position n, into out
  // (natural order, dequantized, int16 as libwebp stores them); returns the
  // position after the last token read, as libwebp's does
  int coeffs(BoolReader* b, int type, int ctx, const int* dq, int n,
             int16_t* out) {
    const uint8_t* p = proba[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!b->bit(p[0])) return n;
      while (!b->bit(p[1])) {
        p = proba[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      if (!b->bit(p[2])) {
        v = 1;
        p = proba[type][kBands[n + 1]][1];
      } else {
        v = large_value(b, p);
        p = proba[type][kBands[n + 1]][2];
      }
      const int sv = b->bit(0x80) ? -v : v;
      out[kZigzag[n]] = static_cast<int16_t>(sv * dq[n > 0]);
    }
    return 16;
  }

  static int nz_code(int nz, int dc_nz) {
    return nz > 3 ? 3 : nz > 1 ? 2 : dc_nz;
  }

  int decode(std::vector<uint8_t>* rgb) {
    ys = mbw * 16;
    uvs = mbw * 8;
    Y.assign(static_cast<size_t>(ys) * mbh * 16, 0);
    U.assign(static_cast<size_t>(uvs) * mbh * 8, 0);
    V.assign(U.size(), 0);
    std::vector<uint8_t> intra_t(4 * mbw, B_DC_PRED);
    std::vector<uint8_t> top_nz(9 * mbw, 0);  // 4 Y, 2 U, 2 V, DC
    std::vector<MBInfo> row(mbw);
    std::vector<FInfo> finfo(static_cast<size_t>(mbw) * mbh);
    // unfiltered top samples of each column of macroblocks
    std::vector<uint8_t> top_y(16 * mbw), top_u(8 * mbw), top_v(8 * mbw);
    for (int mby = 0; mby < mbh; ++mby) {
      uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
      for (int mbx = 0; mbx < mbw; ++mbx) {  // modes (partition 0)
        MBInfo& mb = row[mbx];
        mb.segment = update_map ? (!br.bit(seg_proba[0]) ? br.bit(seg_proba[1])
                                                         : br.bit(seg_proba[2]) + 2)
                                : 0;
        mb.skip = use_skip ? br.bit(skip_p) : false;
        mb.i4 = !br.bit(145);
        uint8_t* top = intra_t.data() + 4 * mbx;
        if (!mb.i4) {
          const int ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED)
                                        : (br.bit(163) ? V_PRED : DC_PRED);
          mb.imodes[0] = static_cast<uint8_t>(ymode);
          std::memset(top, ymode, 4);
          std::memset(intra_l, ymode, 4);
        } else {
          for (int y = 0; y < 4; ++y) {
            int ymode = intra_l[y];
            for (int x = 0; x < 4; ++x) {
              const uint8_t* pr = kBModesProba[top[x]][ymode];
              ymode = !br.bit(pr[0]) ? B_DC_PRED
                    : !br.bit(pr[1]) ? B_TM_PRED
                    : !br.bit(pr[2]) ? B_VE_PRED
                    : !br.bit(pr[3])
                        ? (!br.bit(pr[4]) ? B_HE_PRED
                                          : (!br.bit(pr[5]) ? B_RD_PRED : B_VR_PRED))
                        : (!br.bit(pr[6]) ? B_LD_PRED
                                          : (!br.bit(pr[7]) ? B_VL_PRED
                                                            : (!br.bit(pr[8]) ? B_HD_PRED
                                                                              : B_HU_PRED)));
              top[x] = static_cast<uint8_t>(ymode);
            }
            std::memcpy(mb.imodes + 4 * y, top, 4);
            intra_l[y] = static_cast<uint8_t>(ymode);
          }
        }
        mb.uvmode = static_cast<uint8_t>(!br.bit(142) ? DC_PRED
                                         : !br.bit(114) ? V_PRED
                                         : br.bit(183) ? TM_PRED : H_PRED);
      }
      if (br.eof) return bad("premature end of partition 0");
      BoolReader& tb = parts[mby & (static_cast<int>(parts.size()) - 1)];
      uint8_t left_nz[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
      for (int mbx = 0; mbx < mbw; ++mbx) {  // tokens
        MBInfo& mb = row[mbx];
        uint8_t* tnz = top_nz.data() + 9 * mbx;
        std::memset(mb.coeffs, 0, sizeof(mb.coeffs));
        std::memset(mb.nz_code, 0, sizeof(mb.nz_code));
        bool all_zero = true;
        if (!mb.skip) {
          const Quant& q = dqm[mb.segment];
          int first = 0, ytype = 3;
          if (!mb.i4) {
            int16_t dc[16] = {0};
            const int nz = coeffs(&tb, 1, tnz[8] + left_nz[8], q.y2, 0, dc);
            tnz[8] = left_nz[8] = nz > 0;
            wht(dc, mb.coeffs);
            first = 1;
            ytype = 0;
          }
          for (int y = 0; y < 4; ++y)
            for (int x = 0; x < 4; ++x) {
              int16_t* blk = mb.coeffs + 16 * (4 * y + x);
              const int nz = coeffs(&tb, ytype, left_nz[y] + tnz[x], q.y1,
                                    first, blk);
              left_nz[y] = tnz[x] = nz > first;
              mb.nz_code[4 * y + x] = static_cast<uint8_t>(nz_code(nz, blk[0] != 0));
            }
          for (int c = 0; c < 2; ++c)  // U, then V
            for (int y = 0; y < 2; ++y)
              for (int x = 0; x < 2; ++x) {
                const int k = 16 + 4 * c + 2 * y + x;
                int16_t* blk = mb.coeffs + 16 * k;
                const int nz = coeffs(&tb, 2, left_nz[4 + 2 * c + y] +
                                      tnz[4 + 2 * c + x], q.uv, 0, blk);
                left_nz[4 + 2 * c + y] = tnz[4 + 2 * c + x] = nz > 0;
                mb.nz_code[k] = static_cast<uint8_t>(nz_code(nz, blk[0] != 0));
              }
          for (int k = 0; k < 24; ++k) all_zero &= mb.nz_code[k] == 0;
        } else {
          std::memset(left_nz, 0, 8);
          std::memset(tnz, 0, 8);
          if (!mb.i4) left_nz[8] = tnz[8] = 0;
        }
        if (filter_type > 0) {
          FInfo f = fstrengths[mb.segment][mb.i4];
          f.inner = f.inner || !all_zero;
          finfo[static_cast<size_t>(mby) * mbw + mbx] = f;
        }
        if (tb.eof) return bad("premature end of a token partition");
      }
      reconstruct_row(mby, row, top_y, top_u, top_v);
    }
    if (filter_type > 0)
      for (int mby = 0; mby < mbh; ++mby)
        for (int mbx = 0; mbx < mbw; ++mbx)
          filter_mb(mbx, mby, finfo[static_cast<size_t>(mby) * mbw + mbx]);
    to_rgb(rgb);
    return kOk;
  }

  // ------------------------------------------------------ transforms
  static int mul1(int a) { return ((a * 20091) >> 16) + a; }
  static int mul2(int a) { return (a * 35468) >> 16; }
  static uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

  static void wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
      const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
      const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
      tmp[0 + i] = a0 + a1;
      tmp[8 + i] = a0 - a1;
      tmp[4 + i] = a3 + a2;
      tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
      const int dc = tmp[0 + i * 4] + 3;
      const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
      const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
      out[0] = static_cast<int16_t>((a0 + a1) >> 3);
      out[16] = static_cast<int16_t>((a3 + a2) >> 3);
      out[32] = static_cast<int16_t>((a0 - a1) >> 3);
      out[48] = static_cast<int16_t>((a3 - a2) >> 3);
      out += 64;
    }
  }

  static void idct_add(const int16_t* in, uint8_t* dst) {
    int C[16];
    int* tmp = C;
    for (int i = 0; i < 4; ++i, ++in, tmp += 4) {
      const int a = in[0] + in[8], b = in[0] - in[8];
      const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
      tmp[0] = a + d;
      tmp[1] = b + c;
      tmp[2] = b - c;
      tmp[3] = a - d;
    }
    tmp = C;
    for (int i = 0; i < 4; ++i, ++tmp, dst += BPS) {
      const int dc = tmp[0] + 4;
      const int a = dc + tmp[8], b = dc - tmp[8];
      const int c = mul2(tmp[4]) - mul1(tmp[12]), d = mul1(tmp[4]) + mul2(tmp[12]);
      dst[0] = clip8(dst[0] + ((a + d) >> 3));
      dst[1] = clip8(dst[1] + ((b + c) >> 3));
      dst[2] = clip8(dst[2] + ((b - c) >> 3));
      dst[3] = clip8(dst[3] + ((a - d) >> 3));
    }
  }

  // ------------------------------------------------------ prediction
  static uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
  static uint8_t avg2p(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

  static void true_motion(uint8_t* dst, int size) {
    const uint8_t* top = dst - BPS;
    for (int y = 0; y < size; ++y, dst += BPS)
      for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
  }
  static void fill(uint8_t* dst, int size, int v) {
    for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size);
  }
  // 16x16 (size 16) and chroma (size 8) predictions; mode after CheckMode
  static void pred_block(uint8_t* dst, int size, int mode) {
    const int shift = size == 16 ? 5 : 4;
    switch (mode) {
      case DC_PRED: {
        int dc = size;
        for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
        fill(dst, size, dc >> shift);
        break;
      }
      case TM_PRED: true_motion(dst, size); break;
      case V_PRED:
        for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
        break;
      case H_PRED:
        for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
        break;
      case DC_NOTOP: {
        int dc = size / 2;
        for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
        fill(dst, size, dc >> (shift - 1));
        break;
      }
      case DC_NOLEFT: {
        int dc = size / 2;
        for (int i = 0; i < size; ++i) dc += dst[i - BPS];
        fill(dst, size, dc >> (shift - 1));
        break;
      }
      default: fill(dst, size, 0x80);
    }
  }

  static void pred4(uint8_t* dst, int mode) {
    auto D = [&](int x, int y) -> uint8_t& { return dst[x + y * BPS]; };
    const uint8_t* top = dst - BPS;
    switch (mode) {
      case B_DC_PRED: {
        uint32_t dc = 4;
        for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
        fill(dst, 4, dc >> 3);
        break;
      }
      case B_TM_PRED: true_motion(dst, 4); break;
      case B_VE_PRED: {
        const uint8_t v[4] = {avg3(top[-1], top[0], top[1]), avg3(top[0], top[1], top[2]),
                              avg3(top[1], top[2], top[3]), avg3(top[2], top[3], top[4])};
        for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
        break;
      }
      case B_HE_PRED: {
        const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS],
                  Dd = dst[-1 + 2 * BPS], E = dst[-1 + 3 * BPS];
        std::memset(dst, avg3(A, B, C), 4);
        std::memset(dst + BPS, avg3(B, C, Dd), 4);
        std::memset(dst + 2 * BPS, avg3(C, Dd, E), 4);
        std::memset(dst + 3 * BPS, avg3(Dd, E, E), 4);
        break;
      }
      case B_RD_PRED: {
        const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                  L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = top[0],
                  B = top[1], C = top[2], Dd = top[3];
        D(0, 3) = avg3(J, K, L);
        D(1, 3) = D(0, 2) = avg3(I, J, K);
        D(2, 3) = D(1, 2) = D(0, 1) = avg3(X, I, J);
        D(3, 3) = D(2, 2) = D(1, 1) = D(0, 0) = avg3(A, X, I);
        D(3, 2) = D(2, 1) = D(1, 0) = avg3(B, A, X);
        D(3, 1) = D(2, 0) = avg3(C, B, A);
        D(3, 0) = avg3(Dd, C, B);
        break;
      }
      case B_LD_PRED: {
        const int A = top[0], B = top[1], C = top[2], Dd = top[3], E = top[4],
                  F = top[5], G = top[6], H = top[7];
        D(0, 0) = avg3(A, B, C);
        D(1, 0) = D(0, 1) = avg3(B, C, Dd);
        D(2, 0) = D(1, 1) = D(0, 2) = avg3(C, Dd, E);
        D(3, 0) = D(2, 1) = D(1, 2) = D(0, 3) = avg3(Dd, E, F);
        D(3, 1) = D(2, 2) = D(1, 3) = avg3(E, F, G);
        D(3, 2) = D(2, 3) = avg3(F, G, H);
        D(3, 3) = avg3(G, H, H);
        break;
      }
      case B_VR_PRED: {
        const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                  X = dst[-1 - BPS], A = top[0], B = top[1], C = top[2],
                  Dd = top[3];
        D(0, 0) = D(1, 2) = avg2p(X, A);
        D(1, 0) = D(2, 2) = avg2p(A, B);
        D(2, 0) = D(3, 2) = avg2p(B, C);
        D(3, 0) = avg2p(C, Dd);
        D(0, 3) = avg3(K, J, I);
        D(0, 2) = avg3(J, I, X);
        D(0, 1) = D(1, 3) = avg3(I, X, A);
        D(1, 1) = D(2, 3) = avg3(X, A, B);
        D(2, 1) = D(3, 3) = avg3(A, B, C);
        D(3, 1) = avg3(B, C, Dd);
        break;
      }
      case B_VL_PRED: {
        const int A = top[0], B = top[1], C = top[2], Dd = top[3], E = top[4],
                  F = top[5], G = top[6], H = top[7];
        D(0, 0) = avg2p(A, B);
        D(1, 0) = D(0, 2) = avg2p(B, C);
        D(2, 0) = D(1, 2) = avg2p(C, Dd);
        D(3, 0) = D(2, 2) = avg2p(Dd, E);
        D(0, 1) = avg3(A, B, C);
        D(1, 1) = D(0, 3) = avg3(B, C, Dd);
        D(2, 1) = D(1, 3) = avg3(C, Dd, E);
        D(3, 1) = D(2, 3) = avg3(Dd, E, F);
        D(3, 2) = avg3(E, F, G);
        D(3, 3) = avg3(F, G, H);
        break;
      }
      case B_HU_PRED: {
        const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                  L = dst[-1 + 3 * BPS];
        D(0, 0) = avg2p(I, J);
        D(2, 0) = D(0, 1) = avg2p(J, K);
        D(2, 1) = D(0, 2) = avg2p(K, L);
        D(1, 0) = avg3(I, J, K);
        D(3, 0) = D(1, 1) = avg3(J, K, L);
        D(3, 1) = D(1, 2) = avg3(K, L, L);
        D(3, 2) = D(2, 2) = D(0, 3) = D(1, 3) = D(2, 3) = D(3, 3) =
            static_cast<uint8_t>(L);
        break;
      }
      default: {  // B_HD_PRED
        const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                  L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = top[0],
                  B = top[1], C = top[2];
        D(0, 0) = D(2, 1) = avg2p(I, X);
        D(0, 1) = D(2, 2) = avg2p(J, I);
        D(0, 2) = D(2, 3) = avg2p(K, J);
        D(0, 3) = avg2p(L, K);
        D(3, 0) = avg3(A, B, C);
        D(2, 0) = avg3(X, A, B);
        D(1, 0) = D(3, 1) = avg3(I, X, A);
        D(1, 1) = D(3, 2) = avg3(J, I, X);
        D(1, 2) = D(3, 3) = avg3(K, J, I);
        D(1, 3) = avg3(L, K, J);
      }
    }
  }

  static int check_mode(int mbx, int mby, int mode) {
    if (mode == B_DC_PRED) {
      if (mbx == 0) return mby == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
      return mby == 0 ? DC_NOTOP : DC_PRED;
    }
    return mode;
  }

  // libwebp's ReconstructRow, its yuv_b_ work buffer included: the
  // prediction reads unfiltered samples only
  void reconstruct_row(int mby, std::vector<MBInfo>& row,
                       std::vector<uint8_t>& top_y, std::vector<uint8_t>& top_u,
                       std::vector<uint8_t>& top_v) {
    uint8_t work[BPS * 17 + BPS * 9];
    std::memset(work, 0, sizeof(work));
    uint8_t* const y_dst = work + BPS + 8;
    uint8_t* const u_dst = y_dst + BPS * 16 + BPS;
    uint8_t* const v_dst = u_dst + 16;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mby > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mbx = 0; mbx < mbw; ++mbx) {
      const MBInfo& mb = row[mbx];
      if (mbx > 0) {
        for (int j = -1; j < 16; ++j) std::memcpy(y_dst + j * BPS - 4, y_dst + j * BPS + 12, 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(u_dst + j * BPS - 4, u_dst + j * BPS + 4, 4);
          std::memcpy(v_dst + j * BPS - 4, v_dst + j * BPS + 4, 4);
        }
      }
      uint8_t* ty = top_y.data() + 16 * mbx;
      uint8_t* tu = top_u.data() + 8 * mbx;
      uint8_t* tv = top_v.data() + 8 * mbx;
      if (mby > 0) {
        std::memcpy(y_dst - BPS, ty, 16);
        std::memcpy(u_dst - BPS, tu, 8);
        std::memcpy(v_dst - BPS, tv, 8);
      }
      if (mb.i4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mby > 0) {
          if (mbx >= mbw - 1)
            std::memset(top_right, ty[15], 4);
          else
            std::memcpy(top_right, ty + 16, 4);
        }
        for (int r = 1; r <= 3; ++r) std::memcpy(top_right + 4 * r * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          pred4(dst, mb.imodes[n]);
          if (mb.nz_code[n]) idct_add(mb.coeffs + 16 * n, dst);
        }
      } else {
        pred_block(y_dst, 16, check_mode(mbx, mby, mb.imodes[0]));
        for (int n = 0; n < 16; ++n)
          if (mb.nz_code[n])
            idct_add(mb.coeffs + 16 * n, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      const int uvmode = check_mode(mbx, mby, mb.uvmode);
      pred_block(u_dst, 8, uvmode);
      pred_block(v_dst, 8, uvmode);
      for (int k = 0; k < 4; ++k) {
        const int off = (k & 1) * 4 + (k >> 1) * 4 * BPS;
        if (mb.nz_code[16 + k]) idct_add(mb.coeffs + 16 * (16 + k), u_dst + off);
        if (mb.nz_code[20 + k]) idct_add(mb.coeffs + 16 * (20 + k), v_dst + off);
      }
      if (mby < mbh - 1) {
        std::memcpy(ty, y_dst + 15 * BPS, 16);
        std::memcpy(tu, u_dst + 7 * BPS, 8);
        std::memcpy(tv, v_dst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        std::memcpy(Y.data() + (static_cast<long>(mby) * 16 + j) * ys + mbx * 16,
                    y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(U.data() + (static_cast<long>(mby) * 8 + j) * uvs + mbx * 8,
                    u_dst + j * BPS, 8);
        std::memcpy(V.data() + (static_cast<long>(mby) * 8 + j) * uvs + mbx * 8,
                    v_dst + j * BPS, 8);
      }
    }
  }

  // ------------------------------------------------------ loop filter
  static int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
  static int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

  static void do_filter2(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
  }
  static void do_filter4(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
  }
  static void do_filter6(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7,
              a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
  }
  static bool hev(const uint8_t* p, int step, int t) {
    return std::abs(p[-2 * step] - p[-step]) > t || std::abs(p[step] - p[0]) > t;
  }
  static bool needs(const uint8_t* p, int step, int t) {
    return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t;
  }
  static bool needs2(const uint8_t* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step],
              p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step],
              q3 = p[3 * step];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
    return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
           std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
           std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
  }
  // the simple filter along one edge of 16 samples (hstride across it)
  static void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i, p += vstride)
      if (needs(p, hstride, t2)) do_filter2(p, hstride);
  }
  static void loop(uint8_t* p, int hstride, int vstride, int size, int thresh,
                   int ithresh, int hev_t, bool edge) {
    const int t2 = 2 * thresh + 1;
    for (; size-- > 0; p += vstride) {
      if (!needs2(p, hstride, t2, ithresh)) continue;
      if (hev(p, hstride, hev_t))
        do_filter2(p, hstride);
      else if (edge)
        do_filter6(p, hstride);
      else
        do_filter4(p, hstride);
    }
  }

  void filter_mb(int mbx, int mby, const FInfo& f) {
    const int limit = f.limit;
    if (limit == 0) return;
    uint8_t* y = Y.data() + static_cast<long>(mby) * 16 * ys + mbx * 16;
    if (filter_type == 1) {
      if (mbx > 0) simple_edge(y, 1, ys, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_edge(y + 4 * k, 1, ys, limit);
      if (mby > 0) simple_edge(y, ys, 1, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_edge(y + 4 * k * ys, ys, 1, limit);
      return;
    }
    uint8_t* u = U.data() + static_cast<long>(mby) * 8 * uvs + mbx * 8;
    uint8_t* v = V.data() + static_cast<long>(mby) * 8 * uvs + mbx * 8;
    const int il = f.ilevel, hv = f.hev;
    if (mbx > 0) {
      loop(y, 1, ys, 16, limit + 4, il, hv, true);
      loop(u, 1, uvs, 8, limit + 4, il, hv, true);
      loop(v, 1, uvs, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) loop(y + 4 * k, 1, ys, 16, limit, il, hv, false);
      loop(u + 4, 1, uvs, 8, limit, il, hv, false);
      loop(v + 4, 1, uvs, 8, limit, il, hv, false);
    }
    if (mby > 0) {
      loop(y, ys, 1, 16, limit + 4, il, hv, true);
      loop(u, uvs, 1, 8, limit + 4, il, hv, true);
      loop(v, uvs, 1, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) loop(y + 4 * k * ys, ys, 1, 16, limit, il, hv, false);
      loop(u + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
      loop(v + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
    }
  }

  // ------------------------------------------------------ YUV -> RGB
  static int mult_hi(int v, int c) { return (v * c) >> 8; }
  static uint8_t yuv_clip(int v) {
    return (v & ~16383) == 0 ? static_cast<uint8_t>(v >> 6) : v < 0 ? 0 : 255;
  }
  static void yuv_rgb(int y, int u, int v, uint8_t* o) {
    o[0] = yuv_clip(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    o[1] = yuv_clip(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    o[2] = yuv_clip(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
  }

  // libwebp's UpsampleRgbLinePair: luma rows top (and bottom), chroma rows
  // tu/tv above them and cu/cv below, len pixels
  static void upsample_pair(const uint8_t* ty, const uint8_t* by,
                            const uint8_t* tu, const uint8_t* tv,
                            const uint8_t* cu, const uint8_t* cv,
                            uint8_t* top_dst, uint8_t* bot_dst, int len) {
    const int last = (len - 1) >> 1;
    int tl_u = tu[0], tl_v = tv[0], l_u = cu[0], l_v = cv[0];
    yuv_rgb(ty[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
    if (by) yuv_rgb(by[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bot_dst);
    for (int x = 1; x <= last; ++x) {
      const int t_u = tu[x], t_v = tv[x], u = cu[x], v = cv[x];
      const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
      const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
      const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
      yuv_rgb(ty[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1, top_dst + (2 * x - 1) * 3);
      yuv_rgb(ty[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 2 * x * 3);
      if (by) {
        yuv_rgb(by[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1, bot_dst + (2 * x - 1) * 3);
        yuv_rgb(by[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1, bot_dst + 2 * x * 3);
      }
      tl_u = t_u;
      tl_v = t_v;
      l_u = u;
      l_v = v;
    }
    if (!(len & 1)) {
      yuv_rgb(ty[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
              top_dst + (len - 1) * 3);
      if (by)
        yuv_rgb(by[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                bot_dst + (len - 1) * 3);
    }
  }

  // EmitFancyRGB over the whole picture
  void to_rgb(std::vector<uint8_t>* rgb) {
    rgb->assign(static_cast<size_t>(w) * h * 3, 0);
    auto yrow = [&](int r) { return Y.data() + static_cast<long>(r) * ys; };
    auto urow = [&](int r) { return U.data() + static_cast<long>(r) * uvs; };
    auto vrow = [&](int r) { return V.data() + static_cast<long>(r) * uvs; };
    auto orow = [&](int r) { return rgb->data() + static_cast<long>(r) * w * 3; };
    upsample_pair(yrow(0), nullptr, urow(0), vrow(0), urow(0), vrow(0), orow(0),
                  nullptr, w);
    for (int y = 1; y + 1 < h; y += 2)
      upsample_pair(yrow(y), yrow(y + 1), urow((y - 1) / 2), vrow((y - 1) / 2),
                    urow((y + 1) / 2), vrow((y + 1) / 2), orow(y), orow(y + 1), w);
    if (h > 1 && !(h & 1)) {
      const int c = (h - 1) / 2;
      upsample_pair(yrow(h - 1), nullptr, urow(c), vrow(c), urow(c), vrow(c),
                    orow(h - 1), nullptr, w);
    }
  }
};

// the picture (canvas, before turning) as RGB
int decode_picture(const Image& im, std::vector<uint8_t>* canvas) {
  std::vector<uint8_t> frame;
  if (im.lossless) {
    std::vector<uint32_t> argb;
    const int st = decode_lossless(im, &argb);
    if (st) return st;
    frame.resize(argb.size() * 3);
    for (size_t i = 0; i < argb.size(); ++i) {
      frame[3 * i] = static_cast<uint8_t>(argb[i] >> 16);
      frame[3 * i + 1] = static_cast<uint8_t>(argb[i] >> 8);
      frame[3 * i + 2] = static_cast<uint8_t>(argb[i]);
    }
  } else {
    Lossy dec;
    int st = dec.headers(im.data, im.size);
    if (st) return st;
    st = dec.decode(&frame);
    if (st) return st;
  }
  if (im.canvas_w == im.width && im.canvas_h == im.height) {
    canvas->swap(frame);
    return kOk;
  }
  canvas->assign(static_cast<size_t>(im.canvas_w) * im.canvas_h * 3, 0);
  for (int y = 0; y < im.height; ++y)
    std::memcpy(canvas->data() + ((static_cast<long>(y) + im.y_off) * im.canvas_w +
                                  im.x_off) * 3,
                frame.data() + static_cast<long>(y) * im.width * 3,
                static_cast<size_t>(im.width) * 3);
  return kOk;
}

}  // namespace

bool is_webp(const uint8_t* d, long n) {
  return n >= 12 && std::memcmp(d, "RIFF", 4) == 0 &&
         std::memcmp(d + 8, "WEBP", 4) == 0;
}

int webp_info(const uint8_t* d, long n, int* h, int* w) {
  Image im;
  const int st = parse_container(d, n, &im);
  if (st) return st;
  oriented_size(im.orientation, im.canvas_h, im.canvas_w, h, w);
  return kOk;
}

int webp_decode(const uint8_t* d, long n, uint8_t* out, int h, int w) {
  Image im;
  int st = parse_container(d, n, &im);
  if (st) return st;
  int oh, ow;
  oriented_size(im.orientation, im.canvas_h, im.canvas_w, &oh, &ow);
  if (oh != h || ow != w) {
    set_error("WebP size differs from the size asked for");
    return kSizeMismatch;
  }
  std::vector<uint8_t> canvas;
  st = decode_picture(im, &canvas);
  if (st) return st;
  if (im.orientation == 1)
    std::memcpy(out, canvas.data(), canvas.size());
  else
    orient(canvas.data(), im.canvas_h, im.canvas_w, im.orientation, out);
  return kOk;
}

}  // namespace sdt
