// GIF decoder of the host library, to the pixels cv2.imread (IMREAD_COLOR,
// BGR turned to RGB) gives the JAX package's loader: OpenCV 5.0's
// GifDecoder (grfmt_gif.cpp), which reads the first frame onto the logical
// screen, its quirks included.
//
// * GIF87a and GIF89a. The whole block structure is walked to the trailer
//   first (OpenCV counts the frames in its header read): a file cut
//   anywhere, or a block of an unknown kind, fails.
// * The picture has the logical screen's size. Pixels outside the first
//   frame's rectangle, and the frame's transparent pixels, take the global
//   colour table's entry at the screen's background index (black where the
//   file has no global table); a background index past the global table
//   fails. A frame that does not fit on the screen fails.
// * Colours: the frame's local table, else the global one, else OpenCV's
//   default table (entry i gray i, but entry 1 white). An index past the
//   frame's table takes the global table's entry where it has one, else
//   fails.
// * LZW of minimum code size 2-11: clear codes anywhere, the 12-bit cap
//   with a full table and no clear (a deferred clear), the end code or the
//   end of the data ending the frame (the padding bits after an end code
//   are not read). A code past the table, a first code after a clear that
//   is not a literal, a frame left short or overrun fails. (cv2 5.0 also
//   reads some malformed streams whose codes go on past an end code and
//   refuses others; the probes found no rule for them, and this decoder
//   takes none of them.)
// * A Graphic Control extension's disposal method above 3 fails; other
//   extensions are skipped. Interlaced frames take their rows in the four
//   passes.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "host.h"

namespace sdt {

namespace {

int bad(const std::string& what) {
  set_error("GIF: damaged data: " + what);
  return kCorrupt;
}

int refused(const std::string& what) {
  set_error("GIF: " + what + " (cv2 refuses it too)");
  return kUnsupported;
}

uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }

struct Gif {
  int w = 0, h = 0;        // logical screen
  int bg = 0;              // background index
  int global_size = 0;     // entries of the global table (0: none)
  long global_at = 0;      // its offset
  int transparent = -1;    // the first frame's transparent index
  int fx = 0, fy = 0, fw = 0, fh = 0;  // the first frame's rectangle
  bool interlaced = false;
  int local_size = 0;
  long local_at = 0;
  long lzw_at = 0;         // the minimum code size byte of the first frame
};

// skips a chain of sub-blocks at *p; false where the file ends inside it
bool skip_blocks(const uint8_t* d, long n, long* p) {
  while (true) {
    if (*p >= n) return false;
    const int len = d[(*p)++];
    if (len == 0) return true;
    *p += len;
  }
}

int parse(const uint8_t* d, long n, Gif* g) {
  if (n < 13) return bad("file ends inside its screen descriptor");
  g->w = static_cast<int>(le16(d + 6));
  g->h = static_cast<int>(le16(d + 8));
  if (g->w == 0 || g->h == 0) return refused("a logical screen of size 0");
  const int flags = d[10];
  g->bg = d[11];
  long p = 13;
  if (flags & 0x80) {
    g->global_size = 1 << ((flags & 7) + 1);
    g->global_at = p;
    p += 3L * g->global_size;
    if (p > n) return bad("file ends inside its global colour table");
    if (g->bg >= g->global_size)
      return refused("a background index past the global colour table");
  }
  bool frame = false;
  int transparent = -1, disposal = 0;
  while (true) {
    if (p >= n) return bad("file ends before its trailer");
    const int kind = d[p++];
    if (kind == 0x3B) break;
    if (kind == 0x21) {
      if (p >= n) return bad("file ends inside an extension");
      const int label = d[p++];
      if (label == 0xF9 && !frame && p + 5 <= n && d[p] == 4) {
        disposal = (d[p + 1] >> 2) & 7;
        transparent = (d[p + 1] & 1) ? d[p + 4] : -1;
      }
      if (!skip_blocks(d, n, &p)) return bad("file ends inside an extension");
      continue;
    }
    if (kind != 0x2C) return bad("a block of unknown kind " + std::to_string(kind));
    if (p + 9 > n) return bad("file ends inside an image descriptor");
    const int fl = d[p + 8];
    if (!frame) {
      if (disposal > 3)
        return refused("disposal method " + std::to_string(disposal));
      g->fx = static_cast<int>(le16(d + p));
      g->fy = static_cast<int>(le16(d + p + 2));
      g->fw = static_cast<int>(le16(d + p + 4));
      g->fh = static_cast<int>(le16(d + p + 6));
      g->interlaced = fl & 0x40;
      g->transparent = transparent;
    }
    p += 9;
    if (fl & 0x80) {
      if (!frame) {
        g->local_size = 1 << ((fl & 7) + 1);
        g->local_at = p;
      }
      p += 3L * (1 << ((fl & 7) + 1));
    }
    if (p >= n) return bad("file ends inside an image");
    if (!frame) g->lzw_at = p;
    ++p;
    if (!skip_blocks(d, n, &p)) return bad("file ends inside an image's data");
    frame = true;
  }
  if (!frame) return bad("no image");
  if (g->fw == 0 || g->fh == 0 || g->fx + g->fw > g->w ||
      g->fy + g->fh > g->h)
    return refused("a first frame outside the logical screen");
  return kOk;
}

// the first frame's LZW codes into idx (fw * fh indices, in the order the
// rows are stored)
int lzw(const uint8_t* d, const Gif& g, std::vector<uint8_t>* idx) {
  long p = g.lzw_at;
  const int min_size = d[p++];
  if (min_size < 2 || min_size > 11)
    return refused("LZW minimum code size " + std::to_string(min_size));
  const int clear = 1 << min_size, end = clear + 1;
  struct Entry {
    int prefix;
    uint16_t length;
    uint8_t first, last;
  };
  std::vector<Entry> tab(4096);
  for (int i = 0; i < clear; ++i)
    tab[i] = {-1, 1, static_cast<uint8_t>(i), static_cast<uint8_t>(i)};
  const long want = static_cast<long>(g.fw) * g.fh;
  idx->assign(want, 0);
  long filled = 0;
  int size = min_size + 1, avail = end + 1, prev = -1;
  uint32_t acc = 0;
  int have = 0, block = 0;
  while (true) {
    while (have < size) {
      if (block == 0) {
        block = d[p++];  // parse() walked the sub-blocks
        if (block == 0) {
          if (filled < want) return bad("LZW data ends before the frame does");
          return kOk;
        }
      }
      acc |= static_cast<uint32_t>(d[p++]) << have;
      have += 8;
      --block;
    }
    const int code = static_cast<int>(acc & ((1u << size) - 1));
    acc >>= size;
    have -= size;
    if (code == end) break;
    if (code == clear) {
      size = min_size + 1;
      avail = end + 1;
      prev = -1;
      continue;
    }
    if (prev < 0) {
      if (code >= clear) return bad("a first code after a clear past the table");
    } else if (code > avail || (code == avail && avail >= 4096)) {
      return bad("an LZW code past the table");
    }
    if (prev >= 0 && avail < 4096) {
      const int base = code == avail ? prev : code;
      tab[avail] = {prev, static_cast<uint16_t>(tab[prev].length + 1),
                    tab[prev].first, tab[base].first};
      ++avail;
      if (avail == (1 << size) && size < 12) ++size;
    }
    const int len = tab[code].length;
    if (filled + len > want) return bad("LZW data runs past the frame");
    int c = code;
    for (int k = len - 1; k >= 0; --k) {
      (*idx)[filled + k] = tab[c].last;
      c = tab[c].prefix;
    }
    filled += len;
    prev = code;
  }
  if (filled < want) return bad("LZW data ends before the frame does");
  return kOk;
}

int decode(const uint8_t* d, const Gif& g, uint8_t* out) {
  std::vector<uint8_t> idx;
  const int st = lzw(d, g, &idx);
  if (st) return st;
  // the canvas: the global table's background colour, else black
  uint8_t bg[3] = {0, 0, 0};
  if (g.global_size) std::memcpy(bg, d + g.global_at + 3L * g.bg, 3);
  const long px = static_cast<long>(g.w) * g.h;
  for (long i = 0; i < px; ++i) std::memcpy(out + 3 * i, bg, 3);
  const uint8_t* table = g.local_size ? d + g.local_at
                         : g.global_size ? d + g.global_at : nullptr;
  const int size = g.local_size ? g.local_size : g.global_size;
  // the row order of the stored rows
  std::vector<int> rows;
  if (g.interlaced) {
    static const int kStart[4] = {0, 4, 2, 1}, kStep[4] = {8, 8, 4, 2};
    for (int pass = 0; pass < 4; ++pass)
      for (int y = kStart[pass]; y < g.fh; y += kStep[pass]) rows.push_back(y);
  } else {
    for (int y = 0; y < g.fh; ++y) rows.push_back(y);
  }
  long k = 0;
  for (int y : rows) {
    uint8_t* o = out + (static_cast<long>(g.fy + y) * g.w + g.fx) * 3;
    for (int x = 0; x < g.fw; ++x, ++k, o += 3) {
      const int v = idx[k];
      if (v == g.transparent) {
        std::memcpy(o, bg, 3);
      } else if (!table) {  // OpenCV's default table
        o[0] = o[1] = o[2] = static_cast<uint8_t>(v == 1 ? 255 : v);
      } else if (v < size) {
        std::memcpy(o, table + 3 * v, 3);
      } else if (v < g.global_size) {
        std::memcpy(o, d + g.global_at + 3 * v, 3);
      } else {
        return refused("colour index " + std::to_string(v) +
                       " past the colour table");
      }
    }
  }
  return kOk;
}

}  // namespace

bool is_gif(const uint8_t* d, long n) {
  return n >= 6 && (std::memcmp(d, "GIF87a", 6) == 0 ||
                    std::memcmp(d, "GIF89a", 6) == 0);
}

int gif_info(const uint8_t* d, long n, int* h, int* w) {
  Gif g;
  const int st = parse(d, n, &g);
  if (st) return st;
  *h = g.h;
  *w = g.w;
  return kOk;
}

int gif_decode(const uint8_t* d, long n, uint8_t* out, int h, int w) {
  Gif g;
  const int st = parse(d, n, &g);
  if (st) return st;
  if (g.h != h || g.w != w) {
    set_error("GIF size differs from the size asked for");
    return kSizeMismatch;
  }
  return decode(d, g, out);
}

}  // namespace sdt
