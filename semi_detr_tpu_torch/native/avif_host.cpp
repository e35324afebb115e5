// AVIF (the AV1 image file format) as cv2 5.0 reads it with
// cv2.imread(IMREAD_COLOR): libavif 1.x over libaom 3.14.1. The ISOBMFF
// boxes libavif reads for a still image (ftyp, meta: hdlr, pitm, iloc
// versions 0-2 with data in mdat or idat, iinf / infe, iref, iprp with ipco
// and ipma; the properties ispe, pixi, av1C with its config OBUs, colr
// nclx and ICC, auxC), the primary item decoded by the AV1 decoder of
// av1_*.cpp (an av01 item, or a grid of them), and the planes turned into
// 8-bit RGB as cv2 turns them: YUV through libyuv's constants and chroma
// filters (BT.601, BT.709 and BT.2020, full or limited range, at 4:4:4,
// 4:2:2 and 4:2:0); the identity matrix's planes G, B, R; a monochrome
// plane repeated; 10 and 12 bits scaled as libavif (colour) and cv2 (gray)
// scale them. The alpha item is not decoded: IMREAD_COLOR drops
// it.
#include <algorithm>
#include <cstring>
#include <map>
#include <string>
#include <vector>

#include "av1.h"
#include "host.h"

namespace sdt {

namespace {

using av1::corrupt;
using av1::not_ported;

// a valid file cv2 5.0 does not read either
[[noreturn]] void refuse(const std::string& what) {
  throw av1::Failure{kUnsupported, what + ": cv2 refuses it too"};
}

uint32_t be(const uint8_t* p, int n) {
  uint32_t v = 0;
  for (int i = 0; i < n; i++) v = (v << 8) | p[i];
  return v;
}

struct Box {
  uint32_t type = 0;
  const uint8_t* body = nullptr;
  long size = 0;
};

uint32_t fourcc(const char* s) { return be(reinterpret_cast<const uint8_t*>(s), 4); }

std::string name_of(uint32_t t) {
  std::string s(4, ' ');
  for (int i = 0; i < 4; i++) s[i] = static_cast<char>((t >> (24 - 8 * i)) & 0xff);
  return s;
}

// the boxes of a box's body (or the file)
std::vector<Box> boxes(const uint8_t* d, long n, const char* where) {
  std::vector<Box> out;
  long p = 0;
  while (p < n) {
    if (n - p < 8) corrupt(std::string("AVIF ") + where + ": a box header cut short");
    uint64_t size = be(d + p, 4);
    Box b;
    b.type = be(d + p + 4, 4);
    long hdr = 8;
    if (size == 1) {
      if (n - p < 16) corrupt(std::string("AVIF ") + where + ": a box header cut short");
      size = (uint64_t(be(d + p + 8, 4)) << 32) | be(d + p + 12, 4);
      hdr = 16;
    } else if (size == 0) {
      size = n - p;
    }
    if (size < static_cast<uint64_t>(hdr) || size > static_cast<uint64_t>(n - p))
      corrupt("AVIF " + std::string(where) + ": box '" + name_of(b.type) +
              "' of " + std::to_string(size) + " bytes runs past its end");
    b.body = d + p + hdr;
    b.size = static_cast<long>(size) - hdr;
    out.push_back(b);
    p += static_cast<long>(size);
  }
  return out;
}

// a reader over a box body that fails on a short read
struct Reader {
  const uint8_t* d;
  long n, p = 0;
  const char* what;
  uint32_t u(int bytes) {
    if (bytes == 0) return 0;
    if (p + bytes > n) corrupt(std::string("AVIF ") + what + " box cut short");
    const uint32_t v = be(d + p, bytes);
    p += bytes;
    return v;
  }
  uint64_t u64(int bytes) {  // 0, 4 or 8 bytes
    if (bytes == 8) {
      const uint64_t hi = u(4);
      return (hi << 32) | u(4);
    }
    return u(bytes);
  }
};

struct Extent {
  uint64_t offset, length;
};
struct Item {
  uint32_t id = 0, type = 0;
  int construction = 0;
  uint64_t base = 0;
  std::vector<Extent> extents;
  std::vector<uint32_t> props;  // ipco indices, 1-based
  std::vector<uint32_t> dimg;   // the grid's tiles, in order
  bool aux = false;             // an auxiliary (alpha, depth) image
};

struct Property {
  uint32_t type = 0;
  const uint8_t* body = nullptr;
  long size = 0;
};

struct Avif {
  const uint8_t* file = nullptr;
  long file_size = 0;
  const uint8_t* idat = nullptr;
  long idat_size = 0;
  uint32_t primary = 0;
  std::map<uint32_t, Item> items;
  std::vector<Property> props;

  const Property* prop(const Item& it, const char* type) const {
    const uint32_t t = fourcc(type);
    for (uint32_t i : it.props)
      if (i >= 1 && i <= props.size() && props[i - 1].type == t) return &props[i - 1];
    return nullptr;
  }
  // an item's data, its extents joined
  std::vector<uint8_t> data(const Item& it) const {
    std::vector<uint8_t> out;
    for (const Extent& e : it.extents) {
      const uint8_t* src;
      uint64_t avail;
      const uint64_t off = it.base + e.offset;
      if (it.construction == 0) {
        src = file;
        avail = static_cast<uint64_t>(file_size);
      } else {
        src = idat;
        avail = static_cast<uint64_t>(idat_size);
        if (!idat) corrupt("AVIF item " + std::to_string(it.id) + " in an idat box that is missing");
      }
      uint64_t len = e.length;
      if (len == 0) len = off <= avail ? avail - off : 0;  // to the end
      if (off > avail || len > avail - off)
        corrupt("AVIF item " + std::to_string(it.id) + ": an extent of " +
                std::to_string(len) + " bytes at " + std::to_string(off) +
                " runs past the " + (it.construction ? "idat box" : "file") +
                " (" + std::to_string(avail) + " bytes)");
      out.insert(out.end(), src + off, src + off + len);
    }
    return out;
  }
};

void parse_iloc(Avif& a, const Box& b) {
  Reader r{b.body, b.size, 0, "iloc"};
  const int version = r.u(1);
  r.u(3);
  if (version > 2) corrupt("AVIF iloc version " + std::to_string(version));
  const int sizes = r.u(1), sizes2 = r.u(1);
  const int off_size = sizes >> 4, len_size = sizes & 15, base_size = sizes2 >> 4;
  const int index_size = version ? sizes2 & 15 : 0;
  for (int s : {off_size, len_size, base_size, index_size})
    if (s != 0 && s != 4 && s != 8) corrupt("AVIF iloc field of " + std::to_string(s) + " bytes");
  const uint32_t count = version < 2 ? r.u(2) : r.u(4);
  for (uint32_t i = 0; i < count; i++) {
    const uint32_t id = version < 2 ? r.u(2) : r.u(4);
    Item& it = a.items[id];
    it.id = id;
    if (version >= 1) it.construction = r.u(2) & 15;
    if (it.construction > 1) not_ported("AVIF item data constructed from other items");
    r.u(2);  // data_reference_index
    it.base = r.u64(base_size);
    const uint32_t extents = r.u(2);
    it.extents.clear();
    for (uint32_t e = 0; e < extents; e++) {
      if (index_size) r.u64(index_size);
      Extent x;
      x.offset = r.u64(off_size);
      x.length = r.u64(len_size);
      it.extents.push_back(x);
    }
  }
}

void parse_meta(Avif& a, const Box& meta) {
  if (meta.size < 4) corrupt("AVIF meta box cut short");
  bool pict = false;
  std::vector<Box> ipma;
  for (const Box& b : boxes(meta.body + 4, meta.size - 4, "meta")) {
    const uint32_t t = b.type;
    if (t == fourcc("hdlr")) {
      if (b.size >= 12 && be(b.body + 8, 4) == fourcc("pict")) pict = true;
    } else if (t == fourcc("pitm")) {
      Reader r{b.body, b.size, 0, "pitm"};
      const int version = r.u(1);
      r.u(3);
      a.primary = version == 0 ? r.u(2) : r.u(4);
    } else if (t == fourcc("iloc")) {
      parse_iloc(a, b);
    } else if (t == fourcc("idat")) {
      a.idat = b.body;
      a.idat_size = b.size;
    } else if (t == fourcc("iinf")) {
      Reader r{b.body, b.size, 0, "iinf"};
      const int version = r.u(1);
      r.u(3);
      r.u(version == 0 ? 2 : 4);
      for (const Box& e : boxes(b.body + r.p, b.size - r.p, "iinf")) {
        if (e.type != fourcc("infe")) continue;
        Reader q{e.body, e.size, 0, "infe"};
        const int v = q.u(1);
        q.u(3);
        if (v < 2) not_ported("AVIF infe box of version " + std::to_string(v));
        const uint32_t id = v == 2 ? q.u(2) : q.u(4);
        q.u(2);  // item_protection_index
        Item& it = a.items[id];
        it.id = id;
        it.type = q.u(4);
      }
    } else if (t == fourcc("iref")) {
      Reader r{b.body, b.size, 0, "iref"};
      const int version = r.u(1);
      r.u(3);
      for (const Box& ref : boxes(b.body + 4, b.size - 4, "iref")) {
        Reader q{ref.body, ref.size, 0, "iref"};
        const uint32_t from = version == 0 ? q.u(2) : q.u(4);
        const int n = q.u(2);
        for (int i = 0; i < n; i++) {
          const uint32_t to = version == 0 ? q.u(2) : q.u(4);
          if (ref.type == fourcc("dimg")) a.items[from].dimg.push_back(to);
          if (ref.type == fourcc("auxl")) a.items[from].aux = true;
        }
      }
    } else if (t == fourcc("iprp")) {
      for (const Box& p : boxes(b.body, b.size, "iprp")) {
        if (p.type == fourcc("ipco"))
          for (const Box& q : boxes(p.body, p.size, "ipco"))
            a.props.push_back(Property{q.type, q.body, q.size});
        if (p.type == fourcc("ipma")) ipma.push_back(p);
      }
    }
  }
  if (!pict) corrupt("AVIF meta box without a 'pict' handler");
  for (const Box& b : ipma) {
    Reader r{b.body, b.size, 0, "ipma"};
    const int version = r.u(1);
    const int flags = r.u(3);
    const uint32_t n = r.u(4);
    for (uint32_t i = 0; i < n; i++) {
      const uint32_t id = version < 1 ? r.u(2) : r.u(4);
      const int k = r.u(1);
      for (int j = 0; j < k; j++) {
        const uint32_t v = (flags & 1) ? r.u(2) & 0x7fff : r.u(1) & 0x7f;
        a.items[id].props.push_back(v);
      }
    }
  }
}

Avif parse_file(const uint8_t* d, long n) {
  Avif a;
  a.file = d;
  a.file_size = n;
  bool have_meta = false;
  for (const Box& b : boxes(d, n, "file")) {
    if (b.type == fourcc("meta")) {
      parse_meta(a, b);
      have_meta = true;
    }
  }
  if (!have_meta) not_ported("an AVIF image sequence without a primary item");
  if (!a.items.count(a.primary)) corrupt("AVIF primary item " + std::to_string(a.primary) + " is not described");
  return a;
}

// libyuv's YuvConstants (row_common.cc, named as there) of a matrix and
// range: the luma scale and bias (yg, yb) and the chroma weights (ub, ug,
// vg, vr) in 1/64: JPEG and I601 BT.601 full and limited range, F709 and
// H709 BT.709, V2020 and 2020 BT.2020. The limited-range ub is cut to 128
// (libyuv built without LIBYUV_UNLIMITED_DATA, as cv2's is).
struct YuvConstants {
  int yg, yb, ub, ug, vg, vr;
};
constexpr YuvConstants kYuvJPEG = {16320, 32, 113, 22, 46, 90};
constexpr YuvConstants kYuvI601 = {18997, -1160, 128, 25, 52, 102};
constexpr YuvConstants kYuvF709 = {16320, 32, 119, 12, 30, 101};
constexpr YuvConstants kYuvH709 = {18997, -1160, 128, 14, 34, 115};
constexpr YuvConstants kYuvV2020 = {16320, 32, 120, 11, 37, 94};
constexpr YuvConstants kYuv2020 = {19003, -1160, 128, 12, 42, 107};

// the colour description libavif uses: the nclx colr box if there is one,
// else the sequence header's. libavif hands BT.601 (5, 6, and 2,
// unspecified), BT.709 (1) and BT.2020 NCL (9), full or limited range, to
// libyuv, and chromaticity-derived NCL (12) by its primaries; a monochrome
// plane reaches cv2 as gray, whatever its range. Returns the constants of
// the YUV conversion, or null for the identity matrix's planes G, B, R or a
// monochrome plane.
const YuvConstants* check_colour(const Avif& a, const Item& it, const av1::SequenceHeader& seq) {
  int matrix = seq.matrix, primaries = seq.primaries;
  bool full = seq.full_range;
  for (uint32_t i : it.props) {
    if (i < 1 || i > a.props.size()) continue;
    const Property& p = a.props[i - 1];
    if (p.type == fourcc("colr") && p.size >= 11 && be(p.body, 4) == fourcc("nclx")) {
      primaries = be(p.body + 4, 2);
      matrix = be(p.body + 8, 2);
      full = p.body[10] >> 7;
    }
  }
  if (seq.mono) return nullptr;
  if (!full) av1::count(av1::kToolLimitedRange);
  if (matrix == 0) {
    if (!full) not_ported("AVIF limited-range samples of the identity matrix");
    return nullptr;
  }
  if (matrix == 12) {  // by the primaries, as libavif picks libyuv's
    if (primaries == 1 || primaries == 2) matrix = 1;
    else if (primaries == 5 || primaries == 6) matrix = 6;
    else if (primaries == 9) matrix = 9;
  }
  const YuvConstants* yuv = nullptr;
  if (matrix == 2 || matrix == 5 || matrix == 6) {
    yuv = full ? &kYuvJPEG : &kYuvI601;
    av1::count(av1::kToolBt601);
  } else if (matrix == 1) {
    yuv = full ? &kYuvF709 : &kYuvH709;
    av1::count(av1::kToolBt709);
  } else if (matrix == 9) {
    yuv = full ? &kYuvV2020 : &kYuv2020;
    av1::count(av1::kToolBt2020);
  } else {
    not_ported("AVIF YUV to RGB (matrix_coefficients " + std::to_string(matrix) +
               ", which libavif converts without libyuv)");
  }
  if (seq.ssy && !seq.ssx)
    not_ported("AVIF YUV 4:4:0, which libavif converts without libyuv");
  return yuv;
}

// an av01 item's headers, from its av1C config OBUs and its data, which
// stays in *data (the picture's tile data points into it)
void load_item(const Avif& a, const Item& it, std::vector<uint8_t>* data,
               av1::Picture* pic) {
  if (it.type != fourcc("av01"))
    corrupt("AVIF item " + std::to_string(it.id) + " of type '" + name_of(it.type) + "' is not an AV1 image");
  const Property* c = a.prop(it, "av1C");
  if (!c || c->size < 4) corrupt("AVIF item " + std::to_string(it.id) + " has no av1C property");
  if (!a.prop(it, "ispe")) corrupt("AVIF item " + std::to_string(it.id) + " has no ispe property");
  *data = a.data(it);
  av1::parse_obus(c->body + 4, c->size - 4, data->data(),
                  static_cast<long>(data->size()), pic);
}

// an av01 item decoded to its planes; returns check_colour's constants
const YuvConstants* decode_item(const Avif& a, const Item& it, av1::Planes* out) {
  std::vector<uint8_t> data;
  av1::Picture pic;
  load_item(a, it, &data, &pic);
  const YuvConstants* yuv = check_colour(a, it, pic.seq);
  av1::decode_picture(pic, out);
  return yuv;
}

// libyuv's ScaleRowUp2_Linear (the Any form): a chroma row twice as wide,
// each pair of neighbours weighted 3:1 and 1:3, the ends copied
void up_linear(const uint8_t* s, int w, uint8_t* d) {
  const int work = (w - 1) & ~1;
  d[0] = s[0];
  for (int x = 0; x < work / 2; x++) {
    d[2 * x + 1] = static_cast<uint8_t>((s[x] * 3 + s[x + 1] + 2) >> 2);
    d[2 * x + 2] = static_cast<uint8_t>((s[x] + s[x + 1] * 3 + 2) >> 2);
  }
  d[w - 1] = s[(w - 1) / 2];
}

// libyuv's ScaleRowUp2_Bilinear (the Any form): the two output rows
// between chroma rows s and t (weighted 3:1 and 1:3), 9-3-3-1 inside, the
// ends from one column
void up_bilinear(const uint8_t* s, const uint8_t* t, int w, uint8_t* d, uint8_t* e) {
  const int work = (w - 1) & ~1;
  d[0] = static_cast<uint8_t>((3 * s[0] + t[0] + 2) >> 2);
  e[0] = static_cast<uint8_t>((s[0] + 3 * t[0] + 2) >> 2);
  for (int x = 0; x < work / 2; x++) {
    d[2 * x + 1] = static_cast<uint8_t>((s[x] * 9 + s[x + 1] * 3 + t[x] * 3 + t[x + 1] + 8) >> 4);
    d[2 * x + 2] = static_cast<uint8_t>((s[x] * 3 + s[x + 1] * 9 + t[x] + t[x + 1] * 3 + 8) >> 4);
    e[2 * x + 1] = static_cast<uint8_t>((s[x] * 3 + s[x + 1] + t[x] * 9 + t[x + 1] * 3 + 8) >> 4);
    e[2 * x + 2] = static_cast<uint8_t>((s[x] + s[x + 1] * 3 + t[x] * 3 + t[x + 1] * 9 + 8) >> 4);
  }
  const int c = (w - 1) / 2;
  d[w - 1] = static_cast<uint8_t>((3 * s[c] + t[c] + 2) >> 2);
  e[w - 1] = static_cast<uint8_t>((s[c] + 3 * t[c] + 2) >> 2);
}

// 8-bit RGB from YUV planes as cv2's libavif makes it with libyuv:
// samples above 8 bits cut to 8 (Convert16To8Plane); 4:2:0 chroma
// upsampled bilinearly row pair by row pair (I420ToRGB24MatrixFilter: the
// first row, and the last of an even height, from one chroma row), 4:2:2
// chroma linearly along each row (I422ToRGB24MatrixFilter), 4:4:4 taken as
// it is (I444ToRGB24Matrix); then YuvPixel's fixed point: y * 0x0101 * yg
// >> 16, + yb, the chroma weights times (u - 128) and (v - 128), >> 6
void yuv_to_rgb(const av1::Planes& p, const YuvConstants& k, uint8_t* out,
                int stride_px, int x0, int y0) {
  const int w = p.width, h = p.height;
  const int cw = (w + p.ssx) >> p.ssx, ch = (h + p.ssy) >> p.ssy;
  const int shift = p.bit_depth - 8;
  std::vector<uint8_t> u8(static_cast<size_t>(cw) * ch), v8(u8.size());
  for (size_t i = 0; i < u8.size(); i++) {
    u8[i] = static_cast<uint8_t>(p.plane[1][i] >> shift);
    v8[i] = static_cast<uint8_t>(p.plane[2][i] >> shift);
  }
  std::vector<uint8_t> ru[2], rv[2];
  for (int j = 0; j < 2; j++) {
    ru[j].resize(w);
    rv[j].resize(w);
  }
  auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
  auto emit = [&](int y, const uint8_t* u, const uint8_t* v) {
    const uint16_t* yr = p.plane[0].data() + static_cast<size_t>(y) * w;
    uint8_t* o = out + (static_cast<size_t>(y0 + y) * stride_px + x0) * 3;
    for (int x = 0; x < w; x++) {
      const uint32_t y32 = static_cast<uint32_t>(yr[x] >> shift) * 0x0101;
      const int y1 = static_cast<int>((y32 * static_cast<uint32_t>(k.yg)) >> 16) + k.yb;
      const int ui = u[x] - 128, vi = v[x] - 128;
      o[3 * x + 0] = clamp((y1 + vi * k.vr) >> 6);
      o[3 * x + 1] = clamp((y1 - (ui * k.ug + vi * k.vg)) >> 6);
      o[3 * x + 2] = clamp((y1 + ui * k.ub) >> 6);
    }
  };
  const uint8_t* uc = u8.data();
  const uint8_t* vc = v8.data();
  if (!p.ssx) {
    for (int y = 0; y < h; y++)
      emit(y, uc + static_cast<size_t>(y) * cw, vc + static_cast<size_t>(y) * cw);
    return;
  }
  av1::count(av1::kToolChromaUpsample);
  if (!p.ssy) {
    for (int y = 0; y < h; y++) {
      up_linear(uc + static_cast<size_t>(y) * cw, w, ru[0].data());
      up_linear(vc + static_cast<size_t>(y) * cw, w, rv[0].data());
      emit(y, ru[0].data(), rv[0].data());
    }
    return;
  }
  up_linear(uc, w, ru[0].data());
  up_linear(vc, w, rv[0].data());
  emit(0, ru[0].data(), rv[0].data());
  int y = 1;
  for (; y < h - 1; y += 2) {
    up_bilinear(uc, uc + cw, w, ru[0].data(), ru[1].data());
    up_bilinear(vc, vc + cw, w, rv[0].data(), rv[1].data());
    emit(y, ru[0].data(), rv[0].data());
    emit(y + 1, ru[1].data(), rv[1].data());
    uc += cw;
    vc += cw;
  }
  if (y == h - 1) {  // an even height: its last row from the last chroma row
    up_linear(uc, w, ru[0].data());
    up_linear(vc, w, rv[0].data());
    emit(y, ru[0].data(), rv[0].data());
  }
}

// 8-bit RGB from the planes: 3 planes of the identity matrix are G, B, R;
// libavif scales 10 and 12 bits by v * 255 / max, rounded; a monochrome
// plane reaches cv2 as gray, scaled by 2^(8 - depth) and rounded to even
void to_rgb(const av1::Planes& p, uint8_t* out, int stride_px, int x0, int y0) {
  const int mx = (1 << p.bit_depth) - 1, shift = p.bit_depth - 8;
  auto colour = [&](int v) {
    return p.bit_depth == 8 ? v : (v * 255 + (mx >> 1)) / mx;
  };
  auto gray = [&](int v) {
    if (!shift) return v;
    int q = v >> shift;
    const int rem = v & ((1 << shift) - 1), half = 1 << (shift - 1);
    if (rem > half || (rem == half && (q & 1))) q++;
    return std::min(q, 255);
  };
  for (int y = 0; y < p.height; y++)
    for (int x = 0; x < p.width; x++) {
      const size_t i = static_cast<size_t>(y) * p.width + x;
      uint8_t* o = out + (static_cast<size_t>(y0 + y) * stride_px + x0 + x) * 3;
      if (p.count == 1) {
        o[0] = o[1] = o[2] = static_cast<uint8_t>(gray(p.plane[0][i]));
      } else {
        o[0] = static_cast<uint8_t>(colour(p.plane[2][i]));
        o[1] = static_cast<uint8_t>(colour(p.plane[0][i]));
        o[2] = static_cast<uint8_t>(colour(p.plane[1][i]));
      }
    }
}

struct Layout {
  int h = 0, w = 0;
  int rows = 1, cols = 1;  // a grid's
  std::vector<const Item*> tiles;
};

Layout layout(const Avif& a) {
  const Item& primary = a.items.at(a.primary);
  Layout l;
  if (primary.type == fourcc("grid")) {
    av1::count(av1::kToolGrid);
    std::vector<uint8_t> g = a.data(primary);
    if (g.size() < 8) corrupt("AVIF grid item cut short");
    const int flags = g[1];
    l.rows = g[2] + 1;
    l.cols = g[3] + 1;
    const int fs = (flags & 1) ? 4 : 2;
    if (g.size() < static_cast<size_t>(4 + 2 * fs)) corrupt("AVIF grid item cut short");
    l.w = be(g.data() + 4, fs);
    l.h = be(g.data() + 4 + fs, fs);
    if (static_cast<int>(primary.dimg.size()) != l.rows * l.cols)
      corrupt("AVIF grid of " + std::to_string(l.rows * l.cols) + " cells with " +
              std::to_string(primary.dimg.size()) + " tiles");
    if (l.w > 65535 || l.h > 65535 || l.w < 1 || l.h < 1)
      corrupt("AVIF grid of " + std::to_string(l.w) + "x" + std::to_string(l.h));
    for (uint32_t id : primary.dimg) {
      if (!a.items.count(id)) corrupt("AVIF grid tile " + std::to_string(id) + " is not described");
      l.tiles.push_back(&a.items.at(id));
    }
  } else {
    av1::Picture pic;
    std::vector<uint8_t> data;
    load_item(a, primary, &data, &pic);
    l.w = pic.frame.width;
    l.h = pic.frame.height;
    l.tiles.push_back(&primary);
  }
  for (const auto& kv : a.items)
    if (kv.second.aux) av1::count(av1::kToolAlphaItem);
  // irot, imir and clap are read past: cv2 5.0 gives the picture as
  // coded (libavif leaves the transforms to its caller)
  if (l.w <= 0 || l.h <= 0) corrupt("AVIF image of no pixels");
  if (primary.type == fourcc("grid")) {
    // libavif's grid rules (MIAF 7.3.11.4.2): tiles of 64 x 64 or more,
    // and a grid that reaches into its last row and column of tiles
    av1::Picture pic;
    std::vector<uint8_t> data;
    load_item(a, *l.tiles[0], &data, &pic);
    const int tw = pic.frame.width, th = pic.frame.height;
    if (tw < 64 || th < 64)
      refuse("an AVIF grid of tiles smaller than 64 x 64");
    if (l.w > tw * l.cols || l.w <= tw * (l.cols - 1) ||
        l.h > th * l.rows || l.h <= th * (l.rows - 1))
      refuse("an AVIF grid whose size does not end in its last tiles");
  }
  return l;
}

int fail(const av1::Failure& f) {
  set_error(f.msg);
  return f.status;
}

}  // namespace

bool is_avif(const uint8_t* d, long n) {
  if (n < 16 || std::memcmp(d + 4, "ftyp", 4) != 0) return false;
  const long box = std::min<long>(be(d, 4), n);
  for (long p = 8; p + 4 <= box; p += 4)  // major, version, compatible
    if (p != 12 && (std::memcmp(d + p, "avif", 4) == 0 ||
                    std::memcmp(d + p, "avis", 4) == 0))
      return true;
  return false;
}

int avif_info(const uint8_t* d, long n, int* h, int* w) {
  try {
    const Avif a = parse_file(d, n);
    const Layout l = layout(a);
    *h = l.h;
    *w = l.w;
    return kOk;
  } catch (const av1::Failure& f) {
    return fail(f);
  }
}

int avif_decode(const uint8_t* d, long n, uint8_t* out, int h, int w) {
  try {
    const Avif a = parse_file(d, n);
    const Layout l = layout(a);
    if (l.h != h || l.w != w) {
      set_error("AVIF picture is " + std::to_string(l.h) + "x" + std::to_string(l.w) +
                ", not the " + std::to_string(h) + "x" + std::to_string(w) + " asked");
      return kSizeMismatch;
    }
    // the tiles (one for an av01 item) of one size, row by row, cropped
    std::vector<uint8_t> canvas;
    int tw = 0, th = 0;
    for (size_t k = 0; k < l.tiles.size(); k++) {
      av1::Planes p;
      const YuvConstants* yuv = decode_item(a, *l.tiles[k], &p);
      if (k == 0) {
        tw = p.width;
        th = p.height;
        if (tw * l.cols < w || th * l.rows < h)
          corrupt("AVIF grid tiles do not cover the grid");
        canvas.assign(static_cast<size_t>(th * l.rows) * tw * l.cols * 3, 0);
      } else if (p.width != tw || p.height != th) {
        corrupt("AVIF grid tiles of different sizes");
      }
      const int cx = static_cast<int>(k % l.cols) * tw, cy = static_cast<int>(k / l.cols) * th;
      if (yuv)
        yuv_to_rgb(p, *yuv, canvas.data(), tw * l.cols, cx, cy);
      else
        to_rgb(p, canvas.data(), tw * l.cols, cx, cy);
    }
    for (int y = 0; y < h; y++)
      std::memcpy(out + static_cast<size_t>(y) * w * 3,
                  canvas.data() + static_cast<size_t>(y) * tw * l.cols * 3, w * 3);
    return kOk;
  } catch (const av1::Failure& f) {
    return fail(f);
  }
}

int avif_planes(const uint8_t* d, long n, int filters, uint16_t* out,
                long cap, int* info) {
  try {
    const Avif a = parse_file(d, n);
    const Item& primary = a.items.at(a.primary);
    av1::Planes p;
    std::vector<uint8_t> data;
    av1::Picture pic;
    load_item(a, primary, &data, &pic);
    av1::decode_picture(pic, &p, filters);
    info[0] = p.width;
    info[1] = p.height;
    info[2] = p.count;
    info[3] = p.ssx;
    info[4] = p.ssy;
    info[5] = p.bit_depth;
    long total = 0;
    for (int k = 0; k < p.count; k++) total += static_cast<long>(p.plane[k].size());
    if (out && cap >= total) {
      for (int k = 0; k < p.count; k++) {
        std::memcpy(out, p.plane[k].data(), p.plane[k].size() * sizeof(uint16_t));
        out += p.plane[k].size();
      }
    }
    return kOk;
  } catch (const av1::Failure& f) {
    return fail(f);
  }
}

}  // namespace sdt

extern "C" {

// the per-process tally of the AV1 tools decoded: writes up to n counts,
// returns the number of tools
int sdt_avif_tally(long* counts, int n) {
  for (int i = 0; i < n && i < sdt::av1::kToolCount; i++)
    counts[i] = sdt::av1::g_tally[i].load();
  return sdt::av1::kToolCount;
}

const char* sdt_avif_tool_name(int i) {
  return i >= 0 && i < sdt::av1::kToolCount ? sdt::av1::kToolNames[i] : "";
}

// The decoded planes of an AVIF's primary av01 item, with the in-loop
// filters of `filters` (av1::kFilter*) applied: info gets width, height,
// plane count, chroma subsampling x and y and bit depth; out (when cap
// holds them) every plane's samples one after another, row by row. The
// stages are held to a conformant decoder's planes by the tests.
int sdt_avif_planes(const uint8_t* d, long n, int filters, uint16_t* out,
                    long cap, int* info) {
  return sdt::avif_planes(d, n, filters, out, cap, info);
}

}  // extern "C"
