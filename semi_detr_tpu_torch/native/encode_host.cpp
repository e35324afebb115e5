// Encoders of the host library for the formats cv2.imwrite writes that
// need more than a header and the raw pixels (BMP and PNM are written in
// numpy, data/image_io.py): TIFF and WebP, as cv2 5.0 writes them for the
// JAX demo's `cv2.imwrite(out, bgr)` of a colour image.
//
// * TIFF: what cv2 writes, tag for tag (probed on cv2 5.0.0): little
//   endian, one IFD of 12 entries (ImageWidth, ImageLength, BitsPerSample
//   8,8,8, Compression 5 = LZW, Photometric 2 = RGB, StripOffsets,
//   SamplesPerPixel 3, RowsPerStrip, StripByteCounts, PlanarConfiguration
//   1, Predictor 2 = horizontal differencing, SampleFormat 1,1,1), strips
//   of max(1, 8192 / row bytes) rows (libtiff's default strip size) from
//   offset 8, the IFD after them and its longer values after it
//   (StripByteCounts' before StripOffsets', as libtiff lays them out;
//   the counts as SHORT under libtiff's size rule). The
//   LZW codes are libtiff's LZWEncode (a clear code first, 9-12 bits MSB
//   first, the width bumped as the next entry passes it, a clear code when
//   the table fills) without its compression-ratio check, which first
//   looks after 10,000 bytes of a strip: so every file whose strips hold
//   fewer bytes (an image under 3,334 pixels wide) is cv2's byte for byte
//   (the tests hold that), and any reads back to the same pixels by cv2
//   and by tiff_host.cpp.
// * WebP: cv2.imwrite's default (quality above 100) is lossless VP8L.
//   This writes a simple VP8L stream: the subtract-green transform, no
//   colour cache and one group of prefix codes, every pixel a literal
//   (no backward references), each code a Huffman code of the channel's
//   histogram limited to 15 bits (a simple code for one or two symbols),
//   its lengths sent literally through a code-length code limited to 7
//   bits, the stream padded with zeros to the 32-byte file cv2 needs to
//   recognise it. Bytes differ from libwebp's; the pixels read back exact
//   by cv2 (libwebp) and by webp_host.cpp.
// * GIF: cv2 5.0's GifEncoder at its default quality: the fixed 3-3-2
//   colour table (red and green in 8 steps of 36, blue in 4 of 85; index
//   r << 5 | g << 2 | b) and Floyd-Steinberg error diffusion onto it, in
//   float32, row by row left to right (7/16 right, 3/16 down-left, 5/16
//   down, 1/16 down-right; a pixel's errors summed before they are added
//   to it), each channel's step index floor(v / step + 0.5) in float32; then GIF89a with a NETSCAPE2.0 loop extension, a
//   graphic control extension (disposal 3, delay 100), one frame and LZW
//   codes of 9-12 bits (a clear code first and whenever the table reaches
//   4,096 entries) in sub-blocks of 255 bytes. The bytes are cv2's (the
//   tests hold them so).
// * Radiance HDR: the picture scaled by 1/255 in float32 (Mat::convertTo)
//   and turned to RGBE by Ward's float2rgbe as OpenCV's rgbe.cpp has it,
//   its header and new-style run-length scanlines (RGBE_WriteBytes_RLE:
//   runs of 4 or more, a short run before one, literals of up to 128
//   bytes; flat pixels for a width under 8). The bytes are cv2's.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "host.h"

namespace sdt {

namespace {

// ================================================================== TIFF

class MsbWriter {
 public:
  explicit MsbWriter(std::vector<uint8_t>* out) : out_(out) {}
  void put(uint32_t code, int nbits) {
    acc_ = (acc_ << nbits) | code;
    have_ += nbits;
    while (have_ >= 8) {
      out_->push_back(static_cast<uint8_t>(acc_ >> (have_ - 8)));
      have_ -= 8;
    }
    acc_ &= (1ull << have_) - 1;
  }
  void flush() {
    if (have_) out_->push_back(static_cast<uint8_t>(acc_ << (8 - have_)));
    have_ = 0;
    acc_ = 0;
  }

 private:
  std::vector<uint8_t>* out_;
  uint64_t acc_ = 0;
  int have_ = 0;
};

// libtiff's LZWEncode of one strip
void lzw_encode(const uint8_t* src, long n, std::vector<uint8_t>* out) {
  constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMax = 4095;
  MsbWriter w(out);
  // the table: (prefix code << 8 | byte) -> code
  std::vector<int> table(4096 * 256, -1);
  int nbits = 9, free_ent = kFirst;
  w.put(kClear, nbits);
  if (n == 0) {
    w.put(kEoi, nbits);
    w.flush();
    return;
  }
  auto reset = [&]() {
    std::fill(table.begin(), table.end(), -1);
    free_ent = kFirst;
  };
  int ent = src[0];
  for (long i = 1; i < n; ++i) {
    const int c = src[i];
    const int hit = table[ent * 256 + c];
    if (hit >= 0) {
      ent = hit;
      continue;
    }
    w.put(ent, nbits);
    table[ent * 256 + c] = free_ent++;
    ent = c;
    if (free_ent == kMax - 1) {
      reset();
      w.put(kClear, nbits);
      nbits = 9;
    } else if (free_ent > (1 << nbits) - 1) {
      ++nbits;
    }
  }
  w.put(ent, nbits);
  ++free_ent;
  if (free_ent == kMax - 1) {
    w.put(kClear, nbits);
    nbits = 9;
  } else if (free_ent > (1 << nbits) - 1) {
    ++nbits;
  }
  w.put(kEoi, nbits);
  w.flush();
}

void put16(std::vector<uint8_t>* b, uint32_t v) {
  b->push_back(v & 255);
  b->push_back((v >> 8) & 255);
}
void put32(std::vector<uint8_t>* b, uint32_t v) {
  put16(b, v & 0xffff);
  put16(b, v >> 16);
}
void set32(std::vector<uint8_t>* b, size_t at, uint32_t v) {
  for (int k = 0; k < 4; ++k) (*b)[at + k] = (v >> (8 * k)) & 255;
}

int tiff_encode(const uint8_t* rgb, int h, int w, std::vector<uint8_t>* f) {
  const long row = 3L * w;
  const int rows = static_cast<int>(
      std::min<long>(h, std::max<long>(1, 8192 / row)));
  const int strips = (h + rows - 1) / rows;
  f->assign({'I', 'I', 42, 0, 0, 0, 0, 0});
  std::vector<uint32_t> offsets, counts;
  std::vector<uint8_t> diff;
  for (int s = 0; s < strips; ++s) {
    const int y0 = s * rows, y1 = std::min(h, y0 + rows);
    diff.assign(rgb + y0 * row, rgb + y1 * row);
    for (int y = 0; y < y1 - y0; ++y) {  // predictor 2, right to left
      uint8_t* r = diff.data() + y * row;
      for (long x = row - 1; x >= 3; --x) r[x] -= r[x - 3];
    }
    offsets.push_back(static_cast<uint32_t>(f->size()));
    const size_t before = f->size();
    lzw_encode(diff.data(), static_cast<long>(diff.size()), f);
    counts.push_back(static_cast<uint32_t>(f->size() - before));
  }
  if (f->size() & 1) f->push_back(0);
  const uint32_t ifd = static_cast<uint32_t>(f->size());
  set32(f, 4, ifd);
  struct Entry {
    uint16_t tag, type;
    std::vector<uint32_t> values;
  };
  const uint16_t kShort = 3, kLong = 4;
  const uint16_t dim = (w > 65535 || h > 65535) ? kLong : kShort;
  // libtiff writes the byte counts of several strips as SHORT when a
  // strip's uncompressed size is under 65535 / 10 (LZW's worst case)
  const bool short_counts = strips > 1 && rows * row < 6553;
  const std::vector<Entry> entries = {
      {256, dim, {uint32_t(w)}},
      {257, dim, {uint32_t(h)}},
      {258, kShort, {8, 8, 8}},
      {259, kShort, {5}},
      {262, kShort, {2}},
      {273, kLong, offsets},
      {277, kShort, {3}},
      {278, rows > 65535 ? kLong : kShort, {uint32_t(rows)}},
      {279, short_counts ? kShort : kLong, counts},
      {284, kShort, {1}},
      {317, kShort, {2}},
      {339, kShort, {1, 1, 1}}};
  // values of more than 4 bytes go after the IFD, in libtiff's order:
  // StripByteCounts' before StripOffsets', the rest by tag
  auto size_of = [&](const Entry& e) {
    return (e.type == kShort ? 2 : 4) * e.values.size();
  };
  const Entry* strip_offsets = nullptr;
  for (const Entry& e : entries)
    if (e.tag == 273) strip_offsets = &e;
  std::vector<const Entry*> order;
  for (const Entry& e : entries) {
    if (size_of(e) > 4 && e.tag != 273) order.push_back(&e);
    if (e.tag == 279 && size_of(*strip_offsets) > 4)
      order.push_back(strip_offsets);
  }
  const size_t extra = ifd + 2 + 12 * entries.size() + 4;
  std::vector<uint8_t> tail;
  std::vector<size_t> at(entries.size(), 0);
  for (const Entry* e : order) {
    at[e - entries.data()] = extra + tail.size();
    for (uint32_t v : e->values) (e->type == kShort ? put16 : put32)(&tail, v);
    if (tail.size() & 1) tail.push_back(0);
  }
  put16(f, static_cast<uint32_t>(entries.size()));
  for (size_t k = 0; k < entries.size(); ++k) {
    const Entry& e = entries[k];
    put16(f, e.tag);
    put16(f, e.type);
    put32(f, static_cast<uint32_t>(e.values.size()));
    if (size_of(e) > 4) {
      put32(f, static_cast<uint32_t>(at[k]));
      continue;
    }
    for (uint32_t v : e.values) (e.type == kShort ? put16 : put32)(f, v);
    for (size_t b = size_of(e); b < 4; ++b) f->push_back(0);
  }
  put32(f, 0);
  f->insert(f->end(), tail.begin(), tail.end());
  return kOk;
}

// ================================================================== WebP

class LsbWriter {
 public:
  void put(uint32_t v, int nbits) {
    acc_ |= static_cast<uint64_t>(v) << have_;
    have_ += nbits;
    while (have_ >= 8) {
      bytes.push_back(static_cast<uint8_t>(acc_));
      acc_ >>= 8;
      have_ -= 8;
    }
  }
  void flush() {
    if (have_) bytes.push_back(static_cast<uint8_t>(acc_));
    acc_ = 0;
    have_ = 0;
  }
  std::vector<uint8_t> bytes;

 private:
  uint64_t acc_ = 0;
  int have_ = 0;
};

// Huffman code lengths of `counts`, none above `limit`: the tree of the
// counts, each raised to at least count_min, count_min doubled until the
// tree is shallow enough (libwebp's approach). Symbols of count 0 get 0.
std::vector<int> code_lengths(const std::vector<uint32_t>& counts, int limit) {
  const int n = static_cast<int>(counts.size());
  std::vector<int> len(n, 0);
  for (uint64_t count_min = 1;; count_min *= 2) {
    struct Node {
      uint64_t weight;
      int left, right, symbol;
    };
    std::vector<Node> nodes;
    std::vector<int> heap;  // node indices, a min-heap by (weight, index)
    for (int s = 0; s < n; ++s)
      if (counts[s]) {
        nodes.push_back({std::max<uint64_t>(counts[s], count_min), -1, -1, s});
        heap.push_back(static_cast<int>(nodes.size()) - 1);
      }
    if (nodes.size() < 2) {
      for (const Node& nd : nodes) len[nd.symbol] = 1;
      return len;
    }
    auto later = [&](int a, int b) {
      return nodes[a].weight != nodes[b].weight
                 ? nodes[a].weight > nodes[b].weight
                 : a > b;
    };
    std::make_heap(heap.begin(), heap.end(), later);
    while (heap.size() > 1) {
      std::pop_heap(heap.begin(), heap.end(), later);
      const int a = heap.back();
      heap.pop_back();
      std::pop_heap(heap.begin(), heap.end(), later);
      const int b = heap.back();
      heap.pop_back();
      nodes.push_back({nodes[a].weight + nodes[b].weight, a, b, -1});
      heap.push_back(static_cast<int>(nodes.size()) - 1);
      std::push_heap(heap.begin(), heap.end(), later);
    }
    int deepest = 0;
    std::vector<std::pair<int, int>> stack = {{heap[0], 0}};
    std::fill(len.begin(), len.end(), 0);
    while (!stack.empty()) {
      auto [i, d] = stack.back();
      stack.pop_back();
      if (nodes[i].symbol >= 0) {
        len[nodes[i].symbol] = d;
        deepest = std::max(deepest, d);
      } else {
        stack.push_back({nodes[i].left, d + 1});
        stack.push_back({nodes[i].right, d + 1});
      }
    }
    if (deepest <= limit) return len;
  }
}

// canonical codes (DEFLATE's order), bit-reversed for an LSB-first stream
std::vector<uint32_t> canonical_codes(const std::vector<int>& len) {
  int max_len = 0;
  for (int l : len) max_len = std::max(max_len, l);
  std::vector<int> count(max_len + 2, 0);
  for (int l : len)
    if (l) ++count[l];
  std::vector<uint32_t> next(max_len + 2, 0);
  uint32_t code = 0;
  for (int b = 1; b <= max_len; ++b) {
    code = (code + count[b - 1]) << 1;
    next[b] = code;
  }
  std::vector<uint32_t> codes(len.size(), 0);
  for (size_t s = 0; s < len.size(); ++s) {
    if (!len[s]) continue;
    uint32_t c = next[len[s]]++, r = 0;
    for (int k = 0; k < len[s]; ++k) r |= ((c >> k) & 1) << (len[s] - 1 - k);
    codes[s] = r;
  }
  return codes;
}

constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};

struct Code {
  std::vector<int> len;
  std::vector<uint32_t> bits;
};

// write the prefix code of `counts` (alphabet counts.size()); returns the
// code to write symbols with
Code write_code(LsbWriter* w, const std::vector<uint32_t>& counts) {
  std::vector<int> used;
  for (size_t s = 0; s < counts.size(); ++s)
    if (counts[s]) used.push_back(static_cast<int>(s));
  Code code;
  code.len.assign(counts.size(), 0);
  code.bits.assign(counts.size(), 0);
  if (used.empty()) used.push_back(0);
  if (used.size() <= 2 && used.back() < 256) {
    // simple code: one symbol (0 bits) or two (1 bit each)
    w->put(1, 1);
    w->put(static_cast<uint32_t>(used.size() - 1), 1);
    const bool wide = used[0] > 1;
    w->put(wide, 1);
    w->put(used[0], wide ? 8 : 1);
    if (used.size() == 2) {
      w->put(used[1], 8);
      code.len[used[0]] = code.len[used[1]] = 1;
      code.bits[used[1]] = 1;
    }
    return code;
  }
  code.len = code_lengths(counts, 15);
  code.bits = canonical_codes(code.len);
  // the code-length code over the literal lengths 0-15
  std::vector<uint32_t> cl_counts(19, 0);
  for (int l : code.len) ++cl_counts[l];
  int distinct = 0;
  for (uint32_t c : cl_counts) distinct += c != 0;
  if (distinct == 1)  // keep it a two-symbol code: a spare length, unused
    ++cl_counts[cl_counts[0] ? 1 : 0];
  std::vector<int> cl_len = code_lengths(cl_counts, 7);
  if (distinct == 1)
    for (int s = 0; s < 19; ++s)
      if (cl_len[s]) cl_len[s] = 1;
  const std::vector<uint32_t> cl_bits = canonical_codes(cl_len);
  int n = 19;
  while (n > 4 && cl_len[kCodeLengthOrder[n - 1]] == 0) --n;
  w->put(0, 1);  // normal code
  w->put(n - 4, 4);
  for (int i = 0; i < n; ++i) w->put(cl_len[kCodeLengthOrder[i]], 3);
  w->put(0, 1);  // max_symbol: the whole alphabet
  for (int l : code.len) w->put(cl_bits[l], cl_len[l]);
  return code;
}

int webp_encode(const uint8_t* rgb, int h, int w, std::vector<uint8_t>* f) {
  if (w < 1 || h < 1 || w > 16384 || h > 16384) {
    set_error("WebP encode: " + std::to_string(w) + "x" + std::to_string(h) +
              " is outside VP8L's 1-16384");
    return kUnsupported;
  }
  const long n = static_cast<long>(h) * w;
  // subtract green: (g, r - g, b - g)
  std::vector<uint8_t> g(n), r(n), b(n);
  for (long i = 0; i < n; ++i) {
    g[i] = rgb[3 * i + 1];
    r[i] = static_cast<uint8_t>(rgb[3 * i] - g[i]);
    b[i] = static_cast<uint8_t>(rgb[3 * i + 2] - g[i]);
  }
  std::vector<uint32_t> hg(280, 0), hr(256, 0), hb(256, 0), ha(256, 0),
      hd(40, 0);
  for (long i = 0; i < n; ++i) {
    ++hg[g[i]];
    ++hr[r[i]];
    ++hb[b[i]];
  }
  ha[255] = static_cast<uint32_t>(n);
  LsbWriter bw;
  bw.put(0x2f, 8);
  bw.put(w - 1, 14);
  bw.put(h - 1, 14);
  bw.put(0, 1);  // alpha_is_used
  bw.put(0, 3);  // version
  bw.put(1, 1);  // a transform:
  bw.put(2, 2);  //   subtract green
  bw.put(0, 1);  // no more transforms
  bw.put(0, 1);  // no colour cache
  bw.put(0, 1);  // one group of prefix codes
  const Code cg = write_code(&bw, hg), cr = write_code(&bw, hr),
             cb = write_code(&bw, hb), ca = write_code(&bw, ha);
  write_code(&bw, hd);
  for (long i = 0; i < n; ++i) {
    bw.put(cg.bits[g[i]], cg.len[g[i]]);
    bw.put(cr.bits[r[i]], cr.len[r[i]]);
    bw.put(cb.bits[b[i]], cb.len[b[i]]);
    bw.put(ca.bits[255], ca.len[255]);
  }
  bw.flush();
  // cv2 takes no WebP file under 32 bytes (its signature check reads 32):
  // zeros after the last pixel's codes, which a decoder never reads, keep
  // a tiny flat picture's file at that length
  while (bw.bytes.size() < 12) bw.bytes.push_back(0);
  const uint32_t chunk = static_cast<uint32_t>(bw.bytes.size());
  const uint32_t pad = chunk & 1;
  f->clear();
  for (char c : std::string("RIFF")) f->push_back(c);
  put32(f, 4 + 8 + chunk + pad);
  for (char c : std::string("WEBPVP8L")) f->push_back(c);
  put32(f, chunk);
  f->insert(f->end(), bw.bytes.begin(), bw.bytes.end());
  if (pad) f->push_back(0);
  return kOk;
}

// Floyd-Steinberg onto the fixed 3-3-2 table, as GifEncoder's fast mode:
// (h, w) indices. Each pixel's diffused errors are summed apart, in the
// order they arrive, and added to it when it is reached.
std::vector<uint8_t> gif_dither(const uint8_t* rgb, int h, int w) {
  std::vector<uint8_t> idx(static_cast<size_t>(h) * w);
  const float step[3] = {36.f, 36.f, 85.f};
  const int top[3] = {7, 7, 3};
  const int shift[3] = {5, 2, 0};
  // this row's and the next row's errors, a pixel of margin either side
  std::vector<float> cur((w + 2) * 3, 0.f), nxt((w + 2) * 3, 0.f);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      int k = 0;
      for (int c = 0; c < 3; ++c) {
        const float v =
            static_cast<float>(rgb[(static_cast<size_t>(y) * w + x) * 3 + c]) +
            cur[(x + 1) * 3 + c];
        int q = static_cast<int>(std::floor(v / step[c] + 0.5f));
        q = std::min(std::max(q, 0), top[c]);
        const float e = v - static_cast<float>(q) * step[c];
        cur[(x + 2) * 3 + c] += e * (7.f / 16.f);
        nxt[x * 3 + c] += e * (3.f / 16.f);
        nxt[(x + 1) * 3 + c] += e * (5.f / 16.f);
        nxt[(x + 2) * 3 + c] += e * (1.f / 16.f);
        k |= q << shift[c];
      }
      idx[static_cast<size_t>(y) * w + x] = static_cast<uint8_t>(k);
    }
    cur.swap(nxt);
    std::fill(nxt.begin(), nxt.end(), 0.f);
  }
  return idx;
}

// GIF LZW of 8-bit indices: codes LSB first, the width growing as the
// decoder's table reaches it
std::vector<uint8_t> gif_lzw(const std::vector<uint8_t>& px) {
  std::vector<uint8_t> out;
  uint32_t acc = 0;
  int nbits = 0, width = 9, next = 258;
  auto put = [&](int code) {
    acc |= static_cast<uint32_t>(code) << nbits;
    nbits += width;
    while (nbits >= 8) {
      out.push_back(static_cast<uint8_t>(acc & 0xFF));
      acc >>= 8;
      nbits -= 8;
    }
  };
  // child[code * 256 + byte]: the code of that string, 0 for none
  std::vector<uint16_t> child(4096 * 256, 0);
  put(256);
  if (px.empty()) {
    put(257);
  } else {
    int cur = px[0];
    for (size_t i = 1; i < px.size(); ++i) {
      const int b = px[i];
      const uint16_t c = child[static_cast<size_t>(cur) * 256 + b];
      if (c) {
        cur = c;
        continue;
      }
      put(cur);
      child[static_cast<size_t>(cur) * 256 + b] = static_cast<uint16_t>(next);
      if (next == (1 << width) && width < 12) ++width;
      if (++next == 4096) {  // the table is full: a clear code
        put(256);
        std::fill(child.begin(), child.end(), 0);
        next = 258;
        width = 9;
      }
      cur = b;
    }
    put(cur);
    put(257);
  }
  if (nbits) out.push_back(static_cast<uint8_t>(acc & 0xFF));
  return out;
}

int gif_encode(const uint8_t* rgb, int h, int w, std::vector<uint8_t>* f) {
  if (h > 0xFFFF || w > 0xFFFF) {
    set_error("GIF holds at most 65535 x 65535 pixels");
    return kTooLarge;
  }
  const std::vector<uint8_t> codes = gif_lzw(gif_dither(rgb, h, w));
  f->clear();
  for (char c : std::string("GIF89a")) f->push_back(c);
  put16(f, w);
  put16(f, h);
  f->push_back(0xF7);  // global table of 256, 8-bit colour resolution
  f->push_back(0);
  f->push_back(0);
  for (int i = 0; i < 256; ++i) {
    f->push_back(static_cast<uint8_t>((i >> 5) * 36));
    f->push_back(static_cast<uint8_t>(((i >> 2) & 7) * 36));
    f->push_back(static_cast<uint8_t>((i & 3) * 85));
  }
  const uint8_t ext[] = {0x21, 0xFF, 0x0B, 'N', 'E', 'T', 'S', 'C', 'A',
                         'P', 'E', '2', '.', '0', 0x03, 0x01, 0x00, 0x00,
                         0x00, 0x21, 0xF9, 0x04, 0x0C, 0x64, 0x00, 0x00,
                         0x00, 0x2C, 0x00, 0x00, 0x00, 0x00};
  f->insert(f->end(), ext, ext + sizeof(ext));
  put16(f, w);
  put16(f, h);
  f->push_back(0x07);
  f->push_back(8);  // LZW minimum code size
  for (size_t at = 0; at < codes.size(); at += 255) {
    const size_t n = std::min<size_t>(255, codes.size() - at);
    f->push_back(static_cast<uint8_t>(n));
    f->insert(f->end(), codes.begin() + at, codes.begin() + at + n);
  }
  f->push_back(0);
  f->push_back(0x3B);
  return kOk;
}

// Ward's float2rgbe as OpenCV's rgbe.cpp has it
void float2rgbe(uint8_t* rgbe, float red, float green, float blue) {
  float v = red;
  if (green > v) v = green;
  if (blue > v) v = blue;
  if (v < 1e-32) {
    rgbe[0] = rgbe[1] = rgbe[2] = rgbe[3] = 0;
    return;
  }
  int e;
  v = static_cast<float>(std::frexp(v, &e) * 256.0 / v);
  rgbe[0] = static_cast<uint8_t>(red * v);
  rgbe[1] = static_cast<uint8_t>(green * v);
  rgbe[2] = static_cast<uint8_t>(blue * v);
  rgbe[3] = static_cast<uint8_t>(e + 128);
}

// RGBE_WriteBytes_RLE of one channel of a scanline
void hdr_rle(const uint8_t* data, int numbytes, std::vector<uint8_t>* f) {
  int cur = 0;
  while (cur < numbytes) {
    int beg_run = cur, run_count = 0, old_run_count = 0;
    while (run_count < 4 && beg_run < numbytes) {
      beg_run += run_count;
      old_run_count = run_count;
      run_count = 1;
      while (beg_run + run_count < numbytes && run_count < 127 &&
             data[beg_run] == data[beg_run + run_count])
        run_count++;
    }
    if (old_run_count > 1 && old_run_count == beg_run - cur) {
      f->push_back(static_cast<uint8_t>(128 + old_run_count));
      f->push_back(data[cur]);
      cur = beg_run;
    }
    while (cur < beg_run) {
      const int n = std::min(beg_run - cur, 128);
      f->push_back(static_cast<uint8_t>(n));
      f->insert(f->end(), data + cur, data + cur + n);
      cur += n;
    }
    if (run_count >= 4) {
      f->push_back(static_cast<uint8_t>(128 + run_count));
      f->push_back(data[beg_run]);
      cur += run_count;
    }
  }
}

int hdr_encode(const uint8_t* rgb, int h, int w, std::vector<uint8_t>* f) {
  const std::string head = "#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y " +
                           std::to_string(h) + " +X " + std::to_string(w) +
                           "\n";
  f->assign(head.begin(), head.end());
  const float scale = 1 / 255.0f;
  std::vector<uint8_t> line(static_cast<size_t>(w) * 4);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const uint8_t* p = rgb + (static_cast<size_t>(y) * w + x) * 3;
      uint8_t e[4];
      float2rgbe(e, p[0] * scale, p[1] * scale, p[2] * scale);
      for (int c = 0; c < 4; ++c) line[c * w + x] = e[c];
    }
    if (w < 8 || w > 0x7FFF) {  // flat pixels
      for (int x = 0; x < w; ++x)
        for (int c = 0; c < 4; ++c) f->push_back(line[c * w + x]);
      continue;
    }
    f->push_back(2);
    f->push_back(2);
    f->push_back(static_cast<uint8_t>(w >> 8));
    f->push_back(static_cast<uint8_t>(w & 0xFF));
    for (int c = 0; c < 4; ++c) hdr_rle(line.data() + c * w, w, f);
  }
  return kOk;
}

int copy_out(const std::vector<uint8_t>& v, uint8_t** out, long* size) {
  *out = static_cast<uint8_t*>(std::malloc(v.empty() ? 1 : v.size()));
  if (!*out) {
    set_error("out of memory");
    return kTooLarge;
  }
  std::memcpy(*out, v.data(), v.size());
  *size = static_cast<long>(v.size());
  return kOk;
}

}  // namespace

}  // namespace sdt

extern "C" {

// (h, w, 3) RGB -> a TIFF file as cv2.imwrite writes it (LZW, predictor
// 2); *out is freed with sdt_free
int sdt_encode_tiff(const uint8_t* rgb, int h, int w, uint8_t** out,
                    long* size) {
  std::vector<uint8_t> f;
  const int st = sdt::tiff_encode(rgb, h, w, &f);
  return st ? st : sdt::copy_out(f, out, size);
}

// (h, w, 3) RGB -> a lossless WebP file (VP8L); *out is freed with sdt_free
int sdt_encode_webp(const uint8_t* rgb, int h, int w, uint8_t** out,
                    long* size) {
  std::vector<uint8_t> f;
  const int st = sdt::webp_encode(rgb, h, w, &f);
  return st ? st : sdt::copy_out(f, out, size);
}

// (h, w, 3) RGB -> the GIF cv2.imwrite writes (3-3-2 table, Floyd-
// Steinberg); *out is freed with sdt_free
int sdt_encode_gif(const uint8_t* rgb, int h, int w, uint8_t** out,
                   long* size) {
  std::vector<uint8_t> f;
  const int st = sdt::gif_encode(rgb, h, w, &f);
  return st ? st : sdt::copy_out(f, out, size);
}

// (h, w, 3) RGB -> the Radiance HDR cv2.imwrite writes (run-length RGBE);
// *out is freed with sdt_free
int sdt_encode_hdr(const uint8_t* rgb, int h, int w, uint8_t** out,
                   long* size) {
  std::vector<uint8_t> f;
  const int st = sdt::hdr_encode(rgb, h, w, &f);
  return st ? st : sdt::copy_out(f, out, size);
}

}  // extern "C"
