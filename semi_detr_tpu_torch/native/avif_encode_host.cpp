// AVIF writing as cv2.imwrite writes a .avif at its defaults (libavif 1.x
// over libaom 3.14.1, 8-bit RGB): the boxes libavif writes for one still
// picture, byte for byte but for the item's extent and data (ftyp avif /
// mif1 / miaf / MA1B; meta with hdlr pict, pitm, iloc version 0 with one
// extent in mdat, iinf with one av01 infe "Color", iprp with ispe, pixi
// 8/8/8, av1C of the sequence header's profile, level and 4:2:0, colr
// nclx 1/13/6 full range, and ipma, av1C essential), then mdat with the
// temporal unit the AV1 encoder of av1_encode.cpp writes.
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "av1.h"
#include "host.h"

namespace sdt {

namespace {

struct Boxes {
  std::vector<uint8_t> b;
  void u8(uint32_t v) { b.push_back(static_cast<uint8_t>(v)); }
  void u16(uint32_t v) {
    u8(v >> 8);
    u8(v);
  }
  void u32(uint32_t v) {
    u16(v >> 16);
    u16(v);
  }
  void tag(const char* t) { b.insert(b.end(), t, t + 4); }
  // a box's header, its size filled in by end()
  size_t begin(const char* type, int full = -1) {
    const size_t at = b.size();
    u32(0);
    tag(type);
    if (full >= 0) u32(static_cast<uint32_t>(full) << 24);  // version, flags 0
    return at;
  }
  void end(size_t at) {
    const uint32_t n = static_cast<uint32_t>(b.size() - at);
    for (int k = 0; k < 4; k++) b[at + k] = static_cast<uint8_t>(n >> (24 - 8 * k));
  }
};

// the AVIF file of one av01 item holding `obus`; level from the sequence
// header's first byte pair (seq_profile, seq_level_idx)
std::vector<uint8_t> avif_file(int h, int w, const std::vector<uint8_t>& obus,
                               int level) {
  Boxes f;
  size_t at = f.begin("ftyp");
  f.tag("avif");
  f.u32(0);
  f.tag("avif");
  f.tag("mif1");
  f.tag("miaf");
  f.tag("MA1B");
  f.end(at);
  const size_t meta = f.begin("meta", 0);
  at = f.begin("hdlr", 0);
  f.u32(0);  // pre_defined
  f.tag("pict");
  for (int i = 0; i < 3; i++) f.u32(0);
  f.u8(0);  // an empty name
  f.end(at);
  at = f.begin("pitm", 0);
  f.u16(1);
  f.end(at);
  at = f.begin("iloc", 0);
  f.u8(0x44);  // offset_size 4, length_size 4
  f.u8(0x00);  // base_offset_size 0
  f.u16(1);    // item_count
  f.u16(1);    // item_ID
  f.u16(0);    // data_reference_index
  f.u16(1);    // extent_count
  const size_t extent = f.b.size();
  f.u32(0);  // extent_offset, set below
  f.u32(static_cast<uint32_t>(obus.size()));
  f.end(at);
  at = f.begin("iinf", 0);
  f.u16(1);
  const size_t infe = f.begin("infe", 2);
  f.u16(1);  // item_ID
  f.u16(0);  // item_protection_index
  f.tag("av01");
  const char name[] = "Color";
  f.b.insert(f.b.end(), name, name + sizeof(name));
  f.end(infe);
  f.end(at);
  const size_t iprp = f.begin("iprp");
  const size_t ipco = f.begin("ipco");
  at = f.begin("ispe", 0);
  f.u32(static_cast<uint32_t>(w));
  f.u32(static_cast<uint32_t>(h));
  f.end(at);
  at = f.begin("pixi", 0);
  f.u8(3);
  for (int i = 0; i < 3; i++) f.u8(8);
  f.end(at);
  at = f.begin("av1C");
  f.u8(0x81);                  // marker, version 1
  f.u8(level & 0x1f);          // seq_profile 0, seq_level_idx_0
  f.u8(0x0c);                  // tier 0, 8-bit, 4:2:0, sample position 0
  f.u8(0x00);                  // no initial presentation delay
  f.end(at);
  at = f.begin("colr");
  f.tag("nclx");
  f.u16(1);    // BT.709 primaries
  f.u16(13);   // sRGB transfer
  f.u16(6);    // BT.601 matrix
  f.u8(0x80);  // full range
  f.end(at);
  f.end(ipco);
  at = f.begin("ipma", 0);
  f.u32(1);  // entry_count
  f.u16(1);  // item_ID
  f.u8(4);
  f.u8(0x01);  // ispe
  f.u8(0x02);  // pixi
  f.u8(0x83);  // av1C, essential
  f.u8(0x04);  // colr
  f.end(at);
  f.end(iprp);
  f.end(meta);
  at = f.begin("mdat");
  const uint32_t offset = static_cast<uint32_t>(f.b.size());
  f.b.insert(f.b.end(), obus.begin(), obus.end());
  f.end(at);
  for (int k = 0; k < 4; k++)
    f.b[extent + k] = static_cast<uint8_t>(offset >> (24 - 8 * k));
  return f.b;
}

// the seq_level_idx of the temporal unit's sequence header: the OBUs
// start with a temporal delimiter (2 bytes), then the sequence header's
// OBU header and one-byte size, then seq_profile (3 bits), still_picture,
// reduced_still_picture_header and the level's 5 bits
int level_of_obus(const std::vector<uint8_t>& obus) {
  return ((obus[4] & 0x07) << 2) | (obus[5] >> 6);
}

int encode(const uint8_t* rgb, int h, int w, std::vector<uint8_t>* file,
           av1::Planes* recon) {
  try {
    if (h < 1 || w < 1) {
      set_error("AVIF encode of an empty picture");
      return kUnsupported;
    }
    std::vector<uint8_t> obus;
    av1::encode_picture(rgb, h, w, &obus, recon);
    *file = avif_file(h, w, obus, level_of_obus(obus));
    return kOk;
  } catch (const av1::Failure& f) {
    set_error(f.msg);
    return f.status;
  }
}

uint8_t* copy_out(const std::vector<uint8_t>& v) {
  uint8_t* out = static_cast<uint8_t*>(std::malloc(v.size()));
  if (out) std::memcpy(out, v.data(), v.size());
  return out;
}

}  // namespace

}  // namespace sdt

extern "C" {

// (h, w, 3) RGB -> the .avif cv2.imwrite writes at its defaults; *out is
// freed with sdt_free. Where recon is not NULL, the encoder's
// reconstruction of the picture too: its Y, U and V planes (h x w, then
// two of (h + 1) / 2 x (w + 1) / 2).
int sdt_encode_avif(const uint8_t* rgb, int h, int w, uint8_t** out, long* size,
                    uint16_t* recon) {
  std::vector<uint8_t> file;
  sdt::av1::Planes p;
  const int st = sdt::encode(rgb, h, w, &file, recon ? &p : nullptr);
  if (st) return st;
  *out = sdt::copy_out(file);
  if (!*out) {
    sdt::set_error("out of memory");
    return sdt::kTooLarge;
  }
  *size = static_cast<long>(file.size());
  for (int k = 0; recon && k < 3; k++) {
    std::memcpy(recon, p.plane[k].data(), p.plane[k].size() * sizeof(uint16_t));
    recon += p.plane[k].size();
  }
  return sdt::kOk;
}

// Seeded symbol round trips (the tests'): item i is kinds[i] (0 a symbol of
// an adaptive CDF of ns[i] symbols, uniform at first, one CDF per alphabet
// size; 1 a boolean; 2 a literal of ns[i] bits; 3 ns(ns[i])) of value
// values[i], written by the encoder's SymbolWriter and read back by the
// decoder's SymbolReader into decoded; the tile's bytes go to out (cap)
// and their count to *size. Returns 1 where the reader ran past the end.
int sdt_av1_symbols(const int* kinds, const int* ns, const int* values,
                    int count, uint8_t* out, long cap, long* size,
                    int* decoded) {
  using sdt::av1::SymbolReader;
  using sdt::av1::SymbolWriter;
  auto uniform = [](uint16_t (*cdf)[18]) {
    for (int n = 2; n <= 16; n++) {
      for (int i = 0; i < n; i++)
        cdf[n][i] = static_cast<uint16_t>(32768 - (i + 1) * 32768 / n);
      cdf[n][n] = 0;
    }
  };
  uint16_t cdf[17][18];
  uniform(cdf);
  SymbolWriter w;
  w.init(false, false);
  for (int i = 0; i < count; i++) {
    switch (kinds[i]) {
      case 0: w.symbol(cdf[ns[i]], ns[i], values[i]); break;
      case 1: w.boolean(values[i]); break;
      case 2: w.literal(ns[i], values[i]); break;
      default: w.ns(ns[i], values[i]); break;
    }
  }
  const std::vector<uint8_t> tile = w.finish();
  *size = static_cast<long>(tile.size());
  if (static_cast<long>(tile.size()) <= cap)
    std::memcpy(out, tile.data(), tile.size());
  uniform(cdf);
  SymbolReader r;
  r.init(tile.data(), static_cast<long>(tile.size()), false);
  for (int i = 0; i < count; i++) {
    switch (kinds[i]) {
      case 0: decoded[i] = r.symbol(cdf[ns[i]], ns[i]); break;
      case 1: decoded[i] = r.boolean(); break;
      case 2: decoded[i] = r.literal(ns[i]); break;
      default: decoded[i] = r.ns(ns[i]); break;
    }
  }
  return r.overrun() ? 1 : 0;
}

}  // extern "C"
