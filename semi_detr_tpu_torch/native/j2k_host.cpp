// JPEG 2000, as a JP2 file or a raw codestream (.j2k / .j2c), decoded by
// the library itself to what cv2.imread(path, IMREAD_COLOR) gives for it
// (cv2 5.0 reads it through OpenJPEG 2.5.3), BGR turned to RGB.
//
// * The JP2 boxes as OpenJPEG's jp2.c walks them: the signature box first
//   and ftyp second, jp2h (ihdr first, then colr, bpcc, pclr, cmap and
//   cdef) before jp2c; a palette applied as opj_jp2_apply_pclr applies it
//   (indices clipped to the table), then the channel definitions as
//   opj_jp2_apply_cdef swaps them.
// * The codestream as OpenJPEG decodes it in its strict mode (the default):
//   SIZ, COD / COC, QCD / QCC (none, scalar derived, scalar expounded),
//   RGN, POC, PPM and PPT; TLM, PLM, PLT, CRG and COM walked past; tile-
//   parts of any tile in any order, a tile decoded once its last part is
//   read (or at EOC); a tile-part running past the end of the data, or
//   a stream that ends before its EOC marker, fails.
// * Tier-2 (t2.c): tag trees, packet headers with their bit stuffing, the
//   segment lengths under TERMALL and BYPASS, SOP and EPH markers, the five
//   progression orders and POC (pi.c's loops, each packet read once).
// * Tier-1 (t1.c): the MQ decoder with its 47 states, the significance,
//   refinement and cleanup passes over the 19 contexts, every code-block
//   style (BYPASS, RESET, TERMALL, VSC, predictable termination,
//   segmentation symbols), coefficients kept at twice their magnitude with
//   the half-interval reconstruction, ROI max-shift undone as t1.c undoes
//   it.
// * Dequantisation (tcd.c's step sizes, with the decoder's gain of 0 for
//   the 9/7 wavelet), the 5/3 wavelet in integers and the 9/7 in float32
//   in opj_v8dwt_decode's order (its 2/K for the high band), the RCT and
//   the float ICT, the DC level shift with lrintf and the clip to the
//   component's precision. g++'s -ffp-contract=off keeps every float
//   product and sum apart, as OpenJPEG's SSE code computes them.
// * cv2's conversion (grfmt_jpeg2000_openjpeg.cpp): 1 to 4 components,
//   none signed, precision 8 or more (above 8 shifted right by the largest
//   precision less 8). sRGB, and any colour space OpenJPEG does not name
//   (none in a raw codestream, CIELab, an ICC profile), gives R, G, B from
//   the first three of 3 or 4 components and is refused for 1 or 2; gray
//   repeats the first; sYCC goes through cvtColor's YUV2BGR; CMYK and
//   e-sYCC are refused. Every component must lie at the origin at full
//   size (no image offset, no sub-sampling). What cv2 refuses raises
//   saying so.
// Code-blocks of the high-throughput coder (Part 15) are not ported.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

#include "host.h"
#include "j2k_tables.h"

namespace sdt {

namespace {

using namespace j2k;

struct Fail {
  int status;
  std::string msg;
};

[[noreturn]] void damaged(const std::string& m) {
  throw Fail{kCorrupt, "JPEG 2000: " + m};
}

[[noreturn]] void refused(const std::string& m) {
  throw Fail{kUnsupported, "JPEG 2000: " + m + " (cv2 refuses it too)"};
}

[[noreturn]] void not_ported(const std::string& m) {
  throw Fail{kUnsupported,
             "JPEG 2000 (cv2 reads it): " + m + ": not ported"};
}

uint32_t be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }
uint32_t be32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) |
         p[3];
}

int ceildiv(int64_t a, int64_t b) {
  return static_cast<int>((a + b - 1) / b);
}
int64_t ceildivpow2(int64_t a, int b) {
  return (a + (int64_t{1} << b) - 1) >> b;
}
int64_t floordivpow2(int64_t a, int b) { return a >> b; }

// ------------------------------------------------------------ parameters

struct Comp {
  int prec = 8;
  bool sgnd = false;
  int dx = 1, dy = 1;
};

struct Step {
  int expn = 0, mant = 0;
};

struct Tccp {  // coding style of one component of one tile
  int csty = 0;
  int numres = 6;
  int cblkw = 6, cblkh = 6, cblksty = 0, qmfbid = 1;
  int prcw[33], prch[33];
  int qntsty = 0, numgbits = 2;
  Step steps[97];
  int roishift = 0;
  Tccp() {
    std::fill(prcw, prcw + 33, 15);
    std::fill(prch, prch + 33, 15);
  }
};

struct Poc {
  int resno0, compno0, layno1, resno1, compno1, prg;
};

struct Tcp {  // coding style of one tile, and its data
  int csty = 0, prg = 0, numlayers = 1, mct = 0;
  std::vector<Tccp> tccps;
  std::vector<char> coc, qcc;  // set by a COC / QCC of this header
  std::vector<Poc> pocs;
  std::map<int, std::vector<uint8_t>> ppt;  // by Zppt
  std::vector<uint8_t> data;
  bool seen = false, done = false;
  int nparts = 0;
};

constexpr int kMaxRes = 33;

struct Codestream {
  int64_t x0, y0, x1, y1, tdx, tdy, tx0, ty0;
  int tw, th;
  std::vector<Comp> comps;
  Tcp def;
  std::vector<Tcp> tiles;
  std::map<int, std::vector<uint8_t>> ppm_parts;  // by Zppm
  std::vector<uint8_t> ppm;  // the packet headers, Nppm fields stripped
  size_t ppm_pos = 0;
  std::vector<int> order;  // tiles in the order OpenJPEG decodes them
};

// -------------------------------------------------------- marker segments

void read_spcod(const uint8_t* p, long n, Tccp* t, bool precincts) {
  if (n < 5) damaged("COD / COC segment too short");
  t->numres = p[0] + 1;
  if (t->numres > kMaxRes) damaged("more than 32 decomposition levels");
  t->cblkw = p[1] + 2;
  t->cblkh = p[2] + 2;
  if (t->cblkw > 10 || t->cblkh > 10 || t->cblkw + t->cblkh > 12)
    damaged("code-block size out of range");
  t->cblksty = p[3];
  t->qmfbid = p[4];
  if (t->qmfbid > 1) damaged("unknown wavelet");
  if (precincts) {
    if (n < 5 + t->numres) damaged("COD / COC segment too short");
    for (int r = 0; r < t->numres; ++r) {
      t->prcw[r] = p[5 + r] & 15;
      t->prch[r] = p[5 + r] >> 4;
      if (r && (!t->prcw[r] || !t->prch[r]))
        damaged("invalid precinct size");
    }
  } else {
    std::fill(t->prcw, t->prcw + kMaxRes, 15);
    std::fill(t->prch, t->prch + kMaxRes, 15);
  }
}

void read_sqcd(const uint8_t* p, long n, Tccp* t) {
  if (n < 1) damaged("QCD / QCC segment too short");
  t->qntsty = p[0] & 31;
  t->numgbits = p[0] >> 5;
  if (t->qntsty > 2) damaged("unknown quantisation style");
  long nb = t->qntsty == 0 ? n - 1 : t->qntsty == 2 ? (n - 1) / 2 : 1;
  if (t->qntsty == 1 && n < 3) damaged("QCD / QCC segment too short");
  nb = std::min<long>(nb, 97);
  for (long b = 0; b < nb; ++b) {
    if (t->qntsty == 0) {
      t->steps[b].expn = p[1 + b] >> 3;
      t->steps[b].mant = 0;
    } else {
      const uint32_t v = be16(p + 1 + 2 * b);
      t->steps[b].expn = v >> 11;
      t->steps[b].mant = v & 0x7FF;
    }
  }
  if (t->qntsty == 1)
    for (int b = 1; b < 97; ++b) {
      t->steps[b].expn = std::max(t->steps[0].expn - (b - 1) / 3, 0);
      t->steps[b].mant = t->steps[0].mant;
    }
}

// A marker segment of the main header (main) or of a tile-part header,
// into tcp (a POC adds to those before it, as OpenJPEG reads them)
void read_segment(Codestream* cs, Tcp* tcp, int marker, const uint8_t* p,
                  long n, bool main) {
  const int nc = static_cast<int>(cs->comps.size());
  const int csz = nc < 257 ? 1 : 2;
  auto comp_index = [&](const uint8_t* q) {
    const int c = csz == 1 ? q[0] : static_cast<int>(be16(q));
    if (c >= nc) damaged("component index out of range");
    return c;
  };
  switch (marker) {
    case 0xFF52: {  // COD
      if (n < 5) damaged("COD segment too short");
      tcp->csty = p[0];
      tcp->prg = p[1];
      if (tcp->prg > 4) damaged("unknown progression order");
      tcp->numlayers = static_cast<int>(be16(p + 2));
      if (!tcp->numlayers) damaged("no layers");
      tcp->mct = p[4];
      if (tcp->mct > 1) damaged("multiple component transform other than "
                                "the RCT / ICT");
      Tccp t;
      read_spcod(p + 5, n - 5, &t, tcp->csty & 1);
      for (int c = 0; c < nc; ++c) {
        if (tcp->coc[c]) continue;  // a COC of this header wins
        Tccp& d = tcp->tccps[c];
        d.csty = tcp->csty & 1;
        d.numres = t.numres;
        d.cblkw = t.cblkw;
        d.cblkh = t.cblkh;
        d.cblksty = t.cblksty;
        d.qmfbid = t.qmfbid;
        std::copy(t.prcw, t.prcw + kMaxRes, d.prcw);
        std::copy(t.prch, t.prch + kMaxRes, d.prch);
      }
      return;
    }
    case 0xFF53: {  // COC
      if (n < csz + 1) damaged("COC segment too short");
      const int c = comp_index(p);
      Tccp& d = tcp->tccps[c];
      d.csty = p[csz] & 1;
      read_spcod(p + csz + 1, n - csz - 1, &d, p[csz] & 1);
      tcp->coc[c] = 1;
      return;
    }
    case 0xFF5C: {  // QCD
      Tccp t;
      read_sqcd(p, n, &t);
      for (int c = 0; c < nc; ++c) {
        if (tcp->qcc[c]) continue;
        Tccp& d = tcp->tccps[c];
        d.qntsty = t.qntsty;
        d.numgbits = t.numgbits;
        std::copy(t.steps, t.steps + 97, d.steps);
      }
      return;
    }
    case 0xFF5D: {  // QCC
      if (n < csz) damaged("QCC segment too short");
      const int c = comp_index(p);
      read_sqcd(p + csz, n - csz, &tcp->tccps[c]);
      tcp->qcc[c] = 1;
      return;
    }
    case 0xFF5E: {  // RGN
      if (n < csz + 2) damaged("RGN segment too short");
      const int c = comp_index(p);
      if (p[csz] != 0) damaged("RGN of a style other than max-shift");
      tcp->tccps[c].roishift = p[csz + 1];
      return;
    }
    case 0xFF5F: {  // POC
      const int sz = 5 + 2 * csz;
      if (n < sz || n % sz) damaged("POC segment of a bad length");
      for (long i = 0; i < n; i += sz) {
        const uint8_t* q = p + i;
        Poc pc;
        pc.resno0 = q[0];
        pc.compno0 = csz == 1 ? q[1] : static_cast<int>(be16(q + 1));
        pc.layno1 = static_cast<int>(be16(q + 1 + csz));
        pc.resno1 = q[3 + csz];
        pc.compno1 =
            csz == 1 ? q[4 + csz] : static_cast<int>(be16(q + 4 + csz));
        pc.compno1 = std::min(pc.compno1, nc);
        pc.prg = q[sz - 1];
        if (pc.prg > 4) damaged("unknown progression order in POC");
        tcp->pocs.push_back(pc);
      }
      return;
    }
    case 0xFF60:  // PPM, merged in Zppm order
      if (!main) damaged("PPM in a tile-part header");
      if (n < 1) damaged("PPM segment too short");
      if (!cs->ppm_parts.emplace(p[0], std::vector<uint8_t>(p + 1, p + n))
               .second)
        damaged("two PPM segments of one index");
      return;
    case 0xFF61:  // PPT, merged in Zppt order
      if (main) damaged("PPT in the main header");
      if (n < 1) damaged("PPT segment too short");
      if (!cs->ppm_parts.empty()) damaged("PPT beside PPM");
      if (!tcp->ppt.emplace(p[0], std::vector<uint8_t>(p + 1, p + n))
               .second)
        damaged("two PPT segments of one index in a tile");
      return;
    case 0xFF55: case 0xFF57: case 0xFF58: case 0xFF63: case 0xFF64:
      return;  // TLM, PLM, PLT, CRG, COM
    default:
      if ((marker >> 8) != 0xFF || marker < 0xFF30)
        damaged("not a marker where one was expected");
      return;  // an unknown marker segment, walked past
  }
}

// The codestream's headers, and every tile-part's data gathered by tile
void parse_codestream(const uint8_t* d, long n, Codestream* cs) {
  if (n < 4 || be16(d) != 0xFF4F || be16(d + 2) != 0xFF51)
    damaged("no SOC and SIZ at the start of the codestream");
  long pos = 4;
  auto need = [&](long k) {
    if (pos + k > n) damaged("truncated in its headers");
  };
  need(2);
  const long lsiz = be16(d + pos);
  need(lsiz);
  if (lsiz < 41) damaged("SIZ segment too short");
  const uint8_t* s = d + pos + 2;
  cs->x1 = be32(s + 2);
  cs->y1 = be32(s + 6);
  cs->x0 = be32(s + 10);
  cs->y0 = be32(s + 14);
  cs->tdx = be32(s + 18);
  cs->tdy = be32(s + 22);
  cs->tx0 = be32(s + 26);
  cs->ty0 = be32(s + 30);
  const int nc = static_cast<int>(be16(s + 34));
  if (!nc || nc > 16384 || lsiz != 38 + 3 * nc)
    damaged("SIZ segment of a bad length");
  if (cs->x0 >= cs->x1 || cs->y0 >= cs->y1 || !cs->tdx || !cs->tdy ||
      cs->tx0 > cs->x0 || cs->ty0 > cs->y0 || cs->tx0 + cs->tdx <= cs->x0 ||
      cs->ty0 + cs->tdy <= cs->y0)
    damaged("bad image or tile size in SIZ");
  for (int c = 0; c < nc; ++c) {
    Comp k;
    k.prec = (s[36 + 3 * c] & 0x7F) + 1;
    k.sgnd = s[36 + 3 * c] >> 7;
    k.dx = s[37 + 3 * c];
    k.dy = s[38 + 3 * c];
    if (!k.dx || !k.dy) damaged("component sub-sampling of 0");
    if (k.prec > 38) damaged("component precision above 38 bits");
    cs->comps.push_back(k);
  }
  cs->tw = ceildiv(cs->x1 - cs->tx0, cs->tdx);
  cs->th = ceildiv(cs->y1 - cs->ty0, cs->tdy);
  if (static_cast<int64_t>(cs->tw) * cs->th > 65535)
    damaged("more than 65535 tiles");
  pos += lsiz;
  cs->def.tccps.assign(nc, Tccp());
  cs->def.coc.assign(nc, 0);
  cs->def.qcc.assign(nc, 0);
  bool cod = false, qcd = false;
  // main header
  for (;;) {
    need(2);
    const int m = static_cast<int>(be16(d + pos));
    if (m == 0xFF90) break;  // SOT
    if (m == 0xFFD9) damaged("EOC before any tile-part");
    need(4);
    const long len = be16(d + pos + 2);
    if (len < 2) damaged("marker segment of a bad length");
    pos += 2;
    need(len);
    read_segment(cs, &cs->def, m, d + pos + 2, len - 2, true);
    cod |= m == 0xFF52;
    qcd |= m == 0xFF5C;
    pos += len;
  }
  if (!cod || !qcd) damaged("no COD or QCD in the main header");
  // a tile header starts from the main header's, its own COD and QCD
  // overriding the main header's COC and QCC too
  std::fill(cs->def.coc.begin(), cs->def.coc.end(), 0);
  std::fill(cs->def.qcc.begin(), cs->def.qcc.end(), 0);
  cs->tiles.assign(static_cast<size_t>(cs->tw) * cs->th, Tcp());
  // tile-parts
  for (;;) {
    if (pos + 2 > n)  // OpenJPEG reads a marker after every tile-part
      damaged("truncated: the stream ends before its EOC marker");
    const int m = static_cast<int>(be16(d + pos));
    if (m == 0xFFD9) break;  // EOC
    if (m != 0xFF90) damaged("no SOT where a tile-part was expected");
    const long sot = pos;
    need(12);
    if (be16(d + pos + 2) != 10) damaged("SOT segment of a bad length");
    const int isot = static_cast<int>(be16(d + pos + 4));
    const uint32_t psot = be32(d + pos + 6);
    const int tpsot = d[pos + 10], tnsot = d[pos + 11];
    if (isot >= static_cast<int>(cs->tiles.size()))
      damaged("tile index out of range");
    Tcp& tcp = cs->tiles[isot];
    if (tcp.done) damaged("a tile-part after the tile's last");
    if (tnsot) {
      if (tcp.nparts && tpsot >= tcp.nparts)
        damaged("tile-part index past the tile's count");
      if (tpsot >= tnsot) damaged("tile-part index past its count");
      tcp.nparts = tnsot;
    }
    if (!tcp.seen) {
      tcp.csty = cs->def.csty;
      tcp.prg = cs->def.prg;
      tcp.numlayers = cs->def.numlayers;
      tcp.mct = cs->def.mct;
      tcp.tccps = cs->def.tccps;
      tcp.coc = cs->def.coc;
      tcp.qcc = cs->def.qcc;
      tcp.pocs = cs->def.pocs;
      tcp.seen = true;
    }
    pos += 12;
    for (;;) {  // tile-part header
      need(2);
      const int mk = static_cast<int>(be16(d + pos));
      if (mk == 0xFF93) break;  // SOD
      need(4);
      const long len = be16(d + pos + 2);
      if (len < 2) damaged("marker segment of a bad length");
      pos += 2;
      need(len);
      if (mk == 0xFF52)  // a tile's COD overrides the main header's COC
        for (int c = 0; c < nc; ++c) tcp.coc[c] = 0;
      if (mk == 0xFF5C)
        for (int c = 0; c < nc; ++c) tcp.qcc[c] = 0;
      read_segment(cs, &tcp, mk, d + pos + 2, len - 2, false);
      pos += len;
    }
    pos += 2;  // SOD
    long len;
    if (psot == 0) {  // the last tile-part: to the end, less EOC
      len = n - pos - 2;
      if (len < 0) len = n - pos;
    } else {
      len = static_cast<long>(psot) - (pos - sot);
      if (len < 0) damaged("tile-part length shorter than its header");
      if (pos + len > n)
        damaged("truncated: tile-part length runs past the end of the data");
    }
    tcp.data.insert(tcp.data.end(), d + pos, d + pos + len);
    pos += len;
    if (psot == 0 || (tcp.nparts && tpsot + 1 == tcp.nparts)) {
      tcp.done = true;
      cs->order.push_back(isot);
      if (psot == 0) break;
    }
  }
  for (size_t t = 0; t < cs->tiles.size(); ++t)
    if (cs->tiles[t].seen && !cs->tiles[t].done) {
      cs->tiles[t].done = true;
      cs->order.push_back(static_cast<int>(t));
    }
  for (size_t t = 0; t < cs->tiles.size(); ++t)
    if (!cs->tiles[t].seen) damaged("tile " + std::to_string(t) +
                                    " has no data");
  if (!cs->ppm_parts.empty()) {  // strip the Nppm fields
    std::vector<uint8_t> raw;
    for (const auto& part : cs->ppm_parts)
      raw.insert(raw.end(), part.second.begin(), part.second.end());
    for (size_t q = 0; q < raw.size();) {
      if (q + 4 > raw.size()) damaged("PPM data truncated");
      const size_t k = be32(raw.data() + q);
      q += 4;
      if (q + k > raw.size()) damaged("PPM data truncated");
      cs->ppm.insert(cs->ppm.end(), raw.begin() + q, raw.begin() + q + k);
      q += k;
    }
  }
}

// ------------------------------------------------------------ tier-2

struct Bio {  // opj_bio: packet header bits, a stuffed bit after 0xFF
  const uint8_t* bp;
  const uint8_t* start;
  const uint8_t* end;
  uint32_t buf = 0;
  int ct = 0;
  Bio(const uint8_t* s, const uint8_t* e) : bp(s), start(s), end(e) {}
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
  long numbytes() const { return bp - start; }
};

struct TagTree {
  std::vector<int> value, low, parent;
  void init(int w, int h) {
    std::vector<int> lw{w}, lh{h};
    int total = 0;
    for (;;) {
      const int k = lw.back() * lh.back();
      total += k;
      if (k <= 1) break;
      lw.push_back((lw.back() + 1) / 2);
      lh.push_back((lh.back() + 1) / 2);
    }
    parent.assign(total, -1);
    int base = 0;
    for (size_t l = 0; l + 1 < lw.size(); ++l) {
      const int next = base + lw[l] * lh[l];
      for (int j = 0; j < lh[l]; ++j)
        for (int i = 0; i < lw[l]; ++i)
          parent[base + j * lw[l] + i] = next + (j / 2) * lw[l + 1] + i / 2;
      base = next;
    }
    reset();
  }
  void reset() {
    value.assign(parent.size(), 999);
    low.assign(parent.size(), 0);
  }
  bool decode(Bio* bio, int leaf, int threshold) {
    int stk[64], sp = 0, node = leaf;
    while (parent[node] >= 0) {
      stk[sp++] = node;
      node = parent[node];
    }
    int lo = 0;
    for (;;) {
      if (lo > low[node]) low[node] = lo;
      else lo = low[node];
      while (lo < threshold && lo < value[node]) {
        if (bio->bit()) value[node] = lo;
        else ++lo;
      }
      low[node] = lo;
      if (!sp) break;
      node = stk[--sp];
    }
    return value[node] < threshold;
  }
};

struct Seg {
  int len = 0, numpasses = 0, maxpasses = 0, newlen = 0, numnewpasses = 0;
};

struct Cblk {
  int x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0, numnewpasses = 0;
  bool included = false;
  std::vector<Seg> segs;
  std::vector<uint8_t> data;
};

struct Precinct {
  int cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int bandno;
  int64_t x0, y0, x1, y1;
  float stepsize;
  int numbps;
  std::vector<Precinct> precs;
  bool empty() const { return x1 <= x0 || y1 <= y0; }
};

struct Res {
  int64_t x0, y0, x1, y1;
  int pw = 0, ph = 0, pdx, pdy, nbands;
  Band bands[3];
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  std::vector<Res> res;
  std::vector<int32_t> idata;
  std::vector<float> fdata;
  int w() const { return static_cast<int>(x1 - x0); }
  int h() const { return static_cast<int>(y1 - y0); }
};

void init_seg(Cblk* cb, int cblksty, bool first) {
  Seg s;
  if (cblksty & 4) {  // TERMALL
    s.maxpasses = 1;
  } else if (cblksty & 1) {  // BYPASS
    if (first) {
      s.maxpasses = 10;
    } else {
      const int prev = cb->segs.back().maxpasses;
      s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
    }
  } else {
    s.maxpasses = 109;
  }
  cb->segs.push_back(s);
}

int numpasses(Bio* bio) {
  if (!bio->bit()) return 1;
  if (!bio->bit()) return 2;
  uint32_t n = bio->read(2);
  if (n != 3) return 3 + n;
  n = bio->read(5);
  if (n != 31) return 6 + n;
  return 37 + bio->read(7);
}

int floorlog2(int v) {
  int l = 0;
  while (v > 1) {
    v >>= 1;
    ++l;
  }
  return l;
}

// One packet: its header from hdr (the tile's data, or the PPM / PPT
// headers), its body from body. Both cursors advance.
void read_packet(TileComp* tc, const Tccp& tccp, const Tcp& tcp, int resno,
                 int precno, int layno, const uint8_t** hdr,
                 const uint8_t* hdr_end, const uint8_t** body,
                 const uint8_t* body_end, bool separate) {
  Res& res = tc->res[resno];
  if (layno == 0)
    for (int b = 0; b < res.nbands; ++b) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      Precinct& prc = band.precs[precno];
      prc.incl.reset();
      prc.imsb.reset();
      for (Cblk& cb : prc.cblks) {
        cb.segs.clear();
        cb.included = false;
      }
    }
  if (tcp.csty & 2) {  // SOP, in the body
    if (body_end - *body >= 6 && (*body)[0] == 0xFF && (*body)[1] == 0x91)
      *body += 6;
    if (!separate) *hdr = *body;
  }
  const uint8_t* h = *hdr;
  Bio bio(h, hdr_end);
  auto eph = [&]() {
    if ((tcp.csty & 4) && hdr_end - h >= 2 && h[0] == 0xFF && h[1] == 0x92)
      h += 2;
  };
  if (!bio.bit()) {  // an empty packet
    bio.inalign();
    h += bio.numbytes();
    eph();
    *hdr = h;
    if (!separate) *body = h;
    return;
  }
  for (int b = 0; b < res.nbands; ++b) {
    Band& band = res.bands[b];
    if (band.empty()) continue;
    Precinct& prc = band.precs[precno];
    for (int k = 0; k < prc.cw * prc.ch; ++k) {
      Cblk& cb = prc.cblks[k];
      bool included;
      if (!cb.included)
        included = prc.incl.decode(&bio, k, layno + 1);
      else
        included = bio.bit();
      if (!included) {
        cb.numnewpasses = 0;
        continue;
      }
      if (!cb.included) {
        int i = 0;
        while (!prc.imsb.decode(&bio, k, i)) {
          if (++i > 74) damaged("bad zero bit-plane tag tree");
        }
        cb.numbps = band.numbps + 1 - i;
        cb.numlenbits = 3;
      }
      cb.numnewpasses = numpasses(&bio);
      int inc = 0;
      while (bio.bit()) {
        if (++inc > 32) damaged("bad Lblock increment");
      }
      cb.numlenbits += inc;
      int segno;
      if (cb.segs.empty()) {
        init_seg(&cb, tccp.cblksty, true);
        segno = 0;
      } else {
        segno = static_cast<int>(cb.segs.size()) - 1;
        if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
          init_seg(&cb, tccp.cblksty, false);
          ++segno;
        }
      }
      int nnew = cb.numnewpasses;
      for (;;) {
        Seg& sg = cb.segs[segno];
        sg.numnewpasses = std::min(sg.maxpasses - sg.numpasses, nnew);
        const int bits = cb.numlenbits + floorlog2(sg.numnewpasses);
        if (bits > 32) damaged("segment length of more than 32 bits");
        const uint32_t len = bio.read(bits);
        if (len > (1u << 30)) damaged("a segment length of more than 1 GiB");
        sg.newlen = static_cast<int>(len);
        nnew -= sg.numnewpasses;
        if (nnew <= 0) break;
        init_seg(&cb, tccp.cblksty, false);
        ++segno;
      }
      cb.included = true;
    }
  }
  bio.inalign();
  h += bio.numbytes();
  eph();
  *hdr = h;
  const uint8_t* q = separate ? *body : h;
  for (int b = 0; b < res.nbands; ++b) {
    Band& band = res.bands[b];
    if (band.empty()) continue;
    Precinct& prc = band.precs[precno];
    for (Cblk& cb : prc.cblks) {
      if (!cb.numnewpasses) continue;
      size_t s = 0;
      while (s < cb.segs.size() && cb.segs[s].numnewpasses == 0) ++s;
      for (; s < cb.segs.size() && cb.numnewpasses > 0; ++s) {
        Seg& sg = cb.segs[s];
        if (sg.newlen > body_end - q)
          damaged("truncated: a code-block's data runs past its tile");
        cb.data.insert(cb.data.end(), q, q + sg.newlen);
        q += sg.newlen;
        sg.len += sg.newlen;
        sg.numpasses += sg.numnewpasses;
        cb.numnewpasses -= sg.numnewpasses;
        sg.numnewpasses = 0;
        sg.newlen = 0;
      }
    }
  }
  *body = q;
  if (!separate) *hdr = q;
}

// ------------------------------------------------------------ tier-1


struct Mq {  // the MQ decoder (C.3), and the raw decoder of BYPASS passes
  const uint8_t* bp;
  uint32_t a, c;
  int ct;
  uint8_t state[19], mps[19];
  void reset_states() {
    std::memset(state, 0, sizeof(state));
    std::memset(mps, 0, sizeof(mps));
    state[kCtxUni] = 46;
    state[kCtxAgg] = 3;
    state[kCtxZc] = 4;
  }
  // data is followed by two 0xFF bytes
  void init(const uint8_t* data, int len) {
    bp = data;
    c = len == 0 ? 0xFFu << 16 : static_cast<uint32_t>(*bp) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void bytein() {
    if (*bp == 0xFF) {
      if (bp[1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += static_cast<uint32_t>(*bp) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += static_cast<uint32_t>(*bp) << 8;
      ct = 8;
    }
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    const MqState& s = kMq[state[cx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {  // LPS exchange
      if (a < s.qe) {
        a = s.qe;
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        a = s.qe;
        d = !mps[cx];
        if (s.sw) mps[cx] = !mps[cx];
        state[cx] = s.nlps;
      }
      renorm();
    } else {
      c -= static_cast<uint32_t>(s.qe) << 16;
      if ((a & 0x8000) == 0) {  // MPS exchange
        if (a < s.qe) {
          d = !mps[cx];
          if (s.sw) mps[cx] = !mps[cx];
          state[cx] = s.nlps;
        } else {
          d = mps[cx];
          state[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  void raw_init(const uint8_t* data) {
    bp = data;
    c = 0;
    ct = 0;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (*bp > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = *bp++;
          ct = 7;
        }
      } else {
        c = *bp++;
        ct = 8;
      }
    }
    --ct;
    return (c >> ct) & 1;
  }
};


struct T1 {
  int w, h, stride, orient;
  bool vsc;
  std::vector<uint32_t> st;  // (h + 2) x (w + 2), a border of zeros
  std::vector<int32_t> data;
  Mq mq;

  uint32_t* at(int x, int y) { return &st[(y + 1) * stride + x + 1]; }
  // the sample's flags as its contexts see them (VSC applied)
  uint32_t seen(const uint32_t* f, int y) const {
    return (vsc && (y & 3) == 3) ? (*f & ~kBelow) : *f;
  }
  int zc(uint32_t f) const { return kLuts.zc[orient][(f >> 4) & 0xFF]; }
  static int sc_index(uint32_t f) {
    return ((f >> 4) & 0xF) | (((f >> 12) & 0xF) << 4);
  }
  void set_sig(int x, int y, int neg, int oneplushalf) {
    uint32_t* f = at(x, y);
    *f |= kSig | (neg ? kNeg : 0);
    f[-1] |= kE | (neg ? kENeg : 0);
    f[1] |= kW | (neg ? kWNeg : 0);
    f[-stride] |= kS | (neg ? kSNeg : 0);
    f[stride] |= kN | (neg ? kNNeg : 0);
    f[-stride - 1] |= kSE;
    f[-stride + 1] |= kSW;
    f[stride - 1] |= kNE;
    f[stride + 1] |= kNW;
    data[y * w + x] = neg ? -oneplushalf : oneplushalf;
  }
  void decode_sign(int x, int y, uint32_t f, int oneplushalf) {
    const int k = sc_index(f);
    set_sig(x, y, mq.decode(kLuts.sc[k]) ^ kLuts.xr[k], oneplushalf);
  }

  void sigpass(int bpno, bool raw) {
    const int one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < std::min(y0 + 4, h); ++y) {
          uint32_t* f = at(x, y);
          const uint32_t s = seen(f, y);
          if ((s & (kSig | kVisited)) || !(s & kNeighbours)) continue;
          if (raw) {
            if (mq.raw()) set_sig(x, y, mq.raw(), oneplushalf);
          } else if (mq.decode(zc(s))) {
            decode_sign(x, y, s, oneplushalf);
          }
          *f |= kVisited;
        }
  }

  void refpass(int bpno, bool raw) {
    const int poshalf = (1 << bpno) >> 1;
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < std::min(y0 + 4, h); ++y) {
          uint32_t* f = at(x, y);
          if ((*f & (kSig | kVisited)) != kSig) continue;
          int v;
          if (raw) {
            v = mq.raw();
          } else {
            const uint32_t s = seen(f, y);
            v = mq.decode((s & kRefined) ? kCtxMag + 2
                          : (s & kNeighbours) ? kCtxMag + 1 : kCtxMag);
          }
          int32_t& dv = data[y * w + x];
          dv += (v ^ (dv < 0)) ? poshalf : -poshalf;
          *f |= kRefined;
        }
  }

  void clnpass(int bpno, bool segsym) {
    const int one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        const int rows = std::min(4, h - y0);
        int i = 0;
        bool partial = false;
        if (rows == 4) {
          bool run = true;
          for (int k = 0; k < 4 && run; ++k) {
            const uint32_t s = seen(at(x, y0 + k), y0 + k);
            run = !(s & (kSig | kVisited | kNeighbours));
          }
          if (run) {
            if (!mq.decode(kCtxAgg)) continue;
            i = mq.decode(kCtxUni) << 1;
            i |= mq.decode(kCtxUni);
            partial = true;
          }
        }
        for (; i < rows; ++i) {
          const int y = y0 + i;
          const uint32_t s = seen(at(x, y), y);
          if (!partial) {
            if (s & (kSig | kVisited)) continue;
            if (!mq.decode(zc(s))) continue;
          }
          partial = false;
          decode_sign(x, y, s, oneplushalf);
        }
        for (int k = 0; k < rows; ++k) *at(x, y0 + k) &= ~kVisited;
      }
    if (segsym) {
      int v = mq.decode(kCtxUni);
      for (int k = 0; k < 3; ++k) v = (v << 1) | mq.decode(kCtxUni);
      (void)v;  // OpenJPEG only warns of a bad symbol
    }
  }
};

// opj_t1_decode_cblk, then the ROI shift: the coefficients at twice
// their magnitude into out (w x h)
void decode_cblk(const Cblk& cb, int orient, int roishift, int cblksty,
                 T1* t1) {
  const int w = cb.x1 - cb.x0, h = cb.y1 - cb.y0;
  t1->w = w;
  t1->h = h;
  t1->stride = w + 2;
  t1->orient = orient;
  t1->vsc = cblksty & 8;
  t1->st.assign(static_cast<size_t>(h + 2) * (w + 2), 0);
  t1->data.assign(static_cast<size_t>(w) * h, 0);
  Mq& mq = t1->mq;
  mq.reset_states();
  int bpno_plus_one = roishift + cb.numbps;
  if (bpno_plus_one >= 31) damaged("too many bit-planes in a code-block");
  int passtype = 2;
  std::vector<uint8_t> buf;
  size_t at = 0;
  for (const Seg& sg : cb.segs) {
    if (!sg.numpasses && !sg.len) continue;
    const bool raw = (bpno_plus_one <= cb.numbps - 4) && passtype < 2 &&
                     (cblksty & 1);
    buf.assign(cb.data.begin() + at, cb.data.begin() + at + sg.len);
    buf.push_back(0xFF);
    buf.push_back(0xFF);
    at += sg.len;
    if (raw) mq.raw_init(buf.data());
    else mq.init(buf.data(), sg.len);
    for (int p = 0; p < sg.numpasses && bpno_plus_one >= 1; ++p) {
      if (passtype == 0) t1->sigpass(bpno_plus_one, raw);
      else if (passtype == 1) t1->refpass(bpno_plus_one, raw);
      else t1->clnpass(bpno_plus_one, cblksty & 32);
      if ((cblksty & 2) && !raw) {  // RESET
        mq.reset_states();
      }
      if (++passtype == 3) {
        passtype = 0;
        --bpno_plus_one;
      }
    }
  }
  if (roishift) {
    if (roishift >= 31) {
      std::fill(t1->data.begin(), t1->data.end(), 0);
    } else {
      const int32_t thresh = int32_t{1} << roishift;
      for (int32_t& v : t1->data) {
        int32_t mag = std::abs(v);
        if (mag >= thresh) {
          mag >>= roishift;
          v = v < 0 ? -mag : mag;
        }
      }
    }
  }
}

// ------------------------------------------------------------ wavelets

// the inverse 5/3 of one line in place: sn low and dn high samples stored
// low first, cas the parity of the first coordinate
void idwt53(int32_t* x, int sn, int dn, int cas, int32_t* tmp, int step) {
  const int len = sn + dn;
  if (len == 1) {
    if (cas) x[0] /= 2;
    return;
  }
  auto L = [&](int k) { return x[static_cast<long>(k) * step]; };
  auto H = [&](int k) { return x[static_cast<long>(sn + k) * step]; };
  // interleave: position p is low when (p + cas) is even
  for (int p = 0; p < len; ++p)
    tmp[p] = ((p + cas) & 1) ? H((p - (1 - cas)) / 2) : L((p - cas) / 2);
  auto at = [&](int p) {
    if (p < 0) p = -p;
    if (p >= len) p = 2 * (len - 1) - p;
    return tmp[p];
  };
  for (int p = cas; p < len; p += 2)  // the low samples
    tmp[p] -= (at(p - 1) + at(p + 1) + 2) >> 2;
  for (int p = 1 - cas; p < len; p += 2)  // the high samples
    tmp[p] += (at(p - 1) + at(p + 1)) >> 1;
  for (int p = 0; p < len; ++p) x[static_cast<long>(p) * step] = tmp[p];
}

const float kK = 1.230174105f, kTwoInvK = 1.625732422f;
const float kDelta = -0.443506852f, kGamma = -0.882911075f,
            kBeta = 0.052980118f, kAlpha = 1.586134342f;

// opj_v8dwt_decode_step2 on one line: l the first left neighbour, w one
// past the first sample updated
void step2(float* l, float* w, int end, int m, float c) {
  const int imax = std::min(end, m);
  float tmp1 = l[0];
  for (int i = 0; i < imax; ++i) {
    const float tmp2 = w[-1], tmp3 = w[0];
    w[-1] = tmp2 + ((tmp1 + tmp3) * c);
    tmp1 = tmp3;
    w += 2;
  }
  if (m < end) {
    const float c2 = c + c;
    w[-1] = w[-1] + (c2 * w[-2]);
  }
}

void idwt97(float* x, int sn, int dn, int cas, float* wv, int step) {
  const int len = sn + dn;
  int a, b;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
    a = 0;
    b = 1;
  } else {
    if (!(sn > 0 || dn > 1)) return;
    a = 1;
    b = 0;
  }
  for (int k = 0; k < sn; ++k) wv[cas + 2 * k] = x[static_cast<long>(k) * step];
  for (int k = 0; k < dn; ++k)
    wv[1 - cas + 2 * k] = x[static_cast<long>(sn + k) * step];
  wv[len] = wv[len + 1] = 0;
  for (int k = 0; k < sn; ++k) wv[a + 2 * k] = wv[a + 2 * k] * kK;
  for (int k = 0; k < dn; ++k) wv[b + 2 * k] = wv[b + 2 * k] * kTwoInvK;
  step2(wv + b, wv + a + 1, sn, std::min(sn, dn - a), kDelta);
  step2(wv + a, wv + b + 1, dn, std::min(dn, sn - b), kGamma);
  step2(wv + b, wv + a + 1, sn, std::min(sn, dn - a), kBeta);
  step2(wv + a, wv + b + 1, dn, std::min(dn, sn - b), kAlpha);
  for (int p = 0; p < len; ++p) x[static_cast<long>(p) * step] = wv[p];
}

// -------------------------------------------------------------- tiles

void init_tile(const Codestream& cs, const Tcp& tcp, int tileno,
               std::vector<TileComp>* tcs) {
  const int p = tileno % cs.tw, q = tileno / cs.tw;
  const int64_t tx0 = std::max(cs.tx0 + p * cs.tdx, cs.x0);
  const int64_t ty0 = std::max(cs.ty0 + q * cs.tdy, cs.y0);
  const int64_t tx1 = std::min(cs.tx0 + (p + 1) * cs.tdx, cs.x1);
  const int64_t ty1 = std::min(cs.ty0 + (q + 1) * cs.tdy, cs.y1);
  tcs->assign(cs.comps.size(), TileComp());
  for (size_t c = 0; c < cs.comps.size(); ++c) {
    const Comp& comp = cs.comps[c];
    const Tccp& tccp = tcp.tccps[c];
    TileComp& tc = (*tcs)[c];
    tc.x0 = ceildiv(tx0, comp.dx);
    tc.y0 = ceildiv(ty0, comp.dy);
    tc.x1 = ceildiv(tx1, comp.dx);
    tc.y1 = ceildiv(ty1, comp.dy);
    tc.res.resize(tccp.numres);
    int stepno = 0;
    for (int r = 0; r < tccp.numres; ++r) {
      Res& res = tc.res[r];
      const int level = tccp.numres - 1 - r;
      res.x0 = ceildivpow2(tc.x0, level);
      res.y0 = ceildivpow2(tc.y0, level);
      res.x1 = ceildivpow2(tc.x1, level);
      res.y1 = ceildivpow2(tc.y1, level);
      res.pdx = tccp.prcw[r];
      res.pdy = tccp.prch[r];
      const int64_t px0 = floordivpow2(res.x0, res.pdx) << res.pdx;
      const int64_t py0 = floordivpow2(res.y0, res.pdy) << res.pdy;
      const int64_t px1 = ceildivpow2(res.x1, res.pdx) << res.pdx;
      const int64_t py1 = ceildivpow2(res.y1, res.pdy) << res.pdy;
      res.pw = res.x0 == res.x1 ? 0 : static_cast<int>((px1 - px0) >> res.pdx);
      res.ph = res.y0 == res.y1 ? 0 : static_cast<int>((py1 - py0) >> res.pdy);
      if (static_cast<int64_t>(res.pw) * res.ph > (1 << 24))
        damaged("too many precincts");
      int64_t cbgx0, cbgy0;
      int cbgw, cbgh;
      if (r == 0) {
        cbgx0 = px0;
        cbgy0 = py0;
        cbgw = res.pdx;
        cbgh = res.pdy;
        res.nbands = 1;
      } else {
        cbgx0 = ceildivpow2(px0, 1);
        cbgy0 = ceildivpow2(py0, 1);
        cbgw = res.pdx - 1;
        cbgh = res.pdy - 1;
        res.nbands = 3;
      }
      const int cbw = std::min(tccp.cblkw, cbgw);
      const int cbh = std::min(tccp.cblkh, cbgh);
      for (int b = 0; b < res.nbands; ++b, ++stepno) {
        Band& band = res.bands[b];
        if (r == 0) {
          band.bandno = 0;
          band.x0 = ceildivpow2(tc.x0, level);
          band.y0 = ceildivpow2(tc.y0, level);
          band.x1 = ceildivpow2(tc.x1, level);
          band.y1 = ceildivpow2(tc.y1, level);
        } else {
          band.bandno = b + 1;
          const int xob = band.bandno & 1, yob = band.bandno >> 1;
          band.x0 = ceildivpow2(tc.x0 - (int64_t{xob} << level), level + 1);
          band.y0 = ceildivpow2(tc.y0 - (int64_t{yob} << level), level + 1);
          band.x1 = ceildivpow2(tc.x1 - (int64_t{xob} << level), level + 1);
          band.y1 = ceildivpow2(tc.y1 - (int64_t{yob} << level), level + 1);
        }
        const Step& st = tccp.steps[stepno];
        const int gain = tccp.qmfbid == 0 ? 0 : band.bandno == 0 ? 0
                         : band.bandno == 3 ? 2 : 1;
        const int rb = comp.prec + gain;
        band.stepsize = static_cast<float>(
            (1.0 + st.mant / 2048.0) * std::pow(2.0, rb - st.expn));
        band.numbps = st.expn + tccp.numgbits - 1;
        band.precs.assign(static_cast<size_t>(res.pw) * res.ph, Precinct());
        for (int pn = 0; pn < res.pw * res.ph; ++pn) {
          Precinct& prc = band.precs[pn];
          const int64_t gx0 = cbgx0 + int64_t{pn % res.pw} * (1 << cbgw);
          const int64_t gy0 = cbgy0 + int64_t{pn / res.pw} * (1 << cbgh);
          const int64_t x0 = std::max(gx0, band.x0);
          const int64_t y0 = std::max(gy0, band.y0);
          const int64_t x1 = std::min(gx0 + (1 << cbgw), band.x1);
          const int64_t y1 = std::min(gy0 + (1 << cbgh), band.y1);
          const int64_t bx0 = floordivpow2(x0, cbw) << cbw;
          const int64_t by0 = floordivpow2(y0, cbh) << cbh;
          const int64_t bx1 = ceildivpow2(x1, cbw) << cbw;
          const int64_t by1 = ceildivpow2(y1, cbh) << cbh;
          prc.cw = static_cast<int>(std::max<int64_t>(0, (bx1 - bx0) >> cbw));
          prc.ch = static_cast<int>(std::max<int64_t>(0, (by1 - by0) >> cbh));
          prc.cblks.resize(static_cast<size_t>(prc.cw) * prc.ch);
          for (int k = 0; k < prc.cw * prc.ch; ++k) {
            Cblk& cb = prc.cblks[k];
            const int64_t cx = bx0 + int64_t{k % prc.cw} * (1 << cbw);
            const int64_t cy = by0 + int64_t{k / prc.cw} * (1 << cbh);
            cb.x0 = static_cast<int>(std::max(cx, x0));
            cb.y0 = static_cast<int>(std::max(cy, y0));
            cb.x1 = static_cast<int>(std::min(cx + (1 << cbw), x1));
            cb.y1 = static_cast<int>(std::min(cy + (1 << cbh), y1));
          }
          prc.incl.init(prc.cw, prc.ch);
          prc.imsb.init(prc.cw, prc.ch);
        }
      }
    }
  }
}

struct Packet {
  int layno, resno, compno, precno;
};

// pi.c's iterators: the tile's packets in the order its progression (or
// its POCs) sends them, each once
std::vector<Packet> packet_order(const Codestream& cs, const Tcp& tcp,
                                 const std::vector<TileComp>& tcs,
                                 int tileno) {
  const int nc = static_cast<int>(cs.comps.size());
  int maxres = 0, maxprec = 0;
  for (int c = 0; c < nc; ++c) {
    maxres = std::max(maxres, tcp.tccps[c].numres);
    for (const Res& r : tcs[c].res) maxprec = std::max(maxprec, r.pw * r.ph);
  }
  const int nl = tcp.numlayers;
  maxprec = std::max(maxprec, 1);
  std::vector<char> seen(static_cast<size_t>(nl) * maxres * nc * maxprec, 0);
  std::vector<Packet> out;
  auto emit = [&](int l, int r, int c, int p) {
    const size_t k =
        ((static_cast<size_t>(l) * maxres + r) * nc + c) * maxprec + p;
    if (!seen[k]) {
      seen[k] = 1;
      out.push_back({l, r, c, p});
    }
  };
  std::vector<Poc> pocs = tcp.pocs;
  if (pocs.empty()) pocs.push_back({0, 0, nl, maxres, nc, tcp.prg});
  const int p = tileno % cs.tw, q = tileno / cs.tw;
  const int64_t tx0 = std::max(cs.tx0 + p * cs.tdx, cs.x0);
  const int64_t ty0 = std::max(cs.ty0 + q * cs.tdy, cs.y0);
  const int64_t tx1 = std::min(cs.tx0 + (p + 1) * cs.tdx, cs.x1);
  const int64_t ty1 = std::min(cs.ty0 + (q + 1) * cs.tdy, cs.y1);
  for (const Poc& pc : pocs) {
    const int l1 = std::min(pc.layno1, nl);
    const int c0 = pc.compno0, c1 = pc.compno1, r0 = pc.resno0, r1 = pc.resno1;
    if (c0 >= nc || c1 > nc) damaged("POC component out of range");
    auto precincts = [&](int l, int r, int c) {
      if (r >= tcp.tccps[c].numres) return;
      const Res& res = tcs[c].res[r];
      for (int pn = 0; pn < res.pw * res.ph; ++pn) emit(l, r, c, pn);
    };
    // the position-driven orders: pi.c's steps and tests (B.12.1.3-5)
    int64_t dx = 0, dy = 0;
    for (int c = 0; c < nc; ++c)
      for (int r = 0; r < tcp.tccps[c].numres; ++r) {
        const Res& res = tcs[c].res[r];
        const int lv = tcp.tccps[c].numres - 1 - r;
        const int64_t ddx = int64_t{cs.comps[c].dx} << (res.pdx + lv);
        const int64_t ddy = int64_t{cs.comps[c].dy} << (res.pdy + lv);
        dx = dx ? std::min(dx, ddx) : ddx;
        dy = dy ? std::min(dy, ddy) : ddy;
      }
    auto at_position = [&](int64_t x, int64_t y, int r, int c,
                           int* prec) -> bool {
      if (r >= tcp.tccps[c].numres) return false;
      const Res& res = tcs[c].res[r];
      const int lv = tcp.tccps[c].numres - 1 - r;
      const int64_t cdx = int64_t{cs.comps[c].dx} << lv;
      const int64_t cdy = int64_t{cs.comps[c].dy} << lv;
      const int64_t trx0 = ceildiv(tx0, cdx), try0 = ceildiv(ty0, cdy);
      const int64_t trx1 = ceildiv(tx1, cdx), try1 = ceildiv(ty1, cdy);
      const int rpx = res.pdx + lv, rpy = res.pdy + lv;
      if (!(y % (int64_t{cs.comps[c].dy} << rpy) == 0 ||
            (y == ty0 && ((try0 << lv) % (int64_t{1} << rpy)))))
        return false;
      if (!(x % (int64_t{cs.comps[c].dx} << rpx) == 0 ||
            (x == tx0 && ((trx0 << lv) % (int64_t{1} << rpx)))))
        return false;
      if (!res.pw || !res.ph || trx0 == trx1 || try0 == try1) return false;
      const int64_t prci = floordivpow2(ceildiv(x, cdx), res.pdx) -
                           floordivpow2(trx0, res.pdx);
      const int64_t prcj = floordivpow2(ceildiv(y, cdy), res.pdy) -
                           floordivpow2(try0, res.pdy);
      *prec = static_cast<int>(prci + prcj * res.pw);
      return true;
    };
    auto ys = [&](auto body) {
      for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
        for (int64_t x = tx0; x < tx1; x += dx - (x % dx)) body(x, y);
    };
    int prec;
    switch (pc.prg) {
      case 0:  // LRCP
        for (int l = 0; l < l1; ++l)
          for (int r = r0; r < r1; ++r)
            for (int c = c0; c < c1; ++c) precincts(l, r, c);
        break;
      case 1:  // RLCP
        for (int r = r0; r < r1; ++r)
          for (int l = 0; l < l1; ++l)
            for (int c = c0; c < c1; ++c) precincts(l, r, c);
        break;
      case 2:  // RPCL
        for (int r = r0; r < r1; ++r)
          ys([&](int64_t x, int64_t y) {
            for (int c = c0; c < c1; ++c)
              if (at_position(x, y, r, c, &prec))
                for (int l = 0; l < l1; ++l) emit(l, r, c, prec);
          });
        break;
      case 3:  // PCRL
        ys([&](int64_t x, int64_t y) {
          for (int c = c0; c < c1; ++c)
            for (int r = r0; r < r1; ++r)
              if (at_position(x, y, r, c, &prec))
                for (int l = 0; l < l1; ++l) emit(l, r, c, prec);
        });
        break;
      case 4:  // CPRL
        for (int c = c0; c < c1; ++c)
          ys([&](int64_t x, int64_t y) {
            for (int r = r0; r < r1; ++r)
              if (at_position(x, y, r, c, &prec))
                for (int l = 0; l < l1; ++l) emit(l, r, c, prec);
          });
        break;
    }
  }
  return out;
}

// opj_tcd_decode_tile: tier-2, tier-1 and dequantisation, the wavelets,
// the colour transform and the DC level shift, into the image planes
void decode_tile(Codestream* cs, int tileno,
                 std::vector<std::vector<int32_t>>* planes,
                 const std::vector<int64_t>& pw,
                 const std::vector<int64_t>& px0,
                 const std::vector<int64_t>& py0) {
  Tcp& tcp = cs->tiles[tileno];
  const int nc = static_cast<int>(cs->comps.size());
  for (int c = 0; c < nc; ++c) {
    const Tccp& t = tcp.tccps[c];
    if (t.cblksty & 0x40) not_ported("high-throughput code-blocks (Part 15)");
    if (t.cblksty & 0x80) damaged("unknown code-block style");
  }
  std::vector<TileComp> tcs;
  init_tile(*cs, tcp, tileno, &tcs);
  // tier-2
  const uint8_t* body = tcp.data.data();
  const uint8_t* body_end = body + tcp.data.size();
  const uint8_t* hdr;
  const uint8_t* hdr_end;
  bool separate = true;
  std::vector<uint8_t> ppt;
  for (const auto& part : tcp.ppt)
    ppt.insert(ppt.end(), part.second.begin(), part.second.end());
  if (!cs->ppm_parts.empty()) {
    hdr = cs->ppm.data() + cs->ppm_pos;
    hdr_end = cs->ppm.data() + cs->ppm.size();
  } else if (!tcp.ppt.empty()) {
    hdr = ppt.data();
    hdr_end = hdr + ppt.size();
  } else {
    hdr = body;
    hdr_end = body_end;
    separate = false;
  }
  for (const Packet& pk : packet_order(*cs, tcp, tcs, tileno)) {
    if (!separate && body >= body_end) break;  // no data left for it
    read_packet(&tcs[pk.compno], tcp.tccps[pk.compno], tcp, pk.resno,
                pk.precno, pk.layno, &hdr, hdr_end, &body, body_end,
                separate);
  }
  if (!cs->ppm_parts.empty()) cs->ppm_pos = hdr - cs->ppm.data();
  // tier-1 and dequantisation
  T1 t1;
  for (int c = 0; c < nc; ++c) {
    TileComp& tc = tcs[c];
    const Tccp& tccp = tcp.tccps[c];
    const int w = tc.w(), h = tc.h();
    if (tccp.qmfbid == 1) tc.idata.assign(static_cast<size_t>(w) * h, 0);
    else tc.fdata.assign(static_cast<size_t>(w) * h, 0.f);
    for (int r = 0; r < tccp.numres; ++r) {
      Res& res = tc.res[r];
      for (int b = 0; b < res.nbands; ++b) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        int64_t ox = -band.x0, oy = -band.y0;
        if (band.bandno & 1) ox += tc.res[r - 1].x1 - tc.res[r - 1].x0;
        if (band.bandno & 2) oy += tc.res[r - 1].y1 - tc.res[r - 1].y0;
        const float stepsize = 0.5f * band.stepsize;
        for (Precinct& prc : band.precs)
          for (Cblk& cb : prc.cblks) {
            if (cb.x1 <= cb.x0 || cb.y1 <= cb.y0 || cb.segs.empty()) continue;
            decode_cblk(cb, band.bandno, tccp.roishift, tccp.cblksty, &t1);
            const int cw = cb.x1 - cb.x0;
            for (int y = 0; y < cb.y1 - cb.y0; ++y)
              for (int x = 0; x < cw; ++x) {
                const int32_t v = t1.data[y * cw + x];
                const size_t k = static_cast<size_t>(cb.y0 + oy + y) * w +
                                 (cb.x0 + ox + x);
                if (tccp.qmfbid == 1) tc.idata[k] = v / 2;
                else tc.fdata[k] = static_cast<float>(v) * stepsize;
              }
          }
      }
    }
    // the wavelets, level by level: rows, then columns
    std::vector<int32_t> itmp;
    std::vector<float> ftmp;
    for (int r = 1; r < tccp.numres; ++r) {
      const Res& lo = tc.res[r - 1];
      const Res& res = tc.res[r];
      const int rw = static_cast<int>(res.x1 - res.x0);
      const int rh = static_cast<int>(res.y1 - res.y0);
      const int snx = static_cast<int>(lo.x1 - lo.x0);
      const int sny = static_cast<int>(lo.y1 - lo.y0);
      const int casx = static_cast<int>(res.x0 & 1);
      const int casy = static_cast<int>(res.y0 & 1);
      itmp.resize(std::max(rw, rh) + 2);
      ftmp.resize(std::max(rw, rh) + 2);
      if (rw == 0 || rh == 0) continue;
      if (tccp.qmfbid == 1) {
        for (int y = 0; y < rh; ++y)
          idwt53(&tc.idata[static_cast<size_t>(y) * w], snx, rw - snx, casx,
                 itmp.data(), 1);
        for (int x = 0; x < rw; ++x)
          idwt53(&tc.idata[x], sny, rh - sny, casy, itmp.data(), w);
      } else {
        for (int y = 0; y < rh; ++y)
          idwt97(&tc.fdata[static_cast<size_t>(y) * w], snx, rw - snx, casx,
                 ftmp.data(), 1);
        for (int x = 0; x < rw; ++x)
          idwt97(&tc.fdata[x], sny, rh - sny, casy, ftmp.data(), w);
      }
    }
  }
  // the colour transform over the first three components
  if (tcp.mct == 1 && nc >= 3) {
    const bool same = tcs[0].w() == tcs[1].w() && tcs[0].w() == tcs[2].w() &&
                      tcs[0].h() == tcs[1].h() && tcs[0].h() == tcs[2].h();
    const bool rev = tcp.tccps[0].qmfbid == 1;
    if (same && tcp.tccps[1].qmfbid == tcp.tccps[0].qmfbid &&
        tcp.tccps[2].qmfbid == tcp.tccps[0].qmfbid) {
      const size_t n = static_cast<size_t>(tcs[0].w()) * tcs[0].h();
      if (rev) {
        int32_t* c0 = tcs[0].idata.data();
        int32_t* c1 = tcs[1].idata.data();
        int32_t* c2 = tcs[2].idata.data();
        for (size_t i = 0; i < n; ++i) {
          const int32_t y = c0[i], u = c1[i], v = c2[i];
          const int32_t g = y - ((u + v) >> 2);
          c0[i] = v + g;
          c1[i] = g;
          c2[i] = u + g;
        }
      } else {
        float* c0 = tcs[0].fdata.data();
        float* c1 = tcs[1].fdata.data();
        float* c2 = tcs[2].fdata.data();
        for (size_t i = 0; i < n; ++i) {
          const float y = c0[i], u = c1[i], v = c2[i];
          const float r = y + (v * 1.402f);
          const float g = y - (u * 0.34413f) - (v * 0.71414f);
          const float b = y + (u * 1.772f);
          c0[i] = r;
          c1[i] = g;
          c2[i] = b;
        }
      }
    } else if (!same) {
      damaged("colour transform over components of different sizes");
    } else {
      damaged("colour transform over components of different wavelets");
    }
  }
  // DC level shift and clip, into the image planes
  for (int c = 0; c < nc; ++c) {
    const Comp& comp = cs->comps[c];
    const TileComp& tc = tcs[c];
    const int64_t lo = comp.sgnd ? -(int64_t{1} << (comp.prec - 1)) : 0;
    const int64_t hi = comp.sgnd ? (int64_t{1} << (comp.prec - 1)) - 1
                                 : (int64_t{1} << comp.prec) - 1;
    const int64_t shift = comp.sgnd ? 0 : int64_t{1} << (comp.prec - 1);
    const bool rev = tcp.tccps[c].qmfbid == 1;
    const int w = tc.w();
    for (int y = 0; y < tc.h(); ++y)
      for (int x = 0; x < w; ++x) {
        const size_t k = static_cast<size_t>(y) * w + x;
        int64_t v;
        if (rev) {
          v = tc.idata[k] + shift;
        } else {
          const float f = tc.fdata[k];
          if (f > static_cast<float>(INT32_MAX)) v = hi;
          else if (f < static_cast<float>(INT32_MIN)) v = lo;
          else v = static_cast<int64_t>(std::lrintf(f)) + shift;
        }
        v = std::min(std::max(v, lo), hi);
        (*planes)[c][static_cast<size_t>(tc.y0 - py0[c] + y) * pw[c] +
                     (tc.x0 - px0[c] + x)] = static_cast<int32_t>(v);
      }
  }
}

// ------------------------------------------------------------- JP2 boxes

struct Jp2 {
  long cs_at = 0, cs_len = 0;
  int enumcs = 0;
  bool has_colr = false;
  // palette
  int nr_entries = 0, nr_channels = 0;
  std::vector<int> channel_size;
  std::vector<uint32_t> entries;
  struct Cmap {
    int cmp, mtyp, pcol;
  };
  std::vector<Cmap> cmap;
  bool has_pclr = false;
  struct Cdef {
    int cn, typ, asoc;
  };
  std::vector<Cdef> cdef;
};

void read_jp2h(const uint8_t* d, long n, Jp2* j) {
  long pos = 0;
  bool first = true;
  while (pos < n) {
    if (n - pos < 8) damaged("truncated JP2 header box");
    uint64_t len = be32(d + pos);
    const uint32_t type = be32(d + pos + 4);
    long hl = 8;
    if (len == 1) {
      if (n - pos < 16) damaged("truncated JP2 header box");
      len = (uint64_t{be32(d + pos + 8)} << 32) | be32(d + pos + 12);
      hl = 16;
    } else if (len == 0) {
      len = n - pos;
    }
    if (len < static_cast<uint64_t>(hl) || len > static_cast<uint64_t>(n - pos))
      damaged("JP2 header box of a bad length");
    const uint8_t* b = d + pos + hl;
    const long bl = static_cast<long>(len) - hl;
    if (first && type != 0x69686472)
      damaged("ihdr is not the first box in jp2h");
    first = false;
    if (type == 0x69686472) {  // ihdr
      if (bl != 14) damaged("bad ihdr box");
    } else if (type == 0x636F6C72) {  // colr
      if (!j->has_colr) {
        if (bl < 3) damaged("bad colr box");
        const int meth = b[0];
        if (meth == 1) {
          if (bl < 7) damaged("bad colr box");
          j->enumcs = static_cast<int>(be32(b + 3));
        }
        j->has_colr = true;
      }
    } else if (type == 0x70636C72) {  // pclr
      if (j->has_pclr) damaged("two pclr boxes");
      if (bl < 3) damaged("bad pclr box");
      j->nr_entries = static_cast<int>(be16(b));
      j->nr_channels = b[2];
      if (!j->nr_entries || j->nr_entries > 1024 || !j->nr_channels)
        damaged("bad pclr box");
      if (bl < 3 + j->nr_channels) damaged("bad pclr box");
      long q = 3;
      for (int i = 0; i < j->nr_channels; ++i) {
        j->channel_size.push_back((b[q] & 0x7F) + 1);
        ++q;
      }
      for (int e = 0; e < j->nr_entries; ++e)
        for (int i = 0; i < j->nr_channels; ++i) {
          const int bytes = (j->channel_size[i] + 7) >> 3;
          if (bytes > 4) damaged("palette entries wider than 32 bits");
          if (q + bytes > bl) damaged("truncated pclr box");
          uint32_t v = 0;
          for (int k = 0; k < bytes; ++k) v = (v << 8) | b[q++];
          j->entries.push_back(v);
        }
      j->has_pclr = true;
    } else if (type == 0x636D6170) {  // cmap
      if (!j->has_pclr) damaged("cmap before pclr");
      if (bl != 4 * j->nr_channels) damaged("bad cmap box");
      for (int i = 0; i < j->nr_channels; ++i)
        j->cmap.push_back({static_cast<int>(be16(b + 4 * i)), b[4 * i + 2],
                           b[4 * i + 3]});
    } else if (type == 0x63646566) {  // cdef
      if (bl < 2) damaged("bad cdef box");
      const int k = static_cast<int>(be16(b));
      if (!k || bl != 2 + 6 * k) damaged("bad cdef box");
      for (int i = 0; i < k; ++i)
        j->cdef.push_back({static_cast<int>(be16(b + 2 + 6 * i)),
                           static_cast<int>(be16(b + 4 + 6 * i)),
                           static_cast<int>(be16(b + 6 + 6 * i))});
    }
    pos += static_cast<long>(len);
  }
  if (first) damaged("empty jp2h box");
}

void read_jp2(const uint8_t* d, long n, Jp2* j) {
  long pos = 0;
  int index = 0;
  bool header = false;
  while (pos < n) {
    if (n - pos < 8) damaged("truncated JP2 box");
    uint64_t len = be32(d + pos);
    const uint32_t type = be32(d + pos + 4);
    long hl = 8;
    if (len == 1) {
      if (n - pos < 16) damaged("truncated JP2 box");
      len = (uint64_t{be32(d + pos + 8)} << 32) | be32(d + pos + 12);
      hl = 16;
    } else if (len == 0) {
      len = n - pos;
    }
    if (len < static_cast<uint64_t>(hl) || len > static_cast<uint64_t>(n - pos))
      damaged("truncated: a JP2 box runs past the end of the file");
    const uint8_t* b = d + pos + hl;
    const long bl = static_cast<long>(len) - hl;
    if (index == 0 && type != 0x6A502020)
      damaged("the signature box is not the first");
    if (index == 1 && type != 0x66747970) damaged("ftyp is not the second box");
    if (type == 0x6A502020) {
      if (bl != 4 || be32(b) != 0x0D0A870A) damaged("bad signature box");
    } else if (type == 0x6A703268) {  // jp2h
      read_jp2h(b, bl, j);
      header = true;
    } else if (type == 0x6A703263) {  // jp2c
      if (!header) damaged("codestream before the JP2 header box");
      j->cs_at = pos + hl;
      j->cs_len = bl;
      return;
    }
    pos += static_cast<long>(len);
    ++index;
  }
  if (!header) damaged("no JP2 header box");
  damaged("no codestream box");
}

// ---------------------------------------------------------------- image

struct Image {
  struct Plane {
    int64_t x0, y0, w, h;
    int dx, dy;
    std::vector<int32_t> v;
  };
  std::vector<Plane> comps;
  int max_prec = 0;  // over the codestream's components, as cv2 reads them
  int colour = 0;    // enumcs, 0 for none
};

void cv2_header_checks(const Codestream& cs) {
  const int nc = static_cast<int>(cs.comps.size());
  if (nc < 1 || nc > 4)
    refused(std::to_string(nc) + " components (cv2 takes 1 to 4)");
  int prec = 0;
  for (int c = 0; c < nc; ++c) {
    if (cs.comps[c].sgnd)
      refused("component " + std::to_string(c) + " is signed");
    prec = std::max(prec, cs.comps[c].prec);
  }
  if (prec < 8) refused("precision below 8 bits");
}

struct Parsed {
  Jp2 jp2;
  Codestream cs;
  const uint8_t* cs_data;
  long cs_len;
};

void parse(const uint8_t* d, long n, Parsed* p) {
  if (n >= 12 && std::memcmp(d, "\0\0\0\x0cjP  \r\n\x87\n", 12) == 0) {
    read_jp2(d, n, &p->jp2);
    p->cs_data = d + p->jp2.cs_at;
    p->cs_len = p->jp2.cs_len;
  } else {
    p->cs_data = d;
    p->cs_len = n;
  }
  parse_codestream(p->cs_data, p->cs_len, &p->cs);
}

void decode_image(Parsed* p, Image* img) {
  Codestream& cs = p->cs;
  const int nc = static_cast<int>(cs.comps.size());
  std::vector<std::vector<int32_t>> planes(nc);
  std::vector<int64_t> pw(nc), px0(nc), py0(nc);
  img->comps.resize(nc);
  for (int c = 0; c < nc; ++c) {
    const Comp& k = cs.comps[c];
    Image::Plane& pl = img->comps[c];
    pl.x0 = ceildiv(cs.x0, k.dx);
    pl.y0 = ceildiv(cs.y0, k.dy);
    pl.w = ceildiv(cs.x1, k.dx) - pl.x0;
    pl.h = ceildiv(cs.y1, k.dy) - pl.y0;
    pl.dx = k.dx;
    pl.dy = k.dy;
    if (pl.w * pl.h > int64_t{1} << 30) damaged("component too large");
    planes[c].assign(static_cast<size_t>(pl.w * pl.h), 0);
    pw[c] = pl.w;
    px0[c] = pl.x0;
    py0[c] = pl.y0;
    img->max_prec = std::max(img->max_prec, k.prec);
  }
  for (int t : cs.order) decode_tile(&cs, t, &planes, pw, px0, py0);
  for (int c = 0; c < nc; ++c) img->comps[c].v.swap(planes[c]);
  Jp2& j = p->jp2;
  img->colour = j.enumcs;
  // opj_jp2_check_color and opj_jp2_apply_pclr
  if (j.has_pclr) {
    if (j.cmap.empty()) {
      j.has_pclr = false;
    } else {
      for (const Jp2::Cmap& m : j.cmap) {
        if (m.cmp >= nc) damaged("palette channel maps a missing component");
        if (m.mtyp > 1 || (m.mtyp == 1 && m.pcol >= j.nr_channels) ||
            (m.mtyp == 0 && m.pcol != 0))
          damaged("bad component mapping");
      }
      for (int i = 0; i < j.nr_channels; ++i)
        if (j.cmap[i].mtyp == 1 && j.cmap[i].pcol != i)
          damaged("palette column mapped out of order");
      const std::vector<Image::Plane> old = img->comps;
      std::vector<Image::Plane> nw(j.nr_channels);
      for (int i = 0; i < j.nr_channels; ++i) {
        const Jp2::Cmap& m = j.cmap[i];
        const int dst = m.mtyp == 0 ? i : m.pcol;
        nw[dst] = old[m.cmp];
        nw[dst].v.assign(old[m.cmp].v.size(), 0);
      }
      const int top = j.nr_entries - 1;
      for (int i = 0; i < j.nr_channels; ++i) {
        const Jp2::Cmap& m = j.cmap[i];
        const std::vector<int32_t>& src = old[m.cmp].v;
        if (m.mtyp == 0) {
          nw[i].v = src;
        } else {
          std::vector<int32_t>& dst = nw[m.pcol].v;
          for (size_t k = 0; k < dst.size(); ++k) {
            int e = src[k];
            e = std::min(std::max(e, 0), top);
            dst[k] = static_cast<int32_t>(
                j.entries[e * j.nr_channels + m.pcol]);
          }
        }
      }
      img->comps.swap(nw);
    }
  }
  // opj_jp2_apply_cdef
  if (!j.cdef.empty()) {
    std::vector<Jp2::Cdef> info = j.cdef;
    const int ncomp = static_cast<int>(img->comps.size());
    for (const Jp2::Cdef& cd : info)
      if (cd.cn >= ncomp || (cd.asoc != 65535 && cd.asoc > ncomp))
        damaged("bad channel definition");
    for (size_t i = 0; i < info.size(); ++i) {
      const int cn = info[i].cn, asoc = info[i].asoc;
      if (asoc == 0 || asoc == 65535) continue;
      const int acn = asoc - 1;
      if (cn != acn && info[i].typ == 0) {
        std::swap(img->comps[cn], img->comps[acn]);
        for (size_t k = i + 1; k < info.size(); ++k) {
          if (info[k].cn == cn) info[k].cn = acn;
          else if (info[k].cn == acn) info[k].cn = cn;
        }
      }
    }
  }
}

// cv2's decodeSRGBData / decodeGrayscaleData / decodeSYCCData into RGB
void to_rgb(const Image& img, uint8_t* out, int h, int w) {
  // OpenJPEG names 12 (CMYK), 16 (sRGB), 17 (gray), 18 (sYCC) and 24
  // (e-sYCC); cv2 takes any other as sRGB
  const int cs = img.colour == 17 || img.colour == 18 ? img.colour : 0;
  if (img.colour == 24) refused("e-sYCC colour space");
  if (img.colour == 12) refused("CMYK colour space");
  for (size_t c = 0; c < img.comps.size(); ++c) {
    const Image::Plane& p = img.comps[c];
    if (p.dx != 1 || p.dy != 1) refused("sub-sampled components");
    if (p.x0 != 0 || p.y0 != 0) refused("an image offset");
    if (p.w != w || p.h != h) refused("components of different sizes");
  }
  const int shift = std::max(img.max_prec - 8, 0);
  const size_t n = static_cast<size_t>(h) * w;
  const int nin = static_cast<int>(img.comps.size());
  auto px = [&](int c, size_t k) {
    const int v = img.comps[c].v[k] >> shift;
    return static_cast<uint8_t>(std::min(std::max(v, 0), 255));
  };
  if (cs == 18 && nin < 3) refused("sYCC of fewer than 3 components");
  if (cs == 0 && nin < 3)
    refused(std::to_string(nin) + " component" + (nin > 1 ? "s" : "") +
            " as sRGB");
  const bool gray = cs == 17;
  if (cs == 18 && nin >= 3) {  // cvtColor(COLOR_YUV2BGR), fixed point
    for (size_t k = 0; k < n; ++k) {
      const int y = px(0, k), u = px(1, k) - 128, v = px(2, k) - 128;
      auto sat = [](int x) {
        return static_cast<uint8_t>(std::min(std::max(x, 0), 255));
      };
      const int r = y + ((v * 18678 + (1 << 13)) >> 14);
      const int g = y + ((u * -6472 + v * -9519 + (1 << 13)) >> 14);
      const int b = y + ((u * 33292 + (1 << 13)) >> 14);
      out[3 * k] = sat(r);
      out[3 * k + 1] = sat(g);
      out[3 * k + 2] = sat(b);
    }
    return;
  }
  if (gray) {
    for (size_t k = 0; k < n; ++k)
      out[3 * k] = out[3 * k + 1] = out[3 * k + 2] = px(0, k);
    return;
  }
  for (size_t k = 0; k < n; ++k) {
    out[3 * k] = px(0, k);
    out[3 * k + 1] = px(1, k);
    out[3 * k + 2] = px(2, k);
  }
}

}  // namespace

bool is_jpeg2000(const uint8_t* d, long n) {
  return (n >= 12 && std::memcmp(d, "\0\0\0\x0cjP  \r\n\x87\n", 12) == 0) ||
         (n >= 4 && d[0] == 0xFF && d[1] == 0x4F && d[2] == 0xFF &&
          d[3] == 0x51);
}

int jpeg2000_info(const uint8_t* d, long n, int* h, int* w) {
  try {
    Parsed p;
    parse(d, n, &p);
    cv2_header_checks(p.cs);
    *h = static_cast<int>(p.cs.y1 - p.cs.y0);
    *w = static_cast<int>(p.cs.x1 - p.cs.x0);
    return kOk;
  } catch (const Fail& f) {
    set_error(f.msg);
    return f.status;
  }
}

int jpeg2000_decode(const uint8_t* d, long n, uint8_t* out, int h, int w) {
  try {
    Parsed p;
    parse(d, n, &p);
    cv2_header_checks(p.cs);
    if (p.cs.y1 - p.cs.y0 != h || p.cs.x1 - p.cs.x0 != w) {
      set_error("JPEG 2000: size mismatch");
      return kSizeMismatch;
    }
    Image img;
    decode_image(&p, &img);
    to_rgb(img, out, h, w);
    return kOk;
  } catch (const Fail& f) {
    set_error(f.msg);
    return f.status;
  }
}

}  // namespace sdt
