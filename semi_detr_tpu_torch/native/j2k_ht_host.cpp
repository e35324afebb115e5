// High-throughput JPEG 2000 code-blocks (ITU-T T.814 / ISO/IEC 15444-15),
// decoded for j2k_host.cpp as OpenJPEG 2.5.3's ht_dec.c decodes them for
// cv2 5.0: the same streams read with the same stuffing rules, in the
// same order, to the same coefficients (sign and magnitude at twice the
// coefficient with the bin centre set, turned to two's complement at the
// end, as Part 1's tier-1 leaves them for the dequantisation).
//
// * The cleanup pass: MagSgn read forward from the segment's start (0xFF
//   past its end), the MEL forward from Lcup - Scup (its last byte ORed
//   with 0x0F, 0xFF past it), the VLC backward from Lcup - 2 (its first
//   nibble the upper half of that byte), each unstuffed as ht_dec.c
//   unstuffs it; the quads two rows at a time, a pair of quads at a time:
//   the VLC codeword of each quad by its context (j2k_ht_tables.h, the
//   first row's table and the other rows'), a MEL event for a quad of
//   context 0, u by the UVLC (the first row's rule for a pair whose quads
//   both have u_off: a MEL event, u - 2 or a one-bit u), the exponent
//   bound of the other rows from the line state of the row above, then
//   the magnitudes and signs.
// * SigProp (forward, 0 past its end) and MagRef (backward from the end of
//   the second segment) four rows at a time, in OpenJPEG's order: MagRef
//   on a stripe once its rows are decoded, SigProp on it once the stripe
//   below is (its membership from the rows around, the stripe below left
//   out under VSC), in groups of four columns, significance bits then
//   signs.
// * What OpenJPEG does with a code-block it cannot decode fails the whole
//   picture, as cv2 returns none: ROI, more than 3 passes, more than 30
//   bit-planes (refused), zero bit-planes past the band's, lengths or Scup
//   out of range, a bad MEL start, an exponent bound past the bit-planes,
//   significance outside the block (damaged). A second segment of length 0
//   keeps only the cleanup pass, and so does a block with as many zero
//   bit-planes as the band has, as OpenJPEG warns and goes on.
//
// The MEL's first bytes are checked for a byte above 0x8F after an 0xFF as
// OpenJPEG checks them where its buffer is 4-byte aligned; a valid stream
// never has one (the MEL stuffs a 0 bit after 0xFF).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "host.h"
#include "j2k_ht_tables.h"

namespace sdt {

namespace {

using namespace j2k_ht;

struct Stop {
  int status;
  std::string msg;
};

[[noreturn]] void damaged(const std::string& m) {
  throw Stop{kHtDamaged, m};
}
[[noreturn]] void refused(const std::string& m) {
  throw Stop{kHtRefused, m};
}

// the MEL: bits from the most significant, 7 in the byte after an 0xFF
struct Mel {
  const uint8_t* p;
  long size;
  uint64_t tmp = 0;  // bits at the top
  int bits = 0, k = 0;
  bool unstuff = false;

  uint32_t next_byte() {
    uint32_t d = size > 0 ? *p : 0xFF;
    if (size == 1) d |= 0xF;  // the byte it shares with the VLC
    if (size-- > 0) ++p;
    return d;
  }
  void init(const uint8_t* d, int lcup, int scup) {
    p = d + lcup - scup;
    size = scup - 1;
    for (int i = 0; i < 4; ++i) {
      if (unstuff && p[0] > 0x8F)
        damaged("a MEL byte above 0x8F after an 0xFF");
      const uint32_t v = next_byte();
      const int n = 8 - unstuff;
      tmp = (tmp << n) | v;
      bits += n;
      unstuff = (v & 0xFF) == 0xFF;
    }
    tmp <<= 64 - bits;
  }
  void fill() {
    while (bits <= 56) {
      const uint32_t v = next_byte();
      const int n = 8 - unstuff;
      tmp |= static_cast<uint64_t>(v) << (64 - bits - n);
      bits += n;
      unstuff = v == 0xFF;
    }
  }
  // the next run: 2n for n 0 events, 2n + 1 for n 0 events and a 1
  int run() {
    fill();
    const int e = kMelExp[k];
    int r;
    if (tmp >> 63) {
      r = ((1 << e) - 1) << 1;
      k = std::min(k + 1, 12);
      tmp <<= 1;
      bits -= 1;
    } else {
      r = static_cast<int>((tmp >> (63 - e)) & ((1u << e) - 1));
      r = (r << 1) + 1;
      k = std::max(k - 1, 0);
      tmp <<= e + 1;
      bits -= e + 1;
    }
    return r;
  }
};

// a backward stream (VLC, MagRef): bits from the least significant, 7 in
// a byte whose low 7 are ones after one above 0x8F; zeros past the end
struct Rev {
  const uint8_t* p;
  long size;
  uint64_t tmp = 0;
  int bits = 0;
  bool unstuff = true;

  void init_vlc(const uint8_t* d, int lcup, int scup) {
    p = d + lcup - 2;
    size = scup - 2;
    const uint32_t v = *p--;
    tmp = v >> 4;
    bits = 4 - ((tmp & 7) == 7);
    unstuff = (v | 0xF) > 0x8F;
  }
  void init_mrp(const uint8_t* d, int lcup, int len2) {
    p = d + lcup + len2 - 1;
    size = len2;
  }
  uint32_t fetch() {
    while (bits <= 56) {
      uint32_t v = 0;
      if (size > 0) {
        v = *p--;
        --size;
      }
      tmp |= static_cast<uint64_t>(v) << bits;
      bits += 8 - (unstuff && (v & 0x7F) == 0x7F);
      unstuff = v > 0x8F;
    }
    return static_cast<uint32_t>(tmp);
  }
  uint32_t advance(int n) {
    tmp >>= n;
    bits -= n;
    return static_cast<uint32_t>(tmp);
  }
};

// a forward stream (MagSgn with 0xFF past its end, SigProp with 0): bits
// from the least significant, 7 in the byte after an 0xFF
struct Fwd {
  const uint8_t* p;
  long size;
  uint32_t x;
  uint64_t tmp = 0;
  int bits = 0;
  bool unstuff = false;

  void init(const uint8_t* d, long n, uint32_t fill) {
    p = d;
    size = n;
    x = fill;
  }
  uint32_t fetch() {
    while (bits <= 56) {
      uint32_t v = x;
      if (size > 0) v = *p++;
      --size;
      tmp |= static_cast<uint64_t>(v) << bits;
      bits += 8 - unstuff;
      unstuff = v == 0xFF;
    }
    return static_cast<uint32_t>(tmp);
  }
  void advance(int n) {
    tmp >>= n;
    bits -= n;
  }
};

// the prefix (bits 0-1: length; 2-4: suffix length; 5-7: base) of u by
// the VLC's next three bits (T.814 Table 3)
constexpr uint8_t kUvlc[8] = {
    3 | (5 << 2) | (5 << 5), 1 | (0 << 2) | (1 << 5), 2 | (0 << 2) | (2 << 5),
    1 | (0 << 2) | (1 << 5), 3 | (1 << 2) | (3 << 5), 1 | (0 << 2) | (1 << 5),
    2 | (0 << 2) | (2 << 5), 1 | (0 << 2) | (1 << 5)};

// u_q + 1 of a pair of quads of the first row by its mode (u_off bits,
// 4 with the MEL's 1); returns the bits taken
int uvlc_initial(uint32_t vlc, int mode, uint32_t* u) {
  int used = 0;
  if (mode == 0) {
    u[0] = u[1] = 1;
  } else if (mode <= 2) {
    uint32_t d = kUvlc[vlc & 7];
    vlc >>= d & 3;
    used += d & 3;
    const int suffix = (d >> 2) & 7;
    used += suffix;
    d = (d >> 5) + (vlc & ((1u << suffix) - 1));
    u[0] = mode == 1 ? d + 1 : 1;
    u[1] = mode == 1 ? 1 : d + 1;
  } else if (mode == 3) {
    uint32_t d1 = kUvlc[vlc & 7];
    vlc >>= d1 & 3;
    used += d1 & 3;
    if ((d1 & 3) > 2) {
      u[1] = (vlc & 1) + 1 + 1;
      ++used;
      vlc >>= 1;
      const int suffix = (d1 >> 2) & 7;
      used += suffix;
      d1 = (d1 >> 5) + (vlc & ((1u << suffix) - 1));
      u[0] = d1 + 1;
    } else {
      uint32_t d2 = kUvlc[vlc & 7];
      vlc >>= d2 & 3;
      used += d2 & 3;
      int suffix = (d1 >> 2) & 7;
      used += suffix;
      d1 = (d1 >> 5) + (vlc & ((1u << suffix) - 1));
      u[0] = d1 + 1;
      vlc >>= suffix;
      suffix = (d2 >> 2) & 7;
      used += suffix;
      d2 = (d2 >> 5) + (vlc & ((1u << suffix) - 1));
      u[1] = d2 + 1;
    }
  } else {
    uint32_t d1 = kUvlc[vlc & 7];
    vlc >>= d1 & 3;
    used += d1 & 3;
    uint32_t d2 = kUvlc[vlc & 7];
    vlc >>= d2 & 3;
    used += d2 & 3;
    int suffix = (d1 >> 2) & 7;
    used += suffix;
    d1 = (d1 >> 5) + (vlc & ((1u << suffix) - 1));
    u[0] = d1 + 3;
    vlc >>= suffix;
    suffix = (d2 >> 2) & 7;
    used += suffix;
    d2 = (d2 >> 5) + (vlc & ((1u << suffix) - 1));
    u[1] = d2 + 3;
  }
  return used;
}

// the same for the other rows (no MEL event, u + 1 before the exponent
// predictor)
int uvlc_other(uint32_t vlc, int mode, uint32_t* u) {
  int used = 0;
  if (mode == 0) {
    u[0] = u[1] = 1;
  } else if (mode <= 2) {
    uint32_t d = kUvlc[vlc & 7];
    vlc >>= d & 3;
    used += d & 3;
    const int suffix = (d >> 2) & 7;
    used += suffix;
    d = (d >> 5) + (vlc & ((1u << suffix) - 1));
    u[0] = mode == 1 ? d + 1 : 1;
    u[1] = mode == 1 ? 1 : d + 1;
  } else {
    uint32_t d1 = kUvlc[vlc & 7];
    vlc >>= d1 & 3;
    used += d1 & 3;
    uint32_t d2 = kUvlc[vlc & 7];
    vlc >>= d2 & 3;
    used += d2 & 3;
    int suffix = (d1 >> 2) & 7;
    used += suffix;
    d1 = (d1 >> 5) + (vlc & ((1u << suffix) - 1));
    u[0] = d1 + 1;
    vlc >>= suffix;
    suffix = (d2 >> 2) & 7;
    used += suffix;
    d2 = (d2 >> 5) + (vlc & ((1u << suffix) - 1));
    u[1] = d2 + 1;
  }
  return used;
}

int popcount(uint32_t v) { return __builtin_popcount(v); }

int bitlen(uint32_t v) { return v ? 32 - __builtin_clz(v) : 0; }

struct Block {
  int w, stride;
  uint32_t* out;
  int p;  // the cleanup's bit-plane in `out` (bit 0 the bin centre's half)
  bool causal;
  std::vector<uint32_t> sigma1, sigma2, mbr1, mbr2;
  Fwd sigprop;
  Rev magref;

  // one magnitude and sign of the cleanup: m bits read, the EMB bit e1
  // above them
  uint32_t sample(Fwd* ms, uint32_t m, uint32_t e1, uint32_t* vn) {
    const uint32_t v = ms->fetch();
    ms->advance(static_cast<int>(m));
    uint32_t n = v & ((1u << m) - 1);
    n |= e1 << m;
    n |= 1;
    *vn = n;
    return (v << 31) | ((n + 2) << (p - 1));
  }

  // MagRef on the stripe of `sig` whose first row is y0
  void magref_stripe(const uint32_t* sig, int y0) {
    uint32_t* dpp = out + static_cast<size_t>(y0) * stride;
    const uint32_t half = 1u << (p - 2);
    for (int i = 0; i < w; i += 8) {
      uint32_t cwd = magref.fetch();
      const uint32_t s = *sig++;
      uint32_t* dp = dpp + i;
      if (s) {
        uint32_t col = 0xFu;
        for (int j = 0; j < 8; ++j, ++dp, col <<= 4) {
          if (!(s & col)) continue;
          uint32_t bit = 0x11111111u & col;
          for (int r = 0; r < 4; ++r, bit <<= 1) {
            if (!(s & bit)) continue;
            const uint32_t sym = cwd & 1;
            dp[r * stride] ^= (1 - sym) << (p - 1);
            dp[r * stride] |= half;
            cwd >>= 1;
          }
        }
      }
      magref.advance(popcount(s));
    }
  }

  // the membership of a stripe from its own significant samples
  void stripe_mbr(const uint32_t* sig, uint32_t* mbr) {
    uint32_t prev = 0;
    for (int i = 0; i < w; i += 8, ++mbr, ++sig) {
      uint32_t m = sig[0];
      m |= prev >> 28;
      m |= sig[0] << 4;
      m |= sig[0] >> 4;
      m |= sig[1] << 28;
      prev = sig[0];
      const uint32_t t = m;
      m |= (t & 0x77777777u) << 1;
      m |= (t & 0xEEEEEEEEu) >> 1;
      *mbr = m & ~sig[0];
    }
  }

  // the stripe below's first row into the stripe's last (not under VSC)
  void below_mbr(const uint32_t* cur_sig, uint32_t* cur_mbr,
                 const uint32_t* nxt_sig) {
    uint32_t prev = 0;
    for (int i = 0; i < w; i += 8, ++cur_mbr, ++cur_sig, ++nxt_sig) {
      uint32_t t = nxt_sig[0];
      t |= prev >> 28;
      t |= nxt_sig[0] << 4;
      t |= nxt_sig[0] >> 4;
      t |= nxt_sig[1] << 28;
      prev = nxt_sig[0];
      if (!causal) cur_mbr[0] |= (t & 0x11111111u) << 3;
      cur_mbr[0] &= ~cur_sig[0];
    }
  }

  // SigProp on the stripe at y0 (pattern: its rows inside the block)
  void sigprop_stripe(uint32_t* cur_sig, uint32_t* cur_mbr,
                      const uint32_t* nxt_sig, uint32_t* nxt_mbr, int y0,
                      uint32_t pattern) {
    const uint32_t val = 3u << (p - 2);
    for (int i = 0; i < w;
         i += 8, ++cur_sig, ++cur_mbr, ++nxt_sig, ++nxt_mbr) {
      uint32_t mbr = *cur_mbr & pattern;
      uint32_t new_sig = 0;
      if (mbr) {
        for (int n = 0; n < 8; n += 4) {
          uint32_t cwd = sigprop.fetch();
          int cnt = 0;
          uint32_t* dp = out + static_cast<size_t>(y0) * stride + i + n;
          uint32_t col = 0xFu << (4 * n);
          const uint32_t inv_sig = ~cur_sig[0] & pattern;
          const int end = n + 4 + i < w ? n + 4 : w - i;
          static const uint32_t kSpread[4] = {0x32u, 0x74u, 0xE8u, 0xC0u};
          for (int j = n; j < end; ++j, ++dp, col <<= 4) {
            if (!(col & mbr)) continue;
            uint32_t bit = 0x11111111u & col;
            for (int r = 0; r < 4; ++r, bit <<= 1) {
              if (!(mbr & bit)) continue;
              if (cwd & 1) {
                new_sig |= bit;
                mbr |= (kSpread[r] << (j * 4)) & inv_sig;
              }
              cwd >>= 1;
              ++cnt;
            }
          }
          if (new_sig & (0xFFFFu << (4 * n))) {
            uint32_t* dq = out + static_cast<size_t>(y0) * stride + i + n;
            col = 0xFu << (4 * n);
            for (int j = n; j < end; ++j, ++dq, col <<= 4) {
              if (!(col & new_sig)) continue;
              uint32_t bit = 0x11111111u & col;
              for (int r = 0; r < 4; ++r, bit <<= 1) {
                if (!(new_sig & bit)) continue;
                dq[r * stride] |= ((cwd & 1) << 31) | val;
                cwd >>= 1;
                ++cnt;
              }
            }
          }
          sigprop.advance(cnt);
          if (n == 4) {  // into the next eight columns
            uint32_t t = new_sig >> 28;
            t |= ((t & 0xE) >> 1) | ((t & 7) << 1);
            cur_mbr[1] |= t & ~cur_sig[1];
          }
        }
      }
      new_sig |= cur_sig[0];  // down into the next stripe
      const uint32_t ux = (new_sig & 0x88888888u) >> 3;
      const uint32_t tx = ux | (ux << 4) | (ux >> 4);
      if (i > 0) nxt_mbr[-1] |= (ux << 28) & ~nxt_sig[-1];
      nxt_mbr[0] |= tx & ~nxt_sig[0];
      nxt_mbr[1] |= (ux >> 28) & ~nxt_sig[1];
    }
  }
};

void decode(const uint8_t* data, long cblk_len, const int* seg_passes,
            const long* seg_lens, int nsegs, int mb, int numbps, int roishift,
            bool vsc, int width, int height, int32_t* out32) {
  if (roishift) refused("ROI with high-throughput code-blocks");
  if (!nsegs) return;  // never included: zeros
  const int zero_bplanes = mb + 1 - numbps;
  int num_passes = seg_passes[0] + (nsegs > 1 ? seg_passes[1] : 0);
  const long lengths1 = num_passes > 0 ? seg_lens[0] : 0;
  const long lengths2 = num_passes > 1 && nsegs > 1 ? seg_lens[1] : 0;
  if (num_passes > 1 && lengths2 == 0) num_passes = 1;
  if (mb > 30)
    refused(std::to_string(mb) + " bit-planes in a high-throughput "
            "code-block (OpenJPEG decodes at most 30)");
  if (num_passes > 3)
    refused(std::to_string(num_passes) + " coding passes in a high-"
            "throughput code-block (OpenJPEG decodes at most 3)");
  if (zero_bplanes > mb)
    damaged(std::to_string(zero_bplanes) + " zero bit-planes in " +
            std::to_string(mb));
  if (zero_bplanes == mb && num_passes > 1) num_passes = 1;
  if (lengths1 < 2 || lengths1 > cblk_len || lengths1 + lengths2 > cblk_len)
    damaged("high-throughput code-block lengths out of range");
  const int lcup = static_cast<int>(lengths1);
  const int scup = (data[lcup - 1] << 4) + (data[lcup - 2] & 0xF);
  if (scup < 2 || scup > lcup || scup > 4079)
    damaged("Scup out of range (2 <= Scup <= min(Lcup, 4079))");

  Block b;
  b.w = width;
  b.stride = width;
  b.out = reinterpret_cast<uint32_t*>(out32);
  b.p = numbps;
  b.causal = vsc;
  const uint32_t mmsbp2 = static_cast<uint32_t>(zero_bplanes) + 1;
  const size_t words = static_cast<size_t>((width + 7) >> 3) + 2;
  b.sigma1.assign(words, 0);
  b.sigma2.assign(words, 0);
  b.mbr1.assign(words, 0);
  b.mbr2.assign(words, 0);
  uint32_t* sigma1 = b.sigma1.data();
  uint32_t* sigma2 = b.sigma2.data();
  uint32_t* mbr1 = b.mbr1.data();
  uint32_t* mbr2 = b.mbr2.data();

  Mel mel;
  mel.init(data, lcup, scup);
  Rev vlc;
  vlc.init_vlc(data, lcup, scup);
  Fwd ms;
  ms.init(data, lcup - scup, 0xFF);
  if (num_passes > 1) b.sigprop.init(data + lengths1, lengths2, 0);
  if (num_passes > 2)
    b.magref.init_mrp(data, lcup, static_cast<int>(lengths2));

  std::vector<uint8_t> line_state(static_cast<size_t>(width) / 2 + 8, 0);
  uint32_t* const dec = b.out;
  const int stride = width;

  // the magnitudes and signs of one quad's significant samples at sp
  // (rows y, y + 1; the block starts zeroed), and the line state: the
  // largest exponent and significance of the row's bottom samples, one
  // entry a quad (its left sample's, with the previous quad's right one)
  auto quad = [&](uint32_t qinf, uint32_t U, uint32_t* sp, uint8_t*& lsp) {
    uint32_t vn;
    if (qinf & 0x10)
      sp[0] = b.sample(&ms, U - ((qinf >> 12) & 1), (qinf >> 8) & 1, &vn);
    if (qinf & 0x20) {
      sp[stride] = b.sample(&ms, U - ((qinf >> 13) & 1), (qinf >> 9) & 1,
                            &vn);
      const uint32_t t = lsp[0] & 0x7F;
      const uint32_t e = static_cast<uint32_t>(bitlen(vn));
      lsp[0] = static_cast<uint8_t>(0x80 | (t > e ? t : e));
    }
    ++lsp;
    if (qinf & 0x40)
      sp[1] = b.sample(&ms, U - ((qinf >> 14) & 1), (qinf >> 10) & 1, &vn);
    lsp[0] = 0;
    if (qinf & 0x80) {
      sp[stride + 1] = b.sample(&ms, U - ((qinf >> 15) & 1),
                                (qinf >> 11) & 1, &vn);
      lsp[0] = static_cast<uint8_t>(0x80 | bitlen(vn));
    }
  };

  // the first two rows
  int run = mel.run();
  uint32_t c_q = 0;
  uint8_t* lsp = line_state.data();
  uint32_t* sip = sigma1;
  int sip_shift = 0;
  for (int x = 0; x < width; x += 4) {
    uint32_t qinf[2] = {0, 0};
    uint32_t vlc_val = vlc.fetch();
    qinf[0] = kVlcInitial[(c_q << 7) | (vlc_val & 0x7F)];
    if (c_q == 0) {
      run -= 2;
      qinf[0] = run == -1 ? qinf[0] : 0;
      if (run < 0) run = mel.run();
    }
    c_q = ((qinf[0] & 0x10) >> 4) | ((qinf[0] & 0xE0) >> 5);
    vlc_val = vlc.advance(qinf[0] & 7);
    *sip |= (((qinf[0] & 0x30) >> 4) | ((qinf[0] & 0xC0) >> 2)) << sip_shift;
    if (x + 2 < width) {
      qinf[1] = kVlcInitial[(c_q << 7) | (vlc_val & 0x7F)];
      if (c_q == 0) {
        run -= 2;
        qinf[1] = run == -1 ? qinf[1] : 0;
        if (run < 0) run = mel.run();
      }
      c_q = ((qinf[1] & 0x10) >> 4) | ((qinf[1] & 0xE0) >> 5);
      vlc_val = vlc.advance(qinf[1] & 7);
    }
    *sip |= ((qinf[1] & 0x30) | ((qinf[1] & 0xC0) << 2)) << (4 + sip_shift);
    sip += (x & 7) ? 1 : 0;
    sip_shift ^= 0x10;
    int mode = static_cast<int>(((qinf[0] & 8) >> 3) | ((qinf[1] & 8) >> 2));
    if (mode == 3) {
      run -= 2;
      mode += run == -1 ? 1 : 0;
      if (run < 0) run = mel.run();
    }
    uint32_t U[2];
    const int used = uvlc_initial(vlc_val, mode, U);
    if (U[0] > mmsbp2 || U[1] > mmsbp2)
      damaged("an exponent bound past the bit-planes (the first row)");
    vlc.advance(used);
    uint32_t locs = 0xFF;
    if (x + 4 > width) locs >>= (x + 4 - width) << 1;
    locs = height > 1 ? locs : (locs & 0x55);
    if ((((qinf[0] & 0xF0) >> 4) | (qinf[1] & 0xF0)) & ~locs)
      damaged("significant samples outside the code-block");
    quad(qinf[0], U[0], dec + x, lsp);
    quad(qinf[1], U[1], dec + x + 2, lsp);
  }

  // the other rows, two at a time
  for (int y = 2; y < height;) {
    sip_shift ^= 0x2;
    sip_shift &= ~0x10;
    sip = (y & 4) ? sigma2 : sigma1;
    lsp = line_state.data();
    uint8_t ls0 = lsp[0];
    lsp[0] = 0;
    uint32_t* row = dec + static_cast<size_t>(y) * stride;
    c_q = 0;
    for (int x = 0; x < width; x += 4) {
      uint32_t qinf[2] = {0, 0};
      c_q |= ls0 >> 7;
      c_q |= (lsp[1] >> 5) & 4;
      uint32_t vlc_val = vlc.fetch();
      qinf[0] = kVlcNonInitial[(c_q << 7) | (vlc_val & 0x7F)];
      if (c_q == 0) {
        run -= 2;
        qinf[0] = run == -1 ? qinf[0] : 0;
        if (run < 0) run = mel.run();
      }
      c_q = ((qinf[0] & 0x40) >> 5) | ((qinf[0] & 0x80) >> 6);
      vlc_val = vlc.advance(qinf[0] & 7);
      *sip |= (((qinf[0] & 0x30) >> 4) | ((qinf[0] & 0xC0) >> 2))
              << sip_shift;
      if (x + 2 < width) {
        c_q |= lsp[1] >> 7;
        c_q |= (lsp[2] >> 5) & 4;
        qinf[1] = kVlcNonInitial[(c_q << 7) | (vlc_val & 0x7F)];
        if (c_q == 0) {
          run -= 2;
          qinf[1] = run == -1 ? qinf[1] : 0;
          if (run < 0) run = mel.run();
        }
        c_q = ((qinf[1] & 0x40) >> 5) | ((qinf[1] & 0x80) >> 6);
        vlc_val = vlc.advance(qinf[1] & 7);
      }
      *sip |= ((qinf[1] & 0x30) | ((qinf[1] & 0xC0) << 2))
              << (4 + sip_shift);
      sip += (x & 7) ? 1 : 0;
      sip_shift ^= 0x10;
      const int mode =
          static_cast<int>(((qinf[0] & 8) >> 3) | ((qinf[1] & 8) >> 2));
      uint32_t U[2];
      const int used = uvlc_other(vlc_val, mode, U);
      vlc.advance(used);
      if ((qinf[0] & 0xF0) & ((qinf[0] & 0xF0) - 1)) {
        uint32_t e = ls0 & 0x7Fu;
        e = std::max<uint32_t>(e, lsp[1] & 0x7F);
        U[0] += e > 2 ? e - 2 : 0;
      }
      if ((qinf[1] & 0xF0) & ((qinf[1] & 0xF0) - 1)) {
        uint32_t e = lsp[1] & 0x7Fu;
        e = std::max<uint32_t>(e, lsp[2] & 0x7F);
        U[1] += e > 2 ? e - 2 : 0;
      }
      if (U[0] > mmsbp2 || U[1] > mmsbp2)
        damaged("an exponent bound past the bit-planes");
      ls0 = lsp[2];
      lsp[1] = lsp[2] = 0;
      uint32_t locs = 0xFF;
      if (x + 4 > width) locs >>= (x + 4 - width) << 1;
      locs = y + 2 <= height ? locs : (locs & 0x55);
      if ((((qinf[0] & 0xF0) >> 4) | (qinf[1] & 0xF0)) & ~locs)
        damaged("significant samples outside the code-block");
      quad(qinf[0], U[0], row + x, lsp);
      quad(qinf[1], U[1], row + x + 2, lsp);
    }
    y += 2;
    if (num_passes > 1 && (y & 3) == 0) {
      if (num_passes > 2)
        b.magref_stripe((y & 4) ? sigma1 : sigma2, y - 4);
      b.stripe_mbr((y & 4) ? sigma1 : sigma2, (y & 4) ? mbr1 : mbr2);
      if (y >= 8) {
        uint32_t* cur_sig = (y & 4) ? sigma2 : sigma1;
        uint32_t* cur_mbr = (y & 4) ? mbr2 : mbr1;
        uint32_t* nxt_sig = (y & 4) ? sigma1 : sigma2;
        uint32_t* nxt_mbr = (y & 4) ? mbr1 : mbr2;
        b.below_mbr(cur_sig, cur_mbr, nxt_sig);
        b.sigprop_stripe(cur_sig, cur_mbr, nxt_sig, nxt_mbr, y - 8,
                         0xFFFFFFFFu);
        std::memset(cur_sig, 0, words * sizeof(uint32_t));
      }
    }
  }

  // the stripes left
  if (num_passes > 1) {
    if (num_passes > 2 && ((height & 3) == 1 || (height & 3) == 2))
      b.magref_stripe((height & 4) ? sigma2 : sigma1, height & ~3);
    if ((height & 3) == 1 || (height & 3) == 2)
      b.stripe_mbr((height & 4) ? sigma2 : sigma1,
                   (height & 4) ? mbr2 : mbr1);
    int st = height;
    st -= height > 6 ? (((height + 1) & 3) + 3) : height;
    for (int y = st; y < height; y += 4) {
      uint32_t pattern = 0xFFFFFFFFu;
      if (height - y == 3) pattern = 0x77777777u;
      else if (height - y == 2) pattern = 0x33333333u;
      else if (height - y == 1) pattern = 0x11111111u;
      uint32_t* cur_sig = (y & 4) ? sigma2 : sigma1;
      uint32_t* cur_mbr = (y & 4) ? mbr2 : mbr1;
      uint32_t* nxt_sig = (y & 4) ? sigma1 : sigma2;
      uint32_t* nxt_mbr = (y & 4) ? mbr1 : mbr2;
      if (height - y > 4) b.below_mbr(cur_sig, cur_mbr, nxt_sig);
      b.sigprop_stripe(cur_sig, cur_mbr, nxt_sig, nxt_mbr, y, pattern);
    }
  }

  // sign and magnitude to two's complement
  const size_t n = static_cast<size_t>(width) * height;
  for (size_t i = 0; i < n; ++i) {
    const int32_t v = static_cast<int32_t>(dec[i] & 0x7FFFFFFFu);
    out32[i] = (dec[i] & 0x80000000u) ? -v : v;
  }
}

}  // namespace

int j2k_ht_decode_cblk(const uint8_t* data, long len, const int* seg_passes,
                       const long* seg_lens, int nsegs, int mb, int numbps,
                       int roishift, bool vsc, int w, int h, int32_t* out,
                       std::string* msg) {
  try {
    decode(data, len, seg_passes, seg_lens, nsegs, mb, numbps, roishift, vsc,
           w, h, out);
    return kHtOk;
  } catch (const Stop& s) {
    *msg = s.msg;
    return s.status;
  }
}

}  // namespace sdt
