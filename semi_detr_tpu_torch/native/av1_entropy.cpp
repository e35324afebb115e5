// The AV1 symbol decoder (8.2), its inverse (the encoder libaom writes
// tiles with) and the default CDFs both start each tile from
// (av1_tables.h, libaom 3.14.1's, which cv2's libavif decodes with); the
// decoder's errors and its per-process tally of the tools it decoded.
#include <algorithm>
#include <cstring>

#include "av1.h"
#include "av1_tables.h"
#include "host.h"

namespace sdt {
namespace av1 {

const char* const kToolNames[kToolCount] = {
    "superblock_64", "superblock_128", "partition_none", "partition_horz",
    "partition_vert", "partition_split", "partition_horz_a",
    "partition_horz_b", "partition_vert_a", "partition_vert_b",
    "partition_horz_4", "partition_vert_4", "split_or_horz", "split_or_vert",
    "skip", "dc_pred", "v_pred", "h_pred", "directional", "angle_delta",
    "intra_edge_filter", "intra_edge_upsample", "smooth_pred",
    "smooth_v_pred", "smooth_h_pred", "paeth_pred", "cfl", "filter_intra",
    "palette_y", "palette_uv", "palette_cache", "palette_delta_v", "intrabc",
    "intrabc_default_dv", "coefficients", "golomb", "dc_sign", "wht",
    "depth_8", "depth_10", "depth_12", "monochrome",
    "sequence_header_full", "sequence_header_reduced", "frame_edge", "grid",
    "alpha_item", "lossy", "chroma_420", "quantizer_matrix", "delta_q",
    "tx_mode_select", "tx_mode_largest", "tx_depth",
    "tx_4", "tx_8", "tx_16", "tx_32", "tx_64", "tx_rect", "tx_rect_4",
    "dct", "adst", "identity", "tx_type_set_intra_1", "tx_type_set_intra_2",
    "eob_long", "deblock", "deblock_14", "deblock_6", "deblock_8",
    "deblock_4", "cdef", "lr_wiener", "lr_sgrproj",
    "lr_switchable", "bt601", "chroma_upsample", "var_tx", "tx_type_inter",
    "intrabc_subpel", "tiles", "chroma_422", "lossy_444",
    "lossless_subsampled", "limited_range", "bt709", "bt2020"};
std::atomic<long> g_tally[kToolCount];
thread_local bool t_tally = true;

void corrupt(const std::string& msg) { throw Failure{kCorrupt, msg}; }

void not_ported(const std::string& what) {
  throw Failure{kUnsupported, "AVIF (cv2 reads it): " + what + ": not ported"};
}

// ------------------------------------------------------------ bit reader

uint32_t BitReader::f(int bits) {
  uint32_t v = 0;
  for (int i = 0; i < bits; i++) {
    if (pos_ >= n_ * 8) corrupt("AV1 header runs past its OBU");
    v = (v << 1) | ((d_[pos_ >> 3] >> (7 - (pos_ & 7))) & 1);
    pos_++;
  }
  return v;
}

int64_t BitReader::su(int bits) {
  const int64_t v = f(bits);
  const int64_t sign = int64_t(1) << (bits - 1);
  return (v & sign) ? v - 2 * sign : v;
}

uint32_t BitReader::ns(uint32_t n) {
  int w = 0;
  for (uint32_t x = n; x; x >>= 1) w++;
  const uint32_t m = (1u << w) - n;
  const uint32_t v = f(w - 1);
  if (v < m) return v;
  return (v << 1) - m + f(1);
}

uint64_t BitReader::leb128() {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) {
    const uint32_t b = f(8);
    v |= uint64_t(b & 0x7f) << (i * 7);
    if (!(b & 0x80)) return v;
  }
  return v;
}

uint32_t BitReader::uvlc() {
  int zeros = 0;
  while (!f(1)) {
    if (++zeros >= 32) return 0xFFFFFFFFu;
  }
  return zeros ? f(zeros) + ((1u << zeros) - 1) : 0;
}

// ------------------------------------------------------------ symbols

int SymbolReader::bit() {
  if (pos_ >= nbits_) {
    pos_++;
    return 0;
  }
  const int b = (d_[pos_ >> 3] >> (7 - (pos_ & 7))) & 1;
  pos_++;
  return b;
}

void SymbolReader::init(const uint8_t* d, long size, bool disable_update) {
  d_ = d;
  nbits_ = size * 8;
  pos_ = 0;
  const int num = static_cast<int>(size * 8 < 15 ? size * 8 : 15);
  uint32_t buf = 0;
  for (int i = 0; i < num; i++) buf = (buf << 1) | bit();
  value_ = ((1u << 15) - 1) ^ (buf << (15 - num));
  range_ = 1u << 15;
  max_bits_ = 8 * size - 15;
  no_update_ = disable_update;
}

int SymbolReader::symbol(uint16_t* icdf, int n) {
  // icdf[i] = 32768 - cdf[i]: f of 8.2.6 read directly
  uint32_t cur = range_, prev;
  int s = -1;
  do {
    s++;
    prev = cur;
    const uint32_t f = icdf[s];
    cur = ((range_ >> 8) * (f >> 6) >> 1) + 4 * (n - s - 1);
  } while (value_ < cur);
  range_ = prev - cur;
  value_ -= cur;
  int bits = 0;
  while ((range_ << bits) < (1u << 15)) bits++;
  range_ <<= bits;
  const long avail = max_bits_ > 0 ? max_bits_ : 0;
  const int num = static_cast<int>(bits < avail ? bits : avail);
  uint32_t data = 0;
  for (int i = 0; i < num; i++) data = (data << 1) | bit();
  value_ = (data << (bits - num)) ^ (((value_ + 1) << bits) - 1);
  max_bits_ -= bits;
  if (!no_update_) {
    const int rate = 3 + (icdf[n] > 15) + (icdf[n] > 31) + (n > 3 ? 2 : 1);
    for (int i = 0; i < n - 1; i++) {
      // in the inverted form: cdf[i] moves toward 32768 below the symbol
      if (i < s)
        icdf[i] += (32768 - icdf[i]) >> rate;
      else
        icdf[i] -= icdf[i] >> rate;
    }
    icdf[n] += icdf[n] < 32;
  }
  return s;
}

int SymbolReader::boolean() {
  uint16_t icdf[3] = {1 << 14, 0, 0};
  const bool keep = no_update_;
  no_update_ = true;
  const int b = symbol(icdf, 2);
  no_update_ = keep;
  return b;
}

int SymbolReader::literal(int bits) {
  int x = 0;
  for (int i = 0; i < bits; i++) x = 2 * x + boolean();
  return x;
}

int SymbolReader::ns(int n) {
  int w = 0;
  for (int x = n; x; x >>= 1) w++;
  const int m = (1 << w) - n;
  const int v = literal(w - 1);
  if (v < m) return v;
  return (v << 1) - m + literal(1);
}

// ------------------------------------------------------------ writer

namespace {

int ilog_nz(unsigned x) {  // OD_ILOG_NZ: 1 + floor(log2 x)
  int n = 0;
  while (x) {
    n++;
    x >>= 1;
  }
  return n;
}

// 256 * (15 - log2 p) for p in 1 .. 32768, log2 by repeated squaring in
// integers (the same bits on every machine)
struct CostTable {
  int v[32769];
  CostTable() {
    v[0] = 15 << 8;
    for (int p = 1; p <= 32768; p++) {
      const int k = ilog_nz(static_cast<unsigned>(p)) - 1;
      uint64_t x = static_cast<uint64_t>(p) << (16 - k);  // [1, 2) in Q16
      int frac = 0;
      for (int i = 0; i < 8; i++) {
        x = (x * x) >> 16;
        frac <<= 1;
        if (x >= (1u << 17)) {
          x >>= 1;
          frac |= 1;
        }
      }
      v[p] = (15 << 8) - ((k << 8) | frac);
    }
  }
};

}  // namespace

int symbol_cost(int p) {
  static const CostTable table;
  return table.v[std::min(std::max(p, 1), 32768)];
}

void SymbolWriter::init(bool disable_update, bool counting) {
  pre_.clear();
  low_ = 0;
  rng_ = 0x8000;
  cnt_ = -9;
  no_update_ = disable_update;
  counting_ = counting;
  cost_ = 0;
}

// od_ec_enc_normalize
void SymbolWriter::normalize(uint64_t low, unsigned rng) {
  const int d = 16 - ilog_nz(rng);
  int c = cnt_;
  int s = c + d;
  if (s >= 0) {
    c += 16;
    uint64_t m = (uint64_t{1} << c) - 1;
    if (s >= 8) {
      pre_.push_back(static_cast<uint16_t>(low >> c));
      low &= m;
      c -= 8;
      m >>= 8;
    }
    pre_.push_back(static_cast<uint16_t>(low >> c));
    s = c + d - 24;
    low &= m;
  }
  low_ = low << d;
  rng_ = rng << d;
  cnt_ = s;
}

// od_ec_encode_q15: fl and fh the inverted CDF at the symbol's ends
void SymbolWriter::encode(unsigned fl, unsigned fh, int s, int n) {
  uint64_t l = low_;
  unsigned r = rng_;
  const int last = n - 1;
  if (fl < 32768) {
    const unsigned u = ((r >> 8) * (fl >> 6) >> 1) + 4 * (last - (s - 1));
    const unsigned v = ((r >> 8) * (fh >> 6) >> 1) + 4 * (last - s);
    l += r - u;
    r = u - v;
  } else {
    r -= ((r >> 8) * (fh >> 6) >> 1) + 4 * (last - s);
  }
  normalize(l, r);
}

void SymbolWriter::symbol(uint16_t* icdf, int n, int s) {
  const unsigned fl = s > 0 ? icdf[s - 1] : 32768u, fh = icdf[s];
  if (counting_) {
    cost_ += symbol_cost(static_cast<int>(fl - fh));
    return;
  }
  encode(fl, fh, s, n);
  if (!no_update_) {  // as SymbolReader::symbol adapts
    const int rate = 3 + (icdf[n] > 15) + (icdf[n] > 31) + (n > 3 ? 2 : 1);
    for (int i = 0; i < n - 1; i++) {
      if (i < s)
        icdf[i] += (32768 - icdf[i]) >> rate;
      else
        icdf[i] -= icdf[i] >> rate;
    }
    icdf[n] += icdf[n] < 32;
  }
}

void SymbolWriter::boolean(int b) {
  if (counting_) {
    cost_ += 256;
    return;
  }
  encode(b ? 1u << 14 : 32768u, b ? 0u : 1u << 14, b, 2);
}

void SymbolWriter::literal(int bits, int v) {
  for (int i = bits - 1; i >= 0; i--) boolean((v >> i) & 1);
}

void SymbolWriter::ns(int n, int v) {
  int w = 0;
  for (int x = n; x; x >>= 1) w++;
  const int m = (1 << w) - n;
  if (v < m) {
    literal(w - 1, v);
  } else {
    literal(w - 1, (v + m) >> 1);
    literal(1, (v + m) & 1);
  }
}

// od_ec_enc_done: the fewest bits that decode to the symbols whatever
// follows, then the carries propagated
std::vector<uint8_t> SymbolWriter::finish() {
  uint64_t e = ((low_ + 0x3FFF) & ~uint64_t{0x3FFF}) | 0x4000;
  int c = cnt_;
  int s = 10 + c;
  if (s > 0) {
    uint64_t m = (uint64_t{1} << (c + 16)) - 1;
    do {
      pre_.push_back(static_cast<uint16_t>(e >> (c + 16)));
      e &= m;
      s -= 8;
      c -= 8;
      m >>= 8;
    } while (s > 0);
  }
  std::vector<uint8_t> out(pre_.size());
  unsigned carry = 0;
  for (size_t i = pre_.size(); i-- > 0;) {
    carry += pre_[i];
    out[i] = static_cast<uint8_t>(carry);
    carry >>= 8;
  }
  return out;
}

// ------------------------------------------------------------ CDFs

void init_cdfs(Cdfs* c, int base_q_idx) {
  const int q = base_q_idx <= 20 ? 0 : base_q_idx <= 60 ? 1
                : base_q_idx <= 120 ? 2 : 3;
#define COPY(dst, src) \
  static_assert(sizeof(dst) == sizeof(src), #src); \
  std::memcpy(dst, src, sizeof(dst))
  COPY(c->kf_y_mode, kDefaultKfYModeCdf);
  COPY(c->uv_mode_cfl_not_allowed, kDefaultUvModeCflNotAllowedCdf);
  COPY(c->uv_mode_cfl_allowed, kDefaultUvModeCflAllowedCdf);
  COPY(c->partition, kDefaultPartitionCdf);
  COPY(c->angle_delta, kDefaultAngleDeltaCdf);
  COPY(c->skip, kDefaultSkipCdf);
  COPY(c->intrabc, kDefaultIntrabcCdf);
  COPY(c->filter_intra, kDefaultFilterIntraCdf);
  COPY(c->filter_intra_mode, kDefaultFilterIntraModeCdf);
  COPY(c->cfl_sign, kDefaultCflSignCdf);
  COPY(c->cfl_alpha, kDefaultCflAlphaCdf);
  COPY(c->palette_y_mode, kDefaultPaletteYModeCdf);
  COPY(c->palette_uv_mode, kDefaultPaletteUvModeCdf);
  COPY(c->palette_y_size, kDefaultPaletteYSizeCdf);
  COPY(c->palette_uv_size, kDefaultPaletteUvSizeCdf);
  COPY(c->palette_y_color, kDefaultPaletteYColorCdf);
  COPY(c->palette_uv_color, kDefaultPaletteUvColorCdf);
  static_assert(sizeof(MvCdfs) == sizeof(kDefaultMvCdf), "nmv context");
  std::memcpy(&c->mv[0], kDefaultMvCdf, sizeof(MvCdfs));
  std::memcpy(&c->mv[1], kDefaultMvCdf, sizeof(MvCdfs));
  COPY(c->txb_skip, kDefaultTxbSkipCdf[q]);
  COPY(c->eob_extra, kDefaultEobExtraCdf[q]);
  COPY(c->dc_sign, kDefaultDcSignCdf[q]);
  COPY(c->eob_pt_16, kDefaultEobPt16Cdf[q]);
  COPY(c->coeff_base_eob, kDefaultCoeffBaseEobCdf[q]);
  COPY(c->coeff_base, kDefaultCoeffBaseCdf[q]);
  COPY(c->coeff_br, kDefaultCoeffBrCdf[q]);
  COPY(c->eob_pt_32, kDefaultEobPt32Cdf[q]);
  COPY(c->eob_pt_64, kDefaultEobPt64Cdf[q]);
  COPY(c->eob_pt_128, kDefaultEobPt128Cdf[q]);
  COPY(c->eob_pt_256, kDefaultEobPt256Cdf[q]);
  COPY(c->eob_pt_512, kDefaultEobPt512Cdf[q]);
  COPY(c->eob_pt_1024, kDefaultEobPt1024Cdf[q]);
  COPY(c->tx_size, kDefaultTxSizeCdf);
  COPY(c->delta_q, kDefaultDeltaQCdf);
  COPY(c->intra_ext_tx, kDefaultIntraExtTxCdf);
  COPY(c->inter_ext_tx, kDefaultInterExtTxCdf);
  COPY(c->txfm_split, kDefaultTxfmSplitCdf);
  COPY(c->switchable_restore, kDefaultSwitchableRestoreCdf);
  COPY(c->wiener_restore, kDefaultWienerRestoreCdf);
  COPY(c->sgrproj_restore, kDefaultSgrprojRestoreCdf);
#undef COPY
}

}  // namespace av1
}  // namespace sdt
