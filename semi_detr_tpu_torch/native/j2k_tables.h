// Tables shared by the JPEG 2000 decoder (j2k_host.cpp) and encoder
// (j2k_encode_host.cpp): the MQ coder's 47 states (Table C.2), the 19
// contexts of tier-1 and the context of each neighbourhood (Tables D.1 to
// D.3, with OpenJPEG's H / V swap for the HL band).
#pragma once

#include <algorithm>
#include <cstdint>
#include <utility>

namespace sdt {
namespace j2k {

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

inline constexpr MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

inline constexpr int kCtxZc = 0, kCtxSc = 9, kCtxMag = 14, kCtxAgg = 17,
              kCtxUni = 18;

// per-sample state of a code-block being coded: the sample's own bits,
// then which of its eight neighbours are significant and the signs of the
// four it shares an edge with (kept up to date as samples turn
// significant, as t1.c's flags are)
inline constexpr uint32_t kSig = 1, kVisited = 2, kRefined = 4, kNeg = 8;
inline constexpr uint32_t kW = 1 << 4, kE = 1 << 5, kN = 1 << 6, kS = 1 << 7,
                   kNW = 1 << 8, kNE = 1 << 9, kSW = 1 << 10, kSE = 1 << 11;
inline constexpr uint32_t kWNeg = 1 << 12, kENeg = 1 << 13, kNNeg = 1 << 14,
                   kSNeg = 1 << 15;
inline constexpr uint32_t kNeighbours = 0xFF0;
// under VSC the last row of a stripe does not look at the stripe below
inline constexpr uint32_t kBelow = kS | kSW | kSE | kSNeg;

struct Luts {  // contexts by neighbourhood (Tables D.1 and D.3)
  uint8_t zc[4][256];     // by orientation and bits 4-11
  uint8_t sc[256], xr[256];  // by bits 4-7 and 12-15
  Luts() {
    for (int o = 0; o < 4; ++o)
      for (int f = 0; f < 256; ++f) {
        int hh = (f & 1) + ((f >> 1) & 1), vv = ((f >> 2) & 1) + ((f >> 3) & 1);
        const int dd = ((f >> 4) & 1) + ((f >> 5) & 1) + ((f >> 6) & 1) +
                       ((f >> 7) & 1);
        int n;
        if (o == 3) {
          const int hv = hh + vv;
          if (!dd) n = hv == 0 ? 0 : hv == 1 ? 1 : 2;
          else if (dd == 1) n = hv == 0 ? 3 : hv == 1 ? 4 : 5;
          else if (dd == 2) n = hv == 0 ? 6 : 7;
          else n = 8;
        } else {
          if (o == 1) std::swap(hh, vv);
          if (!hh) n = !vv ? (dd == 0 ? 0 : dd == 1 ? 1 : 2) : vv == 1 ? 3 : 4;
          else if (hh == 1) n = vv ? 7 : dd ? 6 : 5;
          else n = 8;
        }
        zc[o][f] = static_cast<uint8_t>(kCtxZc + n);
      }
    for (int f = 0; f < 256; ++f) {  // f: W E N S significant, then signs
      auto c = [&](int sig_bit, int neg_bit) {
        return ((f >> sig_bit) & 1) ? (((f >> neg_bit) & 1) ? -1 : 1) : 0;
      };
      int hc = std::clamp(c(0, 4) + c(1, 5), -1, 1);
      int vc = std::clamp(c(2, 6) + c(3, 7), -1, 1);
      xr[f] = (hc < 0 || (hc == 0 && vc < 0)) ? 1 : 0;
      if (hc < 0) {
        hc = -hc;
        vc = -vc;
      }
      sc[f] = static_cast<uint8_t>(
          !hc ? kCtxSc + (vc ? 1 : 0)
              : kCtxSc + (vc < 0 ? 2 : vc == 0 ? 3 : 4));
    }
  }
};
inline const Luts kLuts;

}  // namespace j2k
}  // namespace sdt
