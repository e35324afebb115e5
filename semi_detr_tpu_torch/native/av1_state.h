// The state of one tile's decode, shared by av1_intra.cpp (the syntax:
// partitions, mode info, palette, intra block copy, coefficients) and
// av1_recon.cpp (prediction and reconstruction).
#pragma once

#include <cstdint>
#include <vector>

#include "av1.h"

namespace sdt {
namespace av1 {

// what the decode keeps of each 4x4 unit (mode info, 5.11.5's stores)
struct MiInfo {
  uint8_t size = 0, y_mode = 0, uv_mode = 0;
  uint8_t skip = 0, is_inter = 0, decoded = 0;
  uint8_t palette_size[2] = {0, 0};
  int16_t mv[2] = {0, 0};  // an intra block copy's vector, row and column
  uint16_t palette[2][8] = {};
};

struct State {
  const SequenceHeader* seq = nullptr;
  const FrameHeader* fh = nullptr;
  int mi_rows = 0, mi_cols = 0, planes = 3, bit_depth = 8;
  int sb_size = BLOCK_64X64, sb4 = 16;
  std::vector<MiInfo> mi;
  MiInfo& at(int r, int c) { return mi[static_cast<size_t>(r) * mi_cols + c]; }

  // CurrFrame: each plane stride x rows samples, covering every superblock
  int stride = 0, rows = 0;
  std::vector<uint16_t> frame[3];
  uint16_t* px(int plane, int y, int x) {
    return frame[plane].data() + static_cast<size_t>(y) * stride + x;
  }

  // the coefficient contexts (AboveLevelContext ... LeftDcContext), in 4x4
  // units of the frame
  std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];
  // BlockDecoded of the superblock, indices offset by one for the -1 row
  // and column
  uint8_t block_decoded[3][34][34] = {};
  bool decoded(int plane, int y4, int x4) {
    return block_decoded[plane][y4 + 1][x4 + 1];
  }

  SymbolReader sr;
  Cdfs cdf;

  // the block being decoded
  int mi_row = 0, mi_col = 0, mi_size = 0;
  bool has_chroma = false, avail_u = false, avail_l = false;
  bool skip = false, is_inter = false;  // is_inter: an intra block copy
  int y_mode = 0, uv_mode = 0, angle_y = 0, angle_uv = 0;
  bool use_filter_intra = false;
  int filter_intra_mode = 0;
  int cfl_alpha_u = 0, cfl_alpha_v = 0;
  int palette_size_y = 0, palette_size_uv = 0;
  uint16_t palette[3][8] = {};
  uint8_t color_map_y[64][64] = {}, color_map_uv[64][64] = {};
  int mv[2] = {0, 0};
  int max_luma_w = 0, max_luma_h = 0;
  int mi_row_start = 0, mi_row_end = 0, mi_col_start = 0, mi_col_end = 0;

  bool inside(int r, int c) const {
    return c >= mi_col_start && c < mi_col_end && r >= mi_row_start &&
           r < mi_row_end;
  }
};

// av1_recon.cpp
// 7.11.2: the prediction of one 4x4 transform block at (x, y) of a plane
void predict_intra(State& s, int plane, int x, int y, bool have_left,
                   bool have_above, bool have_above_rt, bool have_below_lft,
                   int mode);
// 7.11.4: palette prediction of a 4x4 transform block
void predict_palette(State& s, int plane, int start_x, int start_y, int x,
                     int y);
// 7.11.5: chroma from luma over the DC prediction of a 4x4 block
void predict_cfl(State& s, int plane, int start_x, int start_y);
// 7.11.3 for an intra block copy: the block copied from the current frame
void predict_intrabc(State& s);
// 7.12.3 and 7.13.3 lossless: the 4x4 coefficients dequantised and turned
// back by the Walsh-Hadamard transform, added to the prediction
void reconstruct(State& s, int plane, int x, int y, const int32_t* quant);

}  // namespace av1
}  // namespace sdt
