// The state of one tile's decode, shared by av1_intra.cpp (the syntax:
// partitions, mode info, palette, intra block copy, transform sizes and
// types, coefficients), av1_recon.cpp (prediction), av1_transform.cpp
// (dequantisation and the inverse transforms) and the in-loop filters
// (av1_loopfilter.cpp, av1_cdef.cpp, av1_restoration.cpp).
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
  uint8_t tx_size = 0;  // TxSizes (InterTxSizes of an intra block)
  uint8_t palette_size[2] = {0, 0};
  int16_t mv[2] = {0, 0};  // an intra block copy's vector, row and column
  uint16_t palette[2][8] = {};
};

// a loop restoration unit's filter (5.11.57-58)
struct LrUnit {
  int type = RESTORE_NONE;
  int wiener[2][3] = {};  // vertical, horizontal taps 0-2
  int sgr_set = 0;
  int sgr_xqd[2] = {};
};

struct State {
  const SequenceHeader* seq = nullptr;
  const FrameHeader* fh = nullptr;
  int mi_rows = 0, mi_cols = 0, planes = 3, bit_depth = 8;
  int ssx = 0, ssy = 0;  // the chroma planes' subsampling
  int sb_size = BLOCK_64X64, sb4 = 16;
  std::vector<MiInfo> mi;
  MiInfo& at(int r, int c) { return mi[static_cast<size_t>(r) * mi_cols + c]; }

  // CurrFrame: each plane stride x rows samples, covering every superblock
  int stride[3] = {0, 0, 0}, rows[3] = {0, 0, 0};
  std::vector<uint16_t> frame[3];
  uint16_t* px(int plane, int y, int x) {
    return frame[plane].data() + static_cast<size_t>(y) * stride[plane] + x;
  }
  int sub_x(int plane) const { return plane ? ssx : 0; }
  int sub_y(int plane) const { return plane ? ssy : 0; }

  // the coefficient contexts (AboveLevelContext ... LeftDcContext), in 4x4
  // units of each plane
  std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];
  // BlockDecoded of the superblock, indices offset by one for the -1 row
  // and column
  uint8_t block_decoded[3][34][34] = {};
  bool decoded(int plane, int y4, int x4) {
    return block_decoded[plane][y4 + 1][x4 + 1];
  }
  // per 4x4 unit of each plane, the transform size that covers it (the
  // loop filter's LoopfilterTxSizes); per 4x4 luma unit, its TxTypes
  int lf_cols[3] = {0, 0, 0};
  std::vector<uint8_t> lf_tx[3];
  std::vector<uint8_t> tx_types;
  // cdef_idx of each 64x64 (-1: no block in it is coded)
  int cdef_cols = 0;
  std::vector<int8_t> cdef_idx;
  // the loop restoration units of each plane
  int lr_cols[3] = {0, 0, 0}, lr_rows[3] = {0, 0, 0};
  std::vector<LrUnit> lr[3];
  int ref_lr_wiener[3][2][3] = {}, ref_sgr_xqd[3][2] = {};

  SymbolReader sr;
  Cdfs cdf;

  // the block being decoded
  int mi_row = 0, mi_col = 0, mi_size = 0;
  bool has_chroma = false, avail_u = false, avail_l = false;
  bool avail_u_chroma = false, avail_l_chroma = false;
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
  int tx_size = TX_4X4;           // TxSize of the block (luma)
  bool var_tx = false;            // its sizes a transform tree's (per 4x4)
  int current_qindex = 0;         // CurrentQIndex
  bool read_deltas = false;       // ReadDeltas
  int plane_tx_type = DCT_DCT;    // PlaneTxType of the transform block

  bool inside(int r, int c) const {
    return c >= mi_col_start && c < mi_col_end && r >= mi_row_start &&
           r < mi_row_end;
  }
};

// av1_recon.cpp
// 7.11.2: the intra prediction of a transform block of 2^log2w x 2^log2h
// samples at (x, y) of a plane
void predict_intra(State& s, int plane, int x, int y, bool have_left,
                   bool have_above, bool have_above_rt, bool have_below_lft,
                   int mode, int log2w, int log2h);
// 7.11.4: palette prediction of a transform block
void predict_palette(State& s, int plane, int start_x, int start_y, int x,
                     int y, int tx);
// 7.11.5: chroma from luma over the DC prediction of a transform block
void predict_cfl(State& s, int plane, int start_x, int start_y, int tx);
// 7.11.3 for an intra block copy: the block copied from the current frame
void predict_intrabc(State& s);

// av1_transform.cpp
// 7.12.3 and 7.13.3: the coefficients of a transform block (positions of
// the specification: row * min(32, width) + column) dequantised, turned
// back by the block's inverse transform and added to the prediction; the
// 4x4 Walsh-Hadamard transform in a lossless frame
void reconstruct(State& s, int plane, int x, int y, int tx, int32_t* quant);

// the in-loop filters, in place on the frame: av1_loopfilter.cpp (7.14),
// av1_cdef.cpp (7.15), av1_restoration.cpp (7.17, which takes the frame
// before CDEF for the rows above and below each stripe)
void deblock_frame(State& s);
void cdef_frame(State& s);
void restore_frame(State& s, const std::vector<uint16_t>* deblocked);

}  // namespace av1
}  // namespace sdt
