// The state of a frame's decode, tile by tile, shared by av1_intra.cpp (the syntax:
// partitions, mode info, palette, intra block copy, transform sizes and
// types, coefficients), av1_recon.cpp (prediction), av1_transform.cpp
// (dequantisation and the inverse transforms) and the in-loop filters
// (av1_loopfilter.cpp, av1_cdef.cpp, av1_restoration.cpp). The encoder
// (av1_encode.cpp) runs the same tile syntax with a SymbolWriter in place
// of the reader and its decisions given by an Encoder, so that what it
// reconstructs is the decoder's reconstruction.
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

struct State;

// The encoder's decisions, asked for where the decoder reads them.
struct Encoder {
  virtual ~Encoder() = default;
  // the partition of the square block at (r, c) (PARTITION_SPLIT where
  // neither half lies in the frame)
  virtual int partition(State& s, int r, int c, int bsize) = 0;
  // the block's mode info, into s: skip, y_mode, angle_y, uv_mode (no
  // CFL), angle_uv, use_filter_intra and filter_intra_mode
  virtual void mode_info(State& s) = 0;
  // the quantized coefficients (positions of the specification) of a
  // transform block from the source less the prediction in s.frame, of
  // type `type` (a chroma block's), or of the type it returns (luma, -1)
  virtual int quantize(State& s, int plane, int x, int y, int tx, int type,
                       int32_t* coef) = 0;
  // the qindex of the superblock at (r, c), a multiple of 2^delta_q_res
  // from base_q_idx
  virtual int superblock_qindex(State& s, int r, int c) = 0;
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
  // encoding: the symbols written (or counted) and the decisions
  SymbolWriter* sw = nullptr;
  Encoder* enc = nullptr;

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

// av1_intra.cpp: the tile syntax, for the encoder too
// the state of the frame the headers describe, before its first tile;
// then the tile of that number (raster order) starts: its bounds, the
// CDFs at the frame's quantizer, the above contexts cleared
void init_frame(State& s, const SequenceHeader& seq, const FrameHeader& fh);
void start_tile(State& s, int tile);
// a row of superblocks starts (the left contexts cleared), a superblock
// starts (its BlockDecoded), and one is coded whole
void start_sb_row(State& s);
void start_superblock(State& s, int r, int c);
void code_partition(State& s, int r, int c, int bsize);
// the in-loop filters of kFilter* over the frame, and its planes
void filter_frame(State& s, int filters);
void take_planes(State& s, Planes* out);
// the block state decode_block sets before its mode info (position, size,
// chroma, availability), and a transform block's intra prediction of
// `mode` as transform_block makes it (luma or chroma at 4:2:0, the one
// transform block of each plane of a block of TX_MODE_LARGEST)
void setup_block(State& s, int r, int c, int size);
void predict_transform_block(State& s, int plane, int tx, int mode);
// the transform size of a block's plane (get_tx_size), the CDF of the
// partition symbol of a square block with both halves in the frame (its
// symbol count in *n)
int plane_tx_size(const State& s, int plane);
uint16_t* partition_cdf(State& s, int r, int c, int bsize, int* n);

// av1_transform.cpp
// the one-dimensional inverse transform of n points (0 DCT, 1 ADST, 3
// identity) as reconstruct runs it
void inverse_1d(int kind, const int32_t* in, int32_t* out, int n);
// the dequantiser of a transform block (7.12.3): each coefficient
// position's quantizer (the matrix weight applied) in steps (min(32, w) x
// min(32, h)), and the shift of the product
void quantizer_steps(const State& s, int plane, int tx, int type, int* steps,
                     int* shift);
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
