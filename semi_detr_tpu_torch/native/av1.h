// Declarations shared by the host library's AV1 still-picture decoder:
// av1_obu.cpp (OBU framing, sequence and frame headers), av1_entropy.cpp
// (the symbol decoder and its CDFs), av1_intra.cpp (partitions, mode info,
// palette, intra block copy, transform sizes and types, coefficients),
// av1_recon.cpp (prediction), av1_transform.cpp (dequantisation and the
// inverse transforms), av1_loopfilter.cpp (deblocking), av1_cdef.cpp
// (CDEF), av1_restoration.cpp (loop restoration) and avif_host.cpp (the
// AVIF container), and the encoder that writes a key frame through the
// same syntax (av1_encode.cpp, with avif_encode_host.cpp). Section numbers
// are those of the AV1 Bitstream & Decoding Process Specification; names
// follow it.
//
// Key frames of one tile or several are decoded, lossless or lossy, at 8,
// 10 and 12 bits: 4:4:4, 4:2:2, 4:2:0 or monochrome, with intra block copy
// in any of them. What no committed fixture reaches (segmentation, film
// grain, superres, delta loop filter levels) raises "AVIF (cv2 reads it):
// ... not ported".
#pragma once

#include <atomic>
#include <cstdint>
#include <string>
#include <vector>

namespace sdt {
namespace av1 {

// a decode that stops: status is sdt::kCorrupt (damage) or
// sdt::kUnsupported (a refusal); what() is the message
struct Failure {
  int status;
  std::string msg;
};
[[noreturn]] void corrupt(const std::string& msg);
// a valid stream using `what`, which this decoder refuses
[[noreturn]] void not_ported(const std::string& what);

// ------------------------------------------------------------ coverage

// The tools the decoder has decoded, counted per process (sdt_avif_tally).
enum Tool {
  kToolSb64, kToolSb128, kToolPartitionNone, kToolPartitionHorz,
  kToolPartitionVert, kToolPartitionSplit, kToolPartitionHorzA,
  kToolPartitionHorzB, kToolPartitionVertA, kToolPartitionVertB,
  kToolPartitionHorz4, kToolPartitionVert4, kToolSplitOrHorz,
  kToolSplitOrVert, kToolSkip, kToolDcPred, kToolVPred, kToolHPred,
  kToolDirectional, kToolAngleDelta, kToolEdgeFilter, kToolEdgeUpsample,
  kToolSmooth, kToolSmoothV, kToolSmoothH, kToolPaeth, kToolCfl,
  kToolFilterIntra, kToolPaletteY, kToolPaletteUV, kToolPaletteCache,
  kToolPaletteDeltaV, kToolIntrabc, kToolIntrabcDefaultDv,
  kToolCoefficients, kToolGolomb, kToolDcSign, kToolWht, kToolDepth8,
  kToolDepth10, kToolDepth12, kToolMonochrome, kToolSeqFull,
  kToolSeqReduced, kToolFrameEdge, kToolGrid, kToolAlphaItem,
  // lossy frames
  kToolLossy, kToolChroma420, kToolQmatrix, kToolDeltaQ, kToolTxModeSelect,
  kToolTxModeLargest, kToolTxDepth, kToolTx4, kToolTx8,
  kToolTx16, kToolTx32, kToolTx64, kToolTxRect, kToolTxRect4, kToolDct,
  kToolAdst, kToolIdentity, kToolTxTypeSet1, kToolTxTypeSet2,
  kToolEobLong, kToolDeblock, kToolDeblock14, kToolDeblock6, kToolDeblock8,
  kToolDeblock4, kToolCdef, kToolLrWiener, kToolLrSgrproj,
  kToolLrSwitchable, kToolBt601, kToolChromaUpsample, kToolVarTx,
  kToolTxTypeInter, kToolIntrabcSubpel,
  // several tiles, the other chroma layouts and colour descriptions
  kToolTiles, kToolChroma422, kToolLossy444, kToolLosslessSubsampled,
  kToolLimitedRange, kToolBt709, kToolBt2020,
  kToolCount
};
extern const char* const kToolNames[kToolCount];
extern std::atomic<long> g_tally[kToolCount];
// off on a thread while it encodes: the encoder runs the decoder's code,
// which counts nothing then
extern thread_local bool t_tally;
inline void count(Tool t) {
  if (t_tally) g_tally[t].fetch_add(1, std::memory_order_relaxed);
}

// ------------------------------------------------------------ bit reader

// MSB-first reads of the uncompressed headers (4.10)
class BitReader {
 public:
  BitReader(const uint8_t* d, long n) : d_(d), n_(n) {}
  uint32_t f(int bits);
  int64_t su(int bits);
  uint32_t ns(uint32_t n);
  uint64_t leb128();
  uint32_t uvlc();
  void byte_align() { pos_ = (pos_ + 7) & ~7L; }
  long bytes_read() const { return (pos_ + 7) >> 3; }

 private:
  const uint8_t* d_;
  long n_, pos_ = 0;
};

// ------------------------------------------------------------ headers

struct SequenceHeader {
  int profile = 0;
  bool reduced = false;
  int frame_width_bits = 0, frame_height_bits = 0;
  int max_width = 0, max_height = 0;
  bool frame_id_numbers = false;
  int frame_id_len = 0;
  bool sb128 = false, filter_intra = false, intra_edge_filter = false;
  int order_hint_bits = 0;
  int force_screen_content = 2, force_integer_mv = 2;
  bool superres = false, enable_cdef = false, enable_restoration = false;
  int bit_depth = 8;
  bool mono = false;
  int primaries = 2, matrix = 2;
  bool full_range = false;
  int ssx = 0, ssy = 0;
  bool separate_uv_delta_q = false;
  bool film_grain = false;
};

enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };

struct FrameHeader {
  int width = 0, height = 0;
  int mi_cols = 0, mi_rows = 0;
  bool disable_cdf_update = false;
  bool screen_content = false, intrabc = false;
  // quantization_params (5.9.12): the deltas y dc, u dc, u ac, v dc, v ac
  int base_q_idx = 0;
  int delta_q[5] = {0, 0, 0, 0, 0};
  bool using_qmatrix = false;
  int qm[3] = {15, 15, 15};
  bool lossless = true;  // CodedLossless: no segmentation here
  bool delta_q_present = false;
  int delta_q_res = 0;
  // loop_filter_params (5.9.11)
  int lf_level[4] = {0, 0, 0, 0};
  int lf_sharpness = 0;
  bool lf_delta_enabled = false;
  int lf_ref_deltas[8] = {1, 0, 0, 0, -1, 0, -1, -1};
  int lf_mode_deltas[2] = {0, 0};
  // cdef_params (5.9.19)
  int cdef_damping = 3, cdef_bits = 0;
  int cdef_y_pri[8] = {}, cdef_y_sec[8] = {}, cdef_uv_pri[8] = {},
      cdef_uv_sec[8] = {};
  bool cdef = false;  // CDEF runs: enabled, not lossless, no intra bc
  // lr_params (5.9.20): FrameRestorationType and LoopRestorationSize
  int lr_type[3] = {RESTORE_NONE, RESTORE_NONE, RESTORE_NONE};
  int lr_size[3] = {64, 64, 64};
  bool uses_lr = false;
  bool tx_mode_select = false;  // read_tx_mode: else TX_MODE_LARGEST (or
                                // ONLY_4X4 when lossless)
  bool reduced_tx_set = false;
  // tile_info (5.9.15): TileCols, TileRows and their log2, MiColStarts and
  // MiRowStarts (each with the frame's end last), context_update_tile_id
  // and TileSizeBytes
  int tile_cols = 1, tile_rows = 1, tile_cols_log2 = 0, tile_rows_log2 = 0;
  std::vector<int> mi_col_starts, mi_row_starts;
  int context_update_tile_id = 0, tile_size_bytes = 4;
};

// the bytes of one tile (5.11.1)
struct Tile {
  const uint8_t* data = nullptr;
  long size = 0;
};

// One AV1 still picture of an AVIF item: the OBUs (its av1C config OBUs
// first, then the item's data) parsed to headers and each tile's data, in
// tile order (raster order of the tile grid).
struct Picture {
  SequenceHeader seq;
  FrameHeader frame;
  std::vector<Tile> tiles;
};
// Parse a temporal unit (and the sequence header OBUs of av1C before it);
// refuses what the decoder does not decode, fails on damage.
void parse_obus(const uint8_t* config, long config_len, const uint8_t* data,
                long len, Picture* pic);

// ------------------------------------------------------------ entropy

// 8.2: the multi-symbol arithmetic decoder of one tile
class SymbolReader {
 public:
  void init(const uint8_t* d, long size, bool disable_update);
  // a symbol of n by the inverted CDF icdf[0..n-1], with icdf[n] its
  // adaptation counter
  int symbol(uint16_t* icdf, int n);
  int boolean();
  int literal(int bits);
  int ns(int n);
  // data read past the tile's end (exit_symbol's requirement)
  bool overrun() const { return max_bits_ < -14; }

 private:
  int bit();
  const uint8_t* d_ = nullptr;
  long nbits_ = 0, pos_ = 0;
  uint32_t value_ = 0, range_ = 0;
  long max_bits_ = 0;
  bool no_update_ = false;
};

// The inverse of SymbolReader (libaom's od_ec encoder): the same symbols,
// booleans and literals, the same CDF adaptation, and the end of the tile
// padded as libaom pads it (od_ec_enc_done). Counting, it writes nothing
// and leaves the CDFs as they are: cost() is the bits the symbols would
// take at the CDFs' present probabilities, in 1/256 bit.
class SymbolWriter {
 public:
  void init(bool disable_update, bool counting);
  void symbol(uint16_t* icdf, int n, int s);
  void boolean(int b);
  void literal(int bits, int v);
  void ns(int n, int v);
  // the tile's bytes (writing)
  std::vector<uint8_t> finish();
  int64_t cost() const { return cost_; }
  void reset_cost() { cost_ = 0; }

 private:
  void encode(unsigned fl, unsigned fh, int s, int n);
  void normalize(uint64_t low, unsigned rng);
  std::vector<uint16_t> pre_;  // precarry_buf: bytes before the carries
  uint64_t low_ = 0;
  unsigned rng_ = 0x8000;
  int cnt_ = -9;
  bool no_update_ = false, counting_ = false;
  int64_t cost_ = 0;
};

// The cost in 1/256 bit of a symbol of probability p / 32768
int symbol_cost(int p);

// The adaptive CDFs of a tile (the defaults of av1_tables.h, the
// coefficient ones at the frame's quantizer context).
struct MvCdfs {
  uint16_t joints[5];
  struct Comp {
    uint16_t classes[12];
    uint16_t class0_fp[2][5];
    uint16_t fp[5];
    uint16_t sign[3];
    uint16_t class0_hp[3];
    uint16_t hp[3];
    uint16_t class0[3];
    uint16_t bits[10][3];
  } comp[2];
};
struct Cdfs {
  uint16_t kf_y_mode[5][5][14];
  uint16_t uv_mode_cfl_not_allowed[13][15];
  uint16_t uv_mode_cfl_allowed[13][15];
  uint16_t partition[20][11];
  uint16_t angle_delta[8][8];
  uint16_t skip[3][3];
  uint16_t intrabc[3];
  uint16_t filter_intra[22][3];
  uint16_t filter_intra_mode[6];
  uint16_t cfl_sign[9];
  uint16_t cfl_alpha[6][17];
  uint16_t palette_y_mode[7][3][3];
  uint16_t palette_uv_mode[2][3];
  uint16_t palette_y_size[7][8];
  uint16_t palette_uv_size[7][8];
  uint16_t palette_y_color[7][5][9];
  uint16_t palette_uv_color[7][5][9];
  MvCdfs mv[2];
  uint16_t txb_skip[5][13][3];
  uint16_t eob_extra[5][2][9][3];
  uint16_t dc_sign[2][3][3];
  uint16_t eob_pt_16[2][2][6];
  uint16_t coeff_base_eob[5][2][4][4];
  uint16_t coeff_base[5][2][42][5];
  uint16_t coeff_br[5][2][21][5];
  uint16_t eob_pt_32[2][2][7];
  uint16_t eob_pt_64[2][2][8];
  uint16_t eob_pt_128[2][2][9];
  uint16_t eob_pt_256[2][2][10];
  uint16_t eob_pt_512[2][2][11];
  uint16_t eob_pt_1024[2][2][12];
  uint16_t tx_size[4][3][4];
  uint16_t delta_q[5];
  uint16_t intra_ext_tx[3][4][13][17];
  uint16_t inter_ext_tx[4][4][17];
  uint16_t txfm_split[21][3];
  uint16_t switchable_restore[4];
  uint16_t wiener_restore[3];
  uint16_t sgrproj_restore[3];
};
void init_cdfs(Cdfs* c, int base_q_idx);

// ------------------------------------------------------------ decode

// The planes of a decoded picture: 1 (monochrome) or 3 (Y, U, V; for the
// identity matrix G, B, R) at bit_depth, luma height x width samples, the
// chroma planes subsampled by ssx, ssy ((width + ssx) >> ssx wide).
struct Planes {
  int width = 0, height = 0, bit_depth = 8, count = 3, ssx = 0, ssy = 0;
  std::vector<uint16_t> plane[3];
};
// Decode the picture's tiles (av1_intra.cpp, with av1_recon.cpp and
// av1_transform.cpp), then the in-loop filters over the whole frame: deblocking, CDEF and loop
// restoration, each of which `filters` (a mask of kFilter*) may leave out
// (the stages are held apart to a conformant decoder's).
enum { kFilterDeblock = 1, kFilterCdef = 2, kFilterRestoration = 4,
       kFiltersAll = 7 };
void decode_picture(const Picture& pic, Planes* out, int filters = kFiltersAll);
// av1_encode.cpp: (h, w, 3) RGB -> the temporal unit of a key frame as
// cv2.imwrite's libavif writes one at its defaults (temporal delimiter,
// sequence header and frame OBUs), and the reconstruction (the decoder's
// planes of it) where recon is given
void encode_picture(const uint8_t* rgb, int h, int w, std::vector<uint8_t>* obus,
                    Planes* recon);

// ------------------------------------------------------------ constants

enum BlockSize {
  BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8,
  BLOCK_16X16, BLOCK_16X32, BLOCK_32X16, BLOCK_32X32, BLOCK_32X64,
  BLOCK_64X32, BLOCK_64X64, BLOCK_64X128, BLOCK_128X64, BLOCK_128X128,
  BLOCK_4X16, BLOCK_16X4, BLOCK_8X32, BLOCK_32X8, BLOCK_16X64, BLOCK_64X16,
  BLOCK_INVALID
};
enum Partition {
  PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT,
  PARTITION_HORZ_A, PARTITION_HORZ_B, PARTITION_VERT_A, PARTITION_VERT_B,
  PARTITION_HORZ_4, PARTITION_VERT_4
};
enum IntraMode {
  DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
  D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED,
  PAETH_PRED, UV_CFL_PRED
};
enum TxSize {
  TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, TX_8X16,
  TX_16X8, TX_16X32, TX_32X16, TX_32X64, TX_64X32, TX_4X16, TX_16X4,
  TX_8X32, TX_32X8, TX_16X64, TX_64X16
};
enum TxType {
  DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
  FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT,
  V_ADST, H_ADST, V_FLIPADST, H_FLIPADST
};
inline constexpr int kTxWidthLog2[19] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4, 5,
                                         5, 6, 2, 4, 3, 5, 4, 6};
inline constexpr int kTxHeightLog2[19] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5, 4,
                                          6, 5, 4, 2, 5, 3, 6, 4};

inline constexpr int kNum4x4W[22] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8,
                                     16, 16, 16, 32, 32, 1, 4, 2, 8, 4, 16};
inline constexpr int kNum4x4H[22] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16,
                                     8, 16, 32, 16, 32, 4, 1, 8, 2, 16, 4};
inline constexpr int kMiWidthLog2[22] = {0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3,
                                         4, 4, 4, 5, 5, 0, 2, 1, 3, 2, 4};
inline constexpr int kMiHeightLog2[22] = {0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 4,
                                          3, 4, 5, 4, 5, 2, 0, 3, 1, 4, 2};
// Partition_Subsize[partition][log2 of the square's width in 4x4 units:
// 4x4, 8, 16, 32, 64, 128]
inline constexpr int kSubsize[10][6] = {
    {BLOCK_4X4, BLOCK_8X8, BLOCK_16X16, BLOCK_32X32, BLOCK_64X64, BLOCK_128X128},
    {BLOCK_INVALID, BLOCK_8X4, BLOCK_16X8, BLOCK_32X16, BLOCK_64X32, BLOCK_128X64},
    {BLOCK_INVALID, BLOCK_4X8, BLOCK_8X16, BLOCK_16X32, BLOCK_32X64, BLOCK_64X128},
    {BLOCK_INVALID, BLOCK_4X4, BLOCK_8X8, BLOCK_16X16, BLOCK_32X32, BLOCK_64X64},
    {BLOCK_INVALID, BLOCK_8X4, BLOCK_16X8, BLOCK_32X16, BLOCK_64X32, BLOCK_128X64},
    {BLOCK_INVALID, BLOCK_8X4, BLOCK_16X8, BLOCK_32X16, BLOCK_64X32, BLOCK_128X64},
    {BLOCK_INVALID, BLOCK_4X8, BLOCK_8X16, BLOCK_16X32, BLOCK_32X64, BLOCK_64X128},
    {BLOCK_INVALID, BLOCK_4X8, BLOCK_8X16, BLOCK_16X32, BLOCK_32X64, BLOCK_64X128},
    {BLOCK_INVALID, BLOCK_INVALID, BLOCK_16X4, BLOCK_32X8, BLOCK_64X16, BLOCK_INVALID},
    {BLOCK_INVALID, BLOCK_INVALID, BLOCK_4X16, BLOCK_8X32, BLOCK_16X64, BLOCK_INVALID},
};
// Mode_To_Angle, Intra_Mode_Context (5.11.x)
inline constexpr int kModeToAngle[13] = {0, 90, 180, 45, 135, 113, 157, 203,
                                         67, 0, 0, 0, 0};
inline constexpr int kIntraModeContext[13] = {0, 1, 2, 3, 4, 4, 4, 4,
                                              3, 0, 1, 2, 0};

}  // namespace av1
}  // namespace sdt
