// AV1 OBUs (5.3), the sequence header (5.5) and the uncompressed header of
// a key frame (5.9) up to the tile group (5.11.1), for one still picture:
// the quantizer with its matrices and per-superblock deltas, the loop
// filter, CDEF and loop restoration parameters, the transform mode. What
// no committed fixture reaches (another frame type, superres, film grain,
// segmentation, delta loop filter levels) is refused, each naming itself.
// The tile groups of a frame OBU, or of tile group OBUs after a frame
// header OBU, give each tile's data.
#include <algorithm>
#include <string>
#include <vector>

#include "av1.h"

namespace sdt {
namespace av1 {

namespace {

void sequence_header(BitReader& r, SequenceHeader* s) {
  s->profile = r.f(3);
  if (s->profile > 2) corrupt("AV1 sequence header: seq_profile " +
                              std::to_string(s->profile));
  const bool still_picture = r.f(1);
  s->reduced = r.f(1);
  if (s->reduced) {
    if (!still_picture)
      corrupt("AV1 sequence header: a reduced header that is not a still "
              "picture");
    r.f(5);  // seq_level_idx[0]
  } else {
    if (r.f(1)) {  // timing_info_present_flag
      r.f(32);     // num_units_in_display_tick
      r.f(32);     // time_scale
      if (r.f(1)) r.uvlc();  // equal_picture_interval
      if (r.f(1)) not_ported("AV1 decoder model info");
    }
    const bool initial_display_delay = r.f(1);
    const int op_count = r.f(5) + 1;
    int op_idc0 = 0;
    for (int i = 0; i < op_count; i++) {
      const int idc = r.f(12);
      if (i == 0) op_idc0 = idc;
      if (r.f(5) > 7) r.f(1);  // seq_level_idx, seq_tier
      if (initial_display_delay && r.f(1)) r.f(4);
    }
    if (op_idc0 != 0) not_ported("layered (scalable) AV1");
  }
  s->frame_width_bits = r.f(4) + 1;
  s->frame_height_bits = r.f(4) + 1;
  s->max_width = r.f(s->frame_width_bits) + 1;
  s->max_height = r.f(s->frame_height_bits) + 1;
  if (!s->reduced) s->frame_id_numbers = r.f(1);
  if (s->frame_id_numbers) {
    const int delta = r.f(4) + 2;
    s->frame_id_len = r.f(3) + delta + 1;
  }
  s->sb128 = r.f(1);
  s->filter_intra = r.f(1);
  s->intra_edge_filter = r.f(1);
  if (!s->reduced) {
    r.f(1);  // enable_interintra_compound
    r.f(1);  // enable_masked_compound
    r.f(1);  // enable_warped_motion
    r.f(1);  // enable_dual_filter
    const bool order_hint = r.f(1);
    if (order_hint) {
      r.f(1);  // enable_jnt_comp
      r.f(1);  // enable_ref_frame_mvs
    }
    s->force_screen_content = r.f(1) ? 2 : static_cast<int>(r.f(1));
    if (s->force_screen_content > 0)
      s->force_integer_mv = r.f(1) ? 2 : static_cast<int>(r.f(1));
    else
      s->force_integer_mv = 2;
    if (order_hint) s->order_hint_bits = r.f(3) + 1;
  }
  s->superres = r.f(1);
  s->enable_cdef = r.f(1);
  s->enable_restoration = r.f(1);
  // color_config (5.5.2)
  const bool high = r.f(1);
  if (s->profile == 2 && high)
    s->bit_depth = r.f(1) ? 12 : 10;
  else
    s->bit_depth = high ? 10 : 8;
  s->mono = s->profile == 1 ? false : static_cast<bool>(r.f(1));
  int& primaries = s->primaries;
  int transfer = 2;
  if (r.f(1)) {
    primaries = r.f(8);
    transfer = r.f(8);
    s->matrix = r.f(8);
  }
  if (s->mono) {
    s->full_range = r.f(1);
    s->ssx = s->ssy = 1;
    s->separate_uv_delta_q = false;
  } else {
    if (primaries == 1 && transfer == 13 && s->matrix == 0) {
      s->full_range = true;
      s->ssx = s->ssy = 0;
    } else {
      s->full_range = r.f(1);
      if (s->profile == 0) {
        s->ssx = s->ssy = 1;
      } else if (s->profile == 1) {
        s->ssx = s->ssy = 0;
      } else if (s->bit_depth == 12) {
        s->ssx = r.f(1);
        s->ssy = s->ssx ? static_cast<int>(r.f(1)) : 0;
      } else {
        s->ssx = 1;
        s->ssy = 0;
      }
      if (s->ssx && s->ssy) r.f(2);  // chroma_sample_position
    }
    s->separate_uv_delta_q = r.f(1);
  }
  s->film_grain = r.f(1);
}

int tile_log2(int blk, int target) {
  int k = 0;
  while ((blk << k) < target) k++;
  return k;
}

int read_delta_q(BitReader& r) { return r.f(1) ? static_cast<int>(r.su(7)) : 0; }

// 5.9.2 to 5.9.12 for a key frame (or an intra-only one), up to the point
// the tile group starts; refuses lossy frames
void frame_header(BitReader& r, const SequenceHeader& s, FrameHeader* fh) {
  int frame_type = 0;  // KEY_FRAME
  if (!s.reduced) {
    if (r.f(1)) not_ported("AV1 show_existing_frame");
    frame_type = r.f(2);
    if (frame_type != 0) not_ported("an AV1 frame that is not a key frame");
    if (!r.f(1)) not_ported("a hidden AV1 key frame");
    // a shown key frame is error resilient, and refreshes every slot
  }
  fh->disable_cdf_update = r.f(1);
  fh->screen_content = s.force_screen_content == 2
                           ? static_cast<bool>(r.f(1))
                           : s.force_screen_content != 0;
  if (fh->screen_content && s.force_integer_mv == 2) r.f(1);  // force_integer_mv
  if (s.frame_id_numbers) r.f(s.frame_id_len);              // current_frame_id
  bool size_override = false;
  if (!s.reduced) size_override = r.f(1);
  r.f(s.order_hint_bits);  // order_hint
  // primary_ref_frame: PRIMARY_REF_NONE for an intra frame; no decoder
  // model, so no buffer removal times
  // frame_size (5.9.5)
  if (size_override) {
    fh->width = r.f(s.frame_width_bits) + 1;
    fh->height = r.f(s.frame_height_bits) + 1;
  } else {
    fh->width = s.max_width;
    fh->height = s.max_height;
  }
  if (s.superres && r.f(1)) not_ported("AV1 superres");
  fh->mi_cols = 2 * ((fh->width + 7) >> 3);
  fh->mi_rows = 2 * ((fh->height + 7) >> 3);
  if (r.f(1)) {  // render_and_frame_size_different
    r.f(16);
    r.f(16);
  }
  if (fh->screen_content) fh->intrabc = r.f(1);  // UpscaledWidth == FrameWidth
  // disable_frame_end_update_cdf, when read, changes nothing of one frame
  if (!s.reduced && !fh->disable_cdf_update) r.f(1);
  // tile_info (5.9.15)
  const int sb_shift = s.sb128 ? 5 : 4;
  const int sb_cols = s.sb128 ? (fh->mi_cols + 31) >> 5 : (fh->mi_cols + 15) >> 4;
  const int sb_rows = s.sb128 ? (fh->mi_rows + 31) >> 5 : (fh->mi_rows + 15) >> 4;
  const int sb_size = sb_shift + 2;
  const int max_tile_width_sb = 4096 >> sb_size;
  int max_tile_area_sb = (4096 * 2304) >> (2 * sb_size);
  const int min_log2_cols = tile_log2(max_tile_width_sb, sb_cols);
  const int max_log2_cols = tile_log2(1, std::min(sb_cols, 64));
  const int max_log2_rows = tile_log2(1, std::min(sb_rows, 64));
  const int min_log2_tiles =
      std::max(min_log2_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols));
  std::vector<int>& cols = fh->mi_col_starts;
  std::vector<int>& rows = fh->mi_row_starts;
  if (r.f(1)) {  // uniform_tile_spacing_flag
    int cols_log2 = min_log2_cols;
    while (cols_log2 < max_log2_cols && r.f(1)) cols_log2++;
    const int w = (sb_cols + (1 << cols_log2) - 1) >> cols_log2;
    for (int start = 0; start < sb_cols; start += w) cols.push_back(start << sb_shift);
    int rows_log2 = std::max(min_log2_tiles - cols_log2, 0);
    while (rows_log2 < max_log2_rows && r.f(1)) rows_log2++;
    const int h = (sb_rows + (1 << rows_log2) - 1) >> rows_log2;
    for (int start = 0; start < sb_rows; start += h) rows.push_back(start << sb_shift);
    fh->tile_cols_log2 = cols_log2;
    fh->tile_rows_log2 = rows_log2;
  } else {
    int widest = 0;
    for (int start = 0; start < sb_cols;) {
      cols.push_back(start << sb_shift);
      const int size =
          static_cast<int>(r.ns(std::min(sb_cols - start, max_tile_width_sb))) + 1;
      widest = std::max(widest, size);
      start += size;
    }
    max_tile_area_sb = min_log2_tiles > 0
                           ? (sb_rows * sb_cols) >> (min_log2_tiles + 1)
                           : sb_rows * sb_cols;
    const int max_h = std::max(max_tile_area_sb / widest, 1);
    for (int start = 0; start < sb_rows;) {
      rows.push_back(start << sb_shift);
      start += static_cast<int>(r.ns(std::min(sb_rows - start, max_h))) + 1;
    }
    fh->tile_cols_log2 = tile_log2(1, static_cast<int>(cols.size()));
    fh->tile_rows_log2 = tile_log2(1, static_cast<int>(rows.size()));
  }
  fh->tile_cols = static_cast<int>(cols.size());
  fh->tile_rows = static_cast<int>(rows.size());
  cols.push_back(fh->mi_cols);
  rows.push_back(fh->mi_rows);
  if (fh->tile_cols_log2 > 0 || fh->tile_rows_log2 > 0) {
    fh->context_update_tile_id = r.f(fh->tile_rows_log2 + fh->tile_cols_log2);
    fh->tile_size_bytes = r.f(2) + 1;
    if (fh->context_update_tile_id >= fh->tile_cols * fh->tile_rows)
      corrupt("AV1 context_update_tile_id " + std::to_string(fh->context_update_tile_id) +
              " of " + std::to_string(fh->tile_cols * fh->tile_rows) + " tiles");
  }
  // quantization_params (5.9.12)
  fh->base_q_idx = r.f(8);
  int* dq = fh->delta_q;  // y dc, u dc, u ac, v dc, v ac
  dq[0] = read_delta_q(r);
  if (!s.mono) {
    const bool diff_uv = s.separate_uv_delta_q ? static_cast<bool>(r.f(1)) : false;
    dq[1] = read_delta_q(r);
    dq[2] = read_delta_q(r);
    if (diff_uv) {
      dq[3] = read_delta_q(r);
      dq[4] = read_delta_q(r);
    } else {
      dq[3] = dq[1];
      dq[4] = dq[2];
    }
  }
  fh->using_qmatrix = r.f(1);
  if (fh->using_qmatrix) {
    fh->qm[0] = r.f(4);
    fh->qm[1] = r.f(4);
    fh->qm[2] = s.separate_uv_delta_q ? static_cast<int>(r.f(4)) : fh->qm[1];
  }
  // segmentation_params (5.9.14)
  if (r.f(1)) not_ported("AV1 segmentation");
  // delta_q_params and delta_lf_params (5.9.17, 5.9.18)
  if (fh->base_q_idx > 0) fh->delta_q_present = r.f(1);
  if (fh->delta_q_present) {
    fh->delta_q_res = r.f(2);
    if (!fh->intrabc && r.f(1)) not_ported("AV1 delta loop filter levels");
  }
  fh->lossless = fh->base_q_idx == 0;
  for (int i = 0; i < 5; i++) fh->lossless = fh->lossless && dq[i] == 0;
  if (fh->lossless) fh->qm[0] = fh->qm[1] = fh->qm[2] = 15;
  if (!fh->using_qmatrix) fh->qm[0] = fh->qm[1] = fh->qm[2] = 15;
  const int planes = s.mono ? 1 : 3;
  // loop_filter_params (5.9.11): a key frame starts from the default
  // deltas (INTRA_FRAME 1, GOLDEN and both ALTREFs -1)
  if (!fh->lossless && !fh->intrabc) {
    fh->lf_level[0] = r.f(6);
    fh->lf_level[1] = r.f(6);
    if (planes > 1 && (fh->lf_level[0] || fh->lf_level[1])) {
      fh->lf_level[2] = r.f(6);
      fh->lf_level[3] = r.f(6);
    }
    fh->lf_sharpness = r.f(3);
    fh->lf_delta_enabled = r.f(1);
    if (fh->lf_delta_enabled && r.f(1)) {  // loop_filter_delta_update
      for (int i = 0; i < 8; i++)
        if (r.f(1)) fh->lf_ref_deltas[i] = static_cast<int>(r.su(7));
      for (int i = 0; i < 2; i++)
        if (r.f(1)) fh->lf_mode_deltas[i] = static_cast<int>(r.su(7));
    }
  }
  // cdef_params (5.9.19)
  fh->cdef = !fh->lossless && !fh->intrabc && s.enable_cdef;
  if (fh->cdef) {
    fh->cdef_damping = r.f(2) + 3;
    fh->cdef_bits = r.f(2);
    for (int i = 0; i < (1 << fh->cdef_bits); i++) {
      fh->cdef_y_pri[i] = r.f(4);
      fh->cdef_y_sec[i] = r.f(2);
      if (fh->cdef_y_sec[i] == 3) fh->cdef_y_sec[i]++;
      if (planes > 1) {
        fh->cdef_uv_pri[i] = r.f(4);
        fh->cdef_uv_sec[i] = r.f(2);
        if (fh->cdef_uv_sec[i] == 3) fh->cdef_uv_sec[i]++;
      }
    }
  }
  // lr_params (5.9.20); superres is refused, so AllLossless is
  // CodedLossless
  if (!fh->lossless && !fh->intrabc && s.enable_restoration) {
    static const int kRemap[4] = {RESTORE_NONE, RESTORE_SWITCHABLE,
                                  RESTORE_WIENER, RESTORE_SGRPROJ};
    bool chroma = false;
    for (int i = 0; i < planes; i++) {
      fh->lr_type[i] = kRemap[r.f(2)];
      if (fh->lr_type[i] != RESTORE_NONE) {
        fh->uses_lr = true;
        if (i > 0) chroma = true;
      }
    }
    if (fh->uses_lr) {
      int shift;
      if (s.sb128) {
        shift = r.f(1) + 1;
      } else {
        shift = r.f(1);
        if (shift) shift += r.f(1);
      }
      fh->lr_size[0] = 256 >> (2 - shift);
      const int uv_shift = s.ssx && s.ssy && chroma ? static_cast<int>(r.f(1)) : 0;
      fh->lr_size[1] = fh->lr_size[2] = fh->lr_size[0] >> uv_shift;
    }
  }
  // read_tx_mode (5.9.21)
  if (!fh->lossless) fh->tx_mode_select = r.f(1);
  fh->reduced_tx_set = r.f(1);
  // global_motion_params: nothing for an intra frame
  if (s.film_grain) {
    if (r.f(1)) not_ported("AV1 film grain");
  }
}

}  // namespace

namespace {

// tile_group_obu (5.11.1): the tiles of the group, each at its tile
// number in pic->tiles
void tile_group(const uint8_t* d, long n, Picture* pic) {
  const FrameHeader& fh = pic->frame;
  const int num_tiles = fh.tile_cols * fh.tile_rows;
  BitReader r(d, n);
  int start = 0, end = num_tiles - 1;
  if (num_tiles > 1 && r.f(1)) {  // tile_start_and_end_present_flag
    const int bits = fh.tile_cols_log2 + fh.tile_rows_log2;
    start = r.f(bits);
    end = r.f(bits);
  }
  r.byte_align();
  long p = r.bytes_read();
  if (start > end || end >= num_tiles)
    corrupt("AV1 tile group of tiles " + std::to_string(start) + " to " +
            std::to_string(end) + " of " + std::to_string(num_tiles));
  for (int t = start; t <= end; t++) {
    if (pic->tiles[t].data) corrupt("AV1 tile " + std::to_string(t) + " given twice");
    long size = n - p;
    if (t != end) {
      if (n - p < fh.tile_size_bytes)
        corrupt("AV1 tile group ends in tile " + std::to_string(t) + "'s size");
      size = 0;
      for (int i = 0; i < fh.tile_size_bytes; i++) size |= long{d[p + i]} << (8 * i);
      size += 1;
      p += fh.tile_size_bytes;
      if (size > n - p)
        corrupt("AV1 tile " + std::to_string(t) + " of " + std::to_string(size) +
                " bytes runs past its tile group (" + std::to_string(n - p) + " left)");
    }
    if (size <= 0) corrupt("AV1 tile " + std::to_string(t) + " of no bytes");
    pic->tiles[t] = Tile{d + p, size};
    p += size;
  }
}

}  // namespace

void parse_obus(const uint8_t* config, long config_len, const uint8_t* data,
                long len, Picture* pic) {
  bool have_seq = false, have_frame = false;
  for (int pass = 0; pass < 2; pass++) {
    const uint8_t* d = pass ? data : config;
    const long n = pass ? len : config_len;
    long p = 0;
    while (p < n) {
      BitReader h(d + p, n - p);
      if (h.f(1)) corrupt("AV1 OBU header: forbidden bit set");
      const int type = h.f(4);
      const bool ext = h.f(1), has_size = h.f(1);
      h.f(1);
      if (ext) h.f(8);  // temporal and spatial ids: one layer
      const long hdr = 1 + ext;
      uint64_t size = n - p - hdr;
      long start = p + hdr;
      if (has_size) {
        BitReader sz(d + start, n - start);
        size = sz.leb128();
        start += sz.bytes_read();
      }
      if (start > n || size > static_cast<uint64_t>(n - start))
        corrupt("AV1 OBU of " + std::to_string(size) +
                " bytes runs past the end of the item (" +
                std::to_string(n - start) + " left)");
      const uint8_t* body = d + start;
      p = start + static_cast<long>(size);
      if (type == 1) {
        BitReader r(body, static_cast<long>(size));
        SequenceHeader s;
        sequence_header(r, &s);
        pic->seq = s;
        have_seq = true;
        count(s.reduced ? kToolSeqReduced : kToolSeqFull);
      } else if (type == 3 || type == 6) {
        if (have_frame) not_ported("an AV1 item of more than one frame");
        if (!have_seq) corrupt("AV1 frame before any sequence header");
        if (pass == 0) corrupt("AV1 frame among the av1C config OBUs");
        BitReader r(body, static_cast<long>(size));
        frame_header(r, pic->seq, &pic->frame);
        have_frame = true;
        pic->tiles.assign(pic->frame.tile_cols * pic->frame.tile_rows, Tile());
        if (type == 6) {
          r.byte_align();
          tile_group(body + r.bytes_read(), static_cast<long>(size) - r.bytes_read(), pic);
        }
      } else if (type == 4) {
        if (!have_frame) corrupt("AV1 tile group without its frame header");
        tile_group(body, static_cast<long>(size), pic);
      } else if (type == 2 || type == 5 || type == 15) {
        // temporal delimiter, metadata, padding
      } else if (type == 7) {
        // a redundant frame header repeats the one read
      } else {
        corrupt("AV1 OBU of type " + std::to_string(type) + " in an image");
      }
    }
  }
  if (!have_seq) corrupt("AV1 item without a sequence header");
  if (!have_frame) corrupt("AV1 item without tile data");
  for (size_t t = 0; t < pic->tiles.size(); t++)
    if (!pic->tiles[t].data)
      corrupt("AV1 item without tile " + std::to_string(t) + " of " +
              std::to_string(pic->tiles.size()));
  if (pic->tiles.size() > 1) count(kToolTiles);
}

}  // namespace av1
}  // namespace sdt
