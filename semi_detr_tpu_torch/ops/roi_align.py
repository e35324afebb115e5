"""RoIAlign and multi-level RoI extraction, as gathers on NCHW features.

Counterpart of `semi_detr_tpu/ops/roi_align.py`, which replaces mmcv's
RoIAlign under the reference's consistency-query projector
(`detr_ssod/models/dino_detr_ssod.py:97-101`: SingleRoIExtractor, 7x7
output, strides [8, 16, 32, 64]):

* `aligned=True`: box coordinates scale by 1/stride and shift by half a
  pixel, and each bin averages bilinear taps on a regular grid;
* taps are adaptive, as the reference's `sampling_ratio=0`: ceil(extent in
  cells / out_size) taps per bin axis, capped at `max_taps` = 4 (the JAX
  package's static budget; beyond the cap a bin averages 4 uniform taps),
  divided by the tap count, and 1 for a zero-extent RoI, whose output is 0;
* bilinear taps follow mmcv: a point outside [-1, H] x [-1, W] gives 0,
  coordinates below 0 clamp to 0, and the high index clamps to H-1 / W-1;
* SingleRoIExtractor routes each RoI to one level, lvl = clamp(floor(
  log2(sqrt(area) / 56 + 1e-6)), 0, L-1).

The JAX package samples every level for every RoI and keeps the routed
one; here each RoI samples only its own level: the levels are concatenated
along the flattened spatial axis, and each RoI carries its level's stride,
extent and offset. The features stay NCHW (the port's `srcs`), gathered
along the spatial axis per channel. Taps are weighted in float32 (bfloat16
features are read exactly and promote, as in the JAX package), so the
output is float32.
"""
from __future__ import annotations

from typing import Sequence

import torch

OUT_SIZE = 7                    # the reference's 7x7 RoI features
MAX_TAPS = 4                    # the JAX package's static tap budget
STRIDES = (8, 16, 32, 64)
FINEST_SCALE = 56


def _bilinear(flat, h, w, start, x, y):
    """Sample flat (B, C, S) at continuous (x, y) (B, N) on levels of
    extent h, w (B, N) int that start at `start` (B, N) in S. Returns
    (B, C, N) float32."""
    oob = (x < -1.0) | (x > w) | (y < -1.0) | (y > h)
    x = x.clamp(min=0.0)
    y = y.clamp(min=0.0)
    x0 = torch.minimum(x.floor().long(), w - 1)
    y0 = torch.minimum(y.floor().long(), h - 1)
    x1 = torch.minimum(x0 + 1, w - 1)
    y1 = torch.minimum(y0 + 1, h - 1)
    fx = (x - x0).clamp(0.0, 1.0)
    fy = (y - y0).clamp(0.0, 1.0)
    c = flat.shape[1]

    def g(yy, xx):
        idx = (start + yy * w + xx)[:, None].expand(-1, c, -1)
        return torch.gather(flat, 2, idx).float()

    v = (g(y0, x0) * ((1 - fx) * (1 - fy))[:, None]
         + g(y0, x1) * (fx * (1 - fy))[:, None]
         + g(y1, x0) * ((1 - fx) * fy)[:, None]
         + g(y1, x1) * (fx * fy)[:, None])
    return v.masked_fill(oob[:, None], 0.0)


def _roi_align(flat, h, w, start, scale, rois):
    """RoIAlign of rois (B, R, 4) on the levels given per RoI: h, w, start
    (B, R) int and scale (B, R) = 1 / stride. Returns (B, R, C, 7, 7)
    float32."""
    out_size, t = OUT_SIZE, MAX_TAPS
    b, r = rois.shape[:2]
    rois = rois.float()
    x0 = rois[..., 0] * scale - 0.5
    y0 = rois[..., 1] * scale - 0.5
    x1 = rois[..., 2] * scale - 0.5
    y1 = rois[..., 3] * scale - 0.5
    rw, rh = x1 - x0, y1 - y0
    bin_w, bin_h = rw / out_size, rh / out_size
    dev = rois.device
    nx = torch.ceil(rw / out_size).clamp(max=t).long()
    ny = torch.ceil(rh / out_size).clamp(max=t).long()
    it = torch.arange(t, device=dev)
    # per-bin tap offsets in [0, 1): (B, R, t)
    offx = (it + 0.5) / nx.clamp(min=1)[..., None]
    offy = (it + 0.5) / ny.clamp(min=1)[..., None]
    mx = it < nx[..., None]
    my = it < ny[..., None]
    ob = torch.arange(out_size, device=dev)
    sx = x0[..., None, None] + bin_w[..., None, None] * (
        ob[:, None] + offx[..., None, :])                    # (B, R, out, t)
    sy = y0[..., None, None] + bin_h[..., None, None] * (
        ob[:, None] + offy[..., None, :])
    grid = (b, r, out_size, t, out_size, t)
    gx = sx[:, :, None, None].expand(grid)
    gy = sy[..., None, None].expand(grid)

    def per_tap(a):
        return a[..., None, None, None, None].expand(grid).reshape(b, -1)

    v = _bilinear(flat, per_tap(h), per_tap(w), per_tap(start),
                  gx.reshape(b, -1), gy.reshape(b, -1))
    v = v.reshape(b, -1, *grid[1:])                      # (B, C, R, oh, t, ow, t)
    keep = my[:, :, None, :, None, None] & mx[:, :, None, None, None, :]
    count = (ny * nx).clamp(min=1).float()
    v = v.masked_fill(~keep[:, None], 0.0).sum((4, 6))   # (B, C, R, oh, ow)
    return (v / count[:, None, :, None, None]).transpose(1, 2)


def roi_align_level(feat: torch.Tensor, rois_xyxy: torch.Tensor,
                    stride: float) -> torch.Tensor:
    """RoIAlign on one level, with the adaptive tap count (module
    docstring). feat: (B, C, H, W); rois: (B, R, 4) xyxy in image
    coordinates. Returns (B, R, C, 7, 7) float32."""
    b, _, hh, ww = feat.shape
    r = rois_xyxy.shape[1]
    dev = feat.device

    def full(v, dtype):
        return torch.full((b, r), v, dtype=dtype, device=dev)

    return _roi_align(feat.flatten(2), full(hh, torch.long),
                      full(ww, torch.long), full(0, torch.long),
                      full(1.0 / stride, torch.float32), rois_xyxy)


def roi_levels(rois_xyxy: torch.Tensor, n_levels: int) -> torch.Tensor:
    """SingleRoIExtractor.map_roi_levels: (B, R) int64 level per RoI."""
    r = rois_xyxy.float()
    areas = ((r[..., 2] - r[..., 0]) * (r[..., 3] - r[..., 1])).clamp(min=0)
    lvl = torch.floor(torch.log2(areas.sqrt() / FINEST_SCALE + 1e-6))
    return lvl.clamp(0, n_levels - 1).long()


def multi_level_roi_align(feats: Sequence[torch.Tensor],
                          rois_xyxy: torch.Tensor) -> torch.Tensor:
    """SingleRoIExtractor: each RoI pooled on the level its scale routes it
    to.

    feats: per level (B, C, H_l, W_l), one per stride of STRIDES; rois:
    (B, R, 4) xyxy in image coordinates. Returns (B, R, C, 7, 7) float32."""
    dev = rois_xyxy.device
    lvl = roi_levels(rois_xyxy, len(feats))
    hws = [(f.shape[2], f.shape[3]) for f in feats]
    starts, s = [], 0
    for hh, ww in hws:
        starts.append(s)
        s += hh * ww

    def per_level(vals, dtype):
        return torch.tensor(vals, dtype=dtype, device=dev)[lvl]

    flat = torch.cat([f.flatten(2) for f in feats], 2)         # (B, C, S)
    return _roi_align(flat, per_level([hw[0] for hw in hws], torch.long),
                      per_level([hw[1] for hw in hws], torch.long),
                      per_level(starts, torch.long),
                      per_level([1.0 / st for st in STRIDES], torch.float32),
                      rois_xyxy)
