"""Multi-scale deformable attention (MSDA): the plain PyTorch version.

Semantics of the reference CUDA op (`ms_deform_im2col_cuda.cuh:238-300`),
whose numerical oracle is `ms_deform_attn_core_pytorch`:

  for each (batch n, query q, head m): out = sum over levels l, points p of
    attn[n,q,m,l,p] * bilinear_sample(value_l[n,:,:,m,:], loc[n,q,m,l,p])

`loc` is normalized to [0,1] over the level's (W,H) including padding, and
sampling follows `grid_sample(align_corners=False, padding_mode='zeros')`:
pixel = loc * extent - 0.5, corners outside the map read 0.

This is the gather-based mirror of the JAX oracle. It is what a CPU tensor
runs, and what the hand-written CUDA kernels
(`ops/ms_deform_attn_cuda.py`) are held against on the card: the forward
against `ms_deform_attn`, the backward against `ms_deform_attn_backward`,
autograd through it (the mirror of the JAX oracle vjp).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch


def level_start_index(spatial_shapes: Sequence[Tuple[int, int]]) -> np.ndarray:
    sizes = [h * w for h, w in spatial_shapes]
    return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Tuple[Tuple[int, int], ...],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """Plain multi-scale deformable attention.

    Args:
      value: (N, S, M, D) flattened multi-level features, S = sum(H*W).
      spatial_shapes: ((H0, W0), ..., (H_{L-1}, W_{L-1})).
      sampling_locations: (N, Lq, M, L, P, 2), (x, y) normalized to [0, 1].
      attention_weights: (N, Lq, M, L, P).

    Returns:
      (N, Lq, M*D) in value's dtype, accumulated in float32. A corner that
      lies outside its map, or a non-finite location, contributes 0.
    """
    N, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if L != len(spatial_shapes) or sum(h * w for h, w in spatial_shapes) != S:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not match "
                         f"L={L}, S={S}")
    dev = value.device
    loc = sampling_locations.float()
    hw = torch.tensor(spatial_shapes, dtype=torch.float32, device=dev)
    Hs, Ws = hw[:, 0, None], hw[:, 1, None]                    # (L, 1)
    starts = torch.as_tensor(level_start_index(spatial_shapes),
                             dtype=torch.int64, device=dev)[:, None]

    px = loc[..., 0] * Ws - 0.5                                # (N,Lq,M,L,P)
    py = loc[..., 1] * Hs - 0.5
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = px - x0
    fy = py - y0
    Wl, Hl = Ws.long(), Hs.long()

    def corner(xf, yf, w):
        # bounds are tested on floats, before any float->int conversion,
        # so far-out and NaN locations neither index out of range nor
        # leak into the sum
        valid = (xf >= 0) & (xf < Ws) & (yf >= 0) & (yf < Hs)
        xi = torch.where(valid, xf, 0.0).long()
        yi = torch.where(valid, yf, 0.0).long()
        return starts + yi * Wl + xi, torch.where(valid, w, 0.0)

    i00, w00 = corner(x0, y0, (1 - fx) * (1 - fy))
    i01, w01 = corner(x0 + 1, y0, fx * (1 - fy))
    i10, w10 = corner(x0, y0 + 1, (1 - fx) * fy)
    i11, w11 = corner(x0 + 1, y0 + 1, fx * fy)

    idx = torch.stack([i00, i01, i10, i11], -1)               # (N,Lq,M,L,P,4)
    cw = (torch.stack([w00, w01, w10, w11], -1)
          * attention_weights.float()[..., None])

    # one gather per (batch, head) along the token axis
    K = Lq * L * P * 4
    v = value.permute(0, 2, 1, 3)                              # (N, M, S, D)
    flat_idx = idx.permute(0, 2, 1, 3, 4, 5).reshape(N, M, K, 1)
    sampled = torch.gather(v, 2, flat_idx.expand(N, M, K, D))  # (N,M,K,D)
    flat_w = cw.permute(0, 2, 1, 3, 4, 5).reshape(N, M, Lq, L * P * 4, 1)
    out = (sampled.float().reshape(N, M, Lq, L * P * 4, D)
           * flat_w).sum(3)                                    # (N,M,Lq,D)
    return out.permute(0, 2, 1, 3).reshape(N, Lq, M * D).to(value.dtype)


def ms_deform_attn_backward(value: torch.Tensor,
                            spatial_shapes: Tuple[Tuple[int, int], ...],
                            sampling_locations: torch.Tensor,
                            attention_weights: torch.Tensor,
                            grad_out: torch.Tensor
                            ) -> Tuple[torch.Tensor, ...]:
    """(d_value, d_loc, d_attn) of `ms_deform_attn` for the cotangent
    grad_out (N, Lq, M*D), by autograd through the plain version.

    Out-of-range corners add nothing. A NaN (or infinite) location gives
    NaN in its d_loc here, where the CUDA kernel gives 0; compare the two
    only where this result is finite. With bfloat16 value the gather's
    backward scatters in bfloat16: pass value.float() for a float32 sum.
    """
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(True) for t in
                  (value, sampling_locations, attention_weights)]
        out = ms_deform_attn(inputs[0], spatial_shapes, inputs[1], inputs[2])
        return torch.autograd.grad(out, inputs, grad_out.to(out.dtype))


def sampling_offsets_init_bias(n_heads: int, n_levels: int,
                               n_points: int) -> np.ndarray:
    """Directional grid init for the sampling-offset bias
    (`MSDeformAttn._reset_parameters`): head h points along angle
    2*pi*h/H normalized to the unit Linf ball, point p scaled by (p+1),
    identical across levels."""
    thetas = np.arange(n_heads, dtype=np.float64) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for p in range(n_points):
        grid[:, :, p, :] *= p + 1
    return grid.reshape(-1).astype(np.float32)
