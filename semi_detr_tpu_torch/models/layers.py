"""Layers that store their parameters in one dtype and compute in another.

The JAX package's flax modules keep float32 parameters (`param_dtype`) and
compute in the config's `dtype`: each layer casts its parameters and its
input to the compute dtype when it runs. These layers do the same. Their
`compute_dtype` (None: the parameters' own dtype) is set for a whole model
by `DINODetector.set_compute_dtype`; the parameters stay float32, so an
optimizer updates them in float32, and gradients reach them through the
cast in float32.

The names and shapes of the parameters are those of `torch.nn`'s layers,
so state dicts load unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class CastMixin:
    """`compute_dtype`, and the cast of inputs and parameters to it."""
    compute_dtype: Optional[torch.dtype] = None

    def _dtype(self, ref: torch.Tensor) -> torch.dtype:
        return self.compute_dtype or ref.dtype

    @staticmethod
    def _cast(t: Optional[torch.Tensor], dtype: torch.dtype):
        return None if t is None else t.to(dtype)


class Linear(CastMixin, nn.Linear):
    def forward(self, x):
        dt = self._dtype(self.weight)
        return F.linear(x.to(dt), self.weight.to(dt),
                        self._cast(self.bias, dt))


class Conv2d(CastMixin, nn.Conv2d):
    def forward(self, x):
        dt = self._dtype(self.weight)
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  self._cast(self.bias, dt))


class LayerNorm(CastMixin, nn.LayerNorm):
    def forward(self, x):
        dt = self._dtype(self.weight)
        return F.layer_norm(x.to(dt), self.normalized_shape,
                            self.weight.to(dt), self.bias.to(dt), self.eps)


class GroupNorm(CastMixin, nn.GroupNorm):
    """`F.group_norm`, except where a group holds one value (C / G * H * W
    == 1: batch 1, one channel per group, a 1x1 map), which torch refuses
    in training. There the statistics are taken here, as the JAX GroupNorm
    takes them: x - mean is exactly 0, and so is its gradient into x and
    the weight (torch's own backward there gives rounding noise amplified
    by rstd**3)."""

    def forward(self, x):
        dt = self._dtype(self.weight)
        x, w, b = x.to(dt), self.weight.to(dt), self.bias.to(dt)
        if x[0].numel() != self.num_groups:
            return F.group_norm(x, self.num_groups, w, b, self.eps)
        groups = x.reshape(x.shape[0], self.num_groups, -1)
        var, mean = torch.var_mean(groups, dim=-1, unbiased=False,
                                   keepdim=True)
        y = ((groups - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return y * w.reshape(shape) + b.reshape(shape)
