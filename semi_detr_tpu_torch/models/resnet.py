"""ResNet-50/101 backbone with frozen BatchNorm, NCHW.

Counterpart of `semi_detr_tpu/models/resnet.py`: depth 50, out_indices
(1, 2, 3) -> C3/C4/C5 at strides 8/16/32, norm_eval (BN statistics never
update), 'pytorch' style (stride-2 inside the 3x3 conv of a bottleneck).
Parameter names are torchvision's (`conv1`, `bn1`, `layer{i}.{j}.*`,
`downsample.{0,1}`), so a reference state dict loads directly.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d


class FrozenBN(nn.Module):
    """BatchNorm with permanently frozen running stats (norm_eval=True).

    The affine fold is computed in float32 and applied in the input's
    dtype, as the JAX package does."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        scale = self.weight.float() / torch.sqrt(self.running_var.float()
                                                 + self.eps)
        bias = self.bias.float() - self.running_mean.float() * scale
        return (x * scale.to(x.dtype)[:, None, None]
                + bias.to(x.dtype)[:, None, None])


def _conv(cin, cout, k, stride=1, padding=0):
    return Conv2d(cin, cout, k, stride, padding, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = mid * 4
        self.conv1 = _conv(cin, mid, 1)
        self.bn1 = FrozenBN(mid)
        self.conv2 = _conv(mid, mid, 3, stride, 1)
        self.bn2 = FrozenBN(mid)
        self.conv3 = _conv(mid, out, 1)
        self.bn3 = FrozenBN(out)
        self.downsample = (nn.Sequential(_conv(cin, out, 1, stride),
                                         FrozenBN(out))
                           if downsample else None)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(h + x)


class ResNet(nn.Module):
    """ResNet-50/101. Input NCHW float; returns the feature maps at
    out_indices (0=C2/stride4 ... 3=C5/stride32), NCHW."""

    STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

    def __init__(self, depth: int = 50, out_indices: Sequence[int] = (1, 2, 3)):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = FrozenBN(64)
        cin = 64
        for si, n_blocks in enumerate(self.STAGES[depth]):
            mid = 64 * (2 ** si)
            blocks = []
            for bi in range(n_blocks):
                stride = 2 if (si > 0 and bi == 0) else 1
                blocks.append(Bottleneck(cin, mid, stride, downsample=bi == 0))
                cin = mid * 4
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, 2, 1)
        outs = []
        for si in range(4):
            h = getattr(self, f"layer{si + 1}")(h)
            if si in self.out_indices:
                outs.append(h)
        return tuple(outs)
