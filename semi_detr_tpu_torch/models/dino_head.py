"""DINO detector: backbone, input projections, transformer, shared heads.

Counterpart of `semi_detr_tpu/models/dino_head.py`:

* input_proj: 1x1 conv + GroupNorm(32) for the 3 backbone levels, plus a
  3x3 stride-2 conv + GN on C5 for the 4th level
* shared class Linear (prior-prob 0.01 bias init) and 3-layer box MLP
  (zero-init last layer) across decoder layers; separate copies for the
  encoder's two-stage heads
* label_enc Embedding(dn_labelbook_size+1, C) for denoising queries
* per-layer outputs: coord = sigmoid(fc_reg(hs_l) + inv_sigmoid(ref_l)),
  class = fc_cls(hs_l)
* with ground truth, the CDN block (`models/dn.py`) is prepended to the
  matching queries under its attention mask, and its outputs come back as
  `front_cls` / `front_coord` beside the `cdn` layout
* parameters are float32; every layer computes in `cfg.dtype`
  (`models/layers.py`), as flax's `dtype` / `param_dtype` split does

The module tree is the reference's (`backbone.*`, `bbox_head.*`), so a
reference state dict, or `utils.torch_weights.state_dict_from_jax` of the
JAX package's variables, loads with `load_state_dict`. Images enter as
(B, H, W, 3) like the JAX package's; feature maps are NCHW inside.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..data.augment import IMG_MEAN, IMG_STD
from ..ops.ms_deform_attn import sampling_offsets_init_bias
from .dn import CdnBatch, build_cdn_queries, cdn_attn_mask, draw_cdn_noise
from .layers import CastMixin, Conv2d, GroupNorm, Linear
from .resnet import FrozenBN, ResNet
from .transformer import (DINOTransformer, Mlp, MSDeformAttention,
                          MultiheadSelfAttention, inverse_sigmoid)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "bf16": torch.bfloat16}


@dataclass(frozen=True)
class DinoConfig:
    num_classes: int = 80
    num_queries: int = 900
    d_model: int = 256
    n_heads: int = 8
    n_levels: int = 4
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    d_ffn: int = 2048
    enc_n_points: int = 4
    dec_n_points: int = 4
    backbone_depth: int = 50
    backbone_channels: Tuple[int, ...] = (512, 1024, 2048)
    dn_labelbook_size: int = 81
    # CDN slot budget: 2*dn_single_pad*dn_groups static slots (the
    # reference's 2*dn_number); the partition adapts per batch (models/dn.py)
    dn_single_pad: int = 100
    dn_groups: int = 1
    dn_label_noise_ratio: float = 0.5
    dn_box_noise_scale: float = 0.4
    max_gt: int = 100
    dtype: Any = torch.float32   # compute dtype (torch dtype or its name)
    # TPU layout and compile knobs of the JAX package; accepted so the
    # configs load, ignored (they do not change the numbers)
    remat: bool = False
    tiled_tokens: bool = True
    scan_unroll: int = 6

    def __post_init__(self):
        if isinstance(self.dtype, str):
            object.__setattr__(self, "dtype", _DTYPES[self.dtype])

    @property
    def dn_pad_size(self) -> int:
        return 2 * self.dn_single_pad * self.dn_groups


def prepare_images(images, img_hw):
    """Normalization of raw uint8 batches on the device: f32
    (x - mean)/std, with rows/cols beyond each image's valid extent
    re-zeroed. Float inputs pass through unchanged.

    images: (B, H, W, 3); img_hw: (B, 2) int valid (h, w)."""
    if images.dtype != torch.uint8:
        return images
    dev = images.device
    mean = torch.from_numpy(IMG_MEAN).to(dev)
    std = torch.from_numpy(IMG_STD).to(dev)
    x = (images.float() - mean) / std
    _, H, W, _ = images.shape
    vi = torch.arange(H, device=dev)[None, :] < img_hw[:, :1]      # (B, H)
    vj = torch.arange(W, device=dev)[None, :] < img_hw[:, 1:2]     # (B, W)
    return x * (vi[:, :, None] & vj[:, None, :])[..., None]


def level_valid_masks(spatial_shapes, input_hw, img_hw):
    """Per-level validity masks by F.interpolate(nearest) index math:
    level pixel (i, j) is valid iff floor(i * H_in / H_l) < img_h etc.

    Returns a list of (B, H_l, W_l) bool (True = valid)."""
    H, W = input_hw
    dev = img_hw.device
    masks = []
    for (h, w) in spatial_shapes:
        src_i = torch.from_numpy(np.arange(h) * H // h).to(dev)[None, :]
        src_j = torch.from_numpy(np.arange(w) * W // w).to(dev)[None, :]
        vi = src_i < img_hw[:, :1]
        vj = src_j < img_hw[:, 1:2]
        masks.append(vi[:, :, None] & vj[:, None, :])
    return masks


def backbone_spatial_shapes(input_hw, n_levels: int = 4):
    """Conv arithmetic: strides 8/16/32 from ResNet C3-C5, extra stride-64
    level from a stride-2 conv on C5 (all ceil division)."""
    H, W = input_hw
    shapes = [(-(-H // s), -(-W // s)) for s in (8, 16, 32)]
    h5, w5 = shapes[-1]
    for _ in range(n_levels - 3):
        h5, w5 = -(-h5 // 2), -(-w5 // 2)
        shapes.append((h5, w5))
    return tuple(shapes[:n_levels])


class ClsHead(Linear):
    """Class Linear with the prior-0.01 bias init."""
    PRIOR = 0.01


class DINOHead(nn.Module):
    """The reference's `bbox_head`: input projections, heads, transformer."""

    def __init__(self, c: DinoConfig):
        super().__init__()
        n_bb = len(c.backbone_channels)
        projs = []
        for i in range(c.n_levels):
            if i < n_bb:
                conv = Conv2d(c.backbone_channels[i], c.d_model, 1)
            else:
                conv = Conv2d(c.backbone_channels[-1] if i == n_bb
                              else c.d_model, c.d_model, 3, 2, 1)
            projs.append(nn.Sequential(conv, GroupNorm(32, c.d_model,
                                                       eps=1e-5)))
        self.input_proj = nn.ModuleList(projs)
        cls = ClsHead(c.d_model, c.num_classes)
        reg = Mlp(c.d_model, c.d_model, 4, 3)
        # shared across decoder layers: one module at every index
        self.fc_cls = nn.ModuleList([cls] * c.num_decoder_layers)
        self.fc_reg = nn.ModuleList([reg] * c.num_decoder_layers)
        self.fc_enc_cls = ClsHead(c.d_model, c.num_classes)
        self.fc_enc_reg = Mlp(c.d_model, c.d_model, 4, 3)
        self.label_enc = nn.Embedding(c.dn_labelbook_size + 1, c.d_model)
        self.transformer = DINOTransformer(
            d_model=c.d_model, n_heads=c.n_heads, num_queries=c.num_queries,
            num_encoder_layers=c.num_encoder_layers,
            num_decoder_layers=c.num_decoder_layers, d_ffn=c.d_ffn,
            n_levels=c.n_levels, enc_n_points=c.enc_n_points,
            dec_n_points=c.dec_n_points)


class DINODetector(nn.Module):
    """Backbone + projections + transformer + heads. Returns raw per-layer
    outputs split into the front blocks and the matching queries."""

    def __init__(self, cfg: DinoConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNet(depth=cfg.backbone_depth)
        self.bbox_head = DINOHead(cfg)
        self.set_compute_dtype(cfg.dtype)

    def set_compute_dtype(self, dtype):
        """Make every layer compute in `dtype`; the parameters stay as they
        are stored (float32). FrozenBN follows its input, and the
        sampling-offset and attention-logit projections compute in float32
        (see models/transformer.py)."""
        for m in self.modules():
            if isinstance(m, CastMixin):
                m.compute_dtype = (torch.float32 if getattr(
                    m, "keep_float32", False) else dtype)
        return self

    @property
    def compute_dtype(self):
        return self.backbone.conv1.compute_dtype

    @torch.no_grad()
    def init_weights(self, seed: int = 0):
        """Seeded init with the JAX package's initializers: xavier-uniform
        Dense/Conv kernels, zero biases, N(0,1) embeddings, identity
        FrozenBN, the prior-0.01 class bias, zero-init last box layer, and
        zero sampling-offset/attention kernels with the directional grid
        bias. Draws on the CPU from a `torch.Generator`."""
        g = torch.Generator().manual_seed(seed)

        def fill(p, make):
            p.copy_(make().to(p.dtype))

        def xavier(p, fan_in, fan_out):
            b = math.sqrt(6.0 / (fan_in + fan_out))
            fill(p, lambda: torch.empty(p.shape).uniform_(-b, b, generator=g))

        def normal(p):
            fill(p, lambda: torch.empty(p.shape).normal_(generator=g))

        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                rf = m.weight[0, 0].numel()
                xavier(m.weight, m.weight.shape[1] * rf,
                       m.weight.shape[0] * rf)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, MultiheadSelfAttention):
                c = m.in_proj_weight.shape[1]
                for w in m.in_proj_weight.chunk(3):
                    xavier(w, c, c)
                m.in_proj_bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm, FrozenBN)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, FrozenBN):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
            elif isinstance(m, nn.Embedding):
                normal(m.weight)
        for m in self.modules():
            if isinstance(m, ClsHead):
                m.bias.fill_(-math.log((1 - ClsHead.PRIOR) / ClsHead.PRIOR))
            elif isinstance(m, MSDeformAttention):
                m.sampling_offsets.weight.zero_()
                m.attention_weights.weight.zero_()
                fill(m.sampling_offsets.bias, lambda m=m: torch.from_numpy(
                    sampling_offsets_init_bias(m.n_heads, m.n_levels,
                                               m.n_points)))
        head = self.bbox_head
        normal(head.transformer.level_embed)
        for reg in (head.fc_reg[0], head.fc_enc_reg):
            reg.layers[-1].weight.zero_()
            reg.layers[-1].bias.zero_()
        return self

    def features(self, images):
        """images: (B, H, W, 3) normalized float. Returns (srcs NCHW,
        spatial_shapes). uint8 batches go through `prepare_images` first
        (encode_images does)."""
        c = self.cfg
        x = images.permute(0, 3, 1, 2).to(self.compute_dtype)
        feats = self.backbone(x)
        srcs = []
        for i, proj in enumerate(self.bbox_head.input_proj):
            if i < len(feats):
                x = feats[i]
            elif i == len(feats):
                x = feats[-1]        # extra level from raw C5
            else:
                x = srcs[-1]
            srcs.append(proj(x))
        shapes = tuple((int(s.shape[2]), int(s.shape[3])) for s in srcs)
        return srcs, shapes

    def encode_images(self, images, img_hw, features=None):
        """Backbone + input projections + encoder + two-stage selection.

        Returns the transformer's encode dict plus 'spatial_shapes' and
        'srcs'. uint8 batches are normalized on the device here."""
        images = prepare_images(images, img_hw)
        srcs, shapes = self.features(images) if features is None else features
        vmasks = level_valid_masks(
            shapes, (images.shape[1], images.shape[2]), img_hw)
        head = self.bbox_head
        enc = head.transformer.encode(srcs, vmasks, shapes,
                                      head.fc_enc_reg, head.fc_enc_cls)
        enc["spatial_shapes"] = shapes
        enc["srcs"] = srcs
        return enc

    def decode_queries(self, enc, extra_tgt=None, extra_ref_unsig=None,
                       attn_mask: Optional[torch.Tensor] = None):
        """Decoder over [front blocks | matching queries].

        extra_tgt/extra_ref_unsig: (B, n_front, C)/(B, n_front, 4)
        prepended query blocks; attn_mask: (T, T) bool True=blocked.
        Returns cls/coord per decoder layer for the matching block (and
        front_cls/front_coord for the front block), the encoder's interim
        outputs and hs."""
        head = self.bbox_head
        tgt, refpoint_unsig = enc["tgt"], enc["refpoint_unsig"]
        n_front = 0
        if extra_tgt is not None:
            n_front = extra_tgt.shape[1]
            tgt = torch.cat([extra_tgt.to(tgt.dtype), tgt], 1)
            refpoint_unsig = torch.cat(
                [extra_ref_unsig.float(), refpoint_unsig], 1)
        hs, refs = head.transformer.decode(
            enc["memory"], enc["pad_mask"], enc["valid_ratios"],
            enc["spatial_shapes"], tgt, refpoint_unsig, attn_mask,
            head.fc_reg[0])
        all_cls = head.fc_cls[0](hs).float()        # (n_dec, B, nq_t, K)
        all_coord = (head.fc_reg[0](hs).float()
                     + inverse_sigmoid(refs[:-1])).sigmoid()
        out = {
            "cls": all_cls[:, :, n_front:],
            "coord": all_coord[:, :, n_front:],
            "enc_cls": enc["enc_out_class"].float(),
            "enc_coord": enc["enc_out_coord"],
            "hs": hs,
            "n_front": n_front,
        }
        if n_front:
            out["front_cls"] = all_cls[:, :, :n_front]
            out["front_coord"] = all_coord[:, :, :n_front]
        return out

    def build_cdn(self, gt, generator: torch.Generator) -> CdnBatch:
        """The CDN block for `gt` (dict of boxes (B,G,4) cxcywh-normalized,
        labels (B,G), valid (B,G)), its noise drawn from `generator`."""
        c = self.cfg
        noise = draw_cdn_noise(generator, gt["valid"].shape[0],
                               c.dn_pad_size, c.num_classes,
                               gt["boxes"].device)
        return build_cdn_queries(
            noise, gt["boxes"], gt["labels"], gt["valid"],
            self.bbox_head.label_enc.weight, c.num_classes, c.dn_single_pad,
            c.dn_groups, c.dn_label_noise_ratio, c.dn_box_noise_scale)

    def forward(self, images, img_hw, gt=None,
                generator: Optional[torch.Generator] = None,
                extra_queries=None, enc=None):
        """Full forward.

        images: (B, H, W, 3) uint8 or normalized float; img_hw: (B, 2)
        valid (h, w). gt: optional dict(boxes (B,G,4) cxcywh-normalized,
        labels (B,G), valid (B,G)): builds the CDN block, whose noise is
        drawn from `generator` (required with gt). extra_queries: optional
        dict(content (B,Q1,C), bbox_unsig (B,Q1,4), attn_mask (T,T) bool
        True=blocked, optional cdn) of prepended front queries, used
        instead of gt. enc: optional precomputed `encode_images` dict.

        Returns per-decoder-layer class/coord for the matching block, the
        front block (front_cls/front_coord), the encoder's interim outputs
        and, with gt or a cdn entry, the CdnBatch under "cdn"."""
        if enc is None:
            enc = self.encode_images(images, img_hw)
        cdn = None
        if extra_queries is not None:
            cdn = extra_queries.get("cdn")
            out = self.decode_queries(enc, extra_queries["content"],
                                      extra_queries["bbox_unsig"],
                                      extra_queries["attn_mask"])
        elif gt is not None:
            if generator is None:
                raise ValueError("a forward with gt needs a generator for "
                                 "the CDN noise")
            cdn = self.build_cdn(gt, generator)
            mask = cdn_attn_mask(cdn.single_pad, cdn.groups,
                                 self.cfg.num_queries,
                                 capacity=self.cfg.dn_pad_size)
            out = self.decode_queries(enc, cdn.query_label, cdn.query_bbox,
                                      mask)
        else:
            out = self.decode_queries(enc)
        if cdn is not None:
            out["cdn"] = cdn
        return out
