"""DINO deformable transformer.

Counterpart of `semi_detr_tpu/models/transformer.py`: 6-layer deformable
encoder over flattened multi-scale tokens (row-major token order), standard
two-stage query selection (top-`num_queries` encoder proposals), 6-layer
decoder with [self-attn, deformable cross-attn, FFN] and detached iterative
box refinement, learned target embeddings, and a static attention mask for
prepended query blocks.

Module and parameter names are the reference's
(`bbox_head.transformer.*` of a DINO state dict). No dropout: the reference
config runs with dropout 0.

Dtype policy (as in the JAX package): parameters are stored in float32 and
every layer computes in the model's compute dtype (`models/layers.py`),
except the sampling offsets and attention logits, which compute in float32
because sampling coordinates are precision-sensitive.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.ms_deform_attn_cuda import ms_deform_attn_auto
from .layers import CastMixin, LayerNorm, Linear


def inverse_sigmoid(x, eps: float = 1e-5):
    """mmdet inverse_sigmoid (clamped logit, eps=1e-5)."""
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def _sin_cos(p):
    """[sin(p[..., 0::2]), cos(p[..., 1::2])] interleaved on the last axis."""
    return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()],
                       -1).flatten(-2)


def _dim_t(num_feats, temperature, device):
    d = torch.arange(num_feats, dtype=torch.float32, device=device)
    return temperature ** (2 * torch.div(d, 2, rounding_mode="floor")
                           / num_feats)


def sine_embed(pos, num_feats: int = 128, temperature: float = 10000.0,
               scale: float = 2 * math.pi):
    """Sine embedding of normalized coords (reference
    `gen_sineembed_for_position`): (..., K) -> (..., K*num_feats), with y
    embedded before x (then w, h)."""
    dim_t = _dim_t(num_feats, temperature, pos.device)
    order = [1, 0] if pos.shape[-1] == 2 else [1, 0, 2, 3]
    return torch.cat([_sin_cos(pos[..., i, None] * scale / dim_t)
                      for i in order], -1)


def sine_positional_encoding_hw(valid_mask, num_feats: int = 128,
                                temp_h: float = 20.0, temp_w: float = 20.0,
                                scale: float = 2 * math.pi,
                                offset: float = 0.0, eps: float = 1e-6):
    """SinePositionalEncodingHW with normalize=True.

    valid_mask: (B, H, W) bool, True = valid pixel. Returns (B, H, W, 2F).
    """
    not_mask = valid_mask.float()
    y = not_mask.cumsum(1)
    x = not_mask.cumsum(2)
    y = (y + offset) / (y[:, -1:, :] + eps) * scale
    x = (x + offset) / (x[:, :, -1:] + eps) * scale
    dev = valid_mask.device
    return torch.cat([_sin_cos(y[..., None] / _dim_t(num_feats, temp_h, dev)),
                      _sin_cos(x[..., None] / _dim_t(num_feats, temp_w, dev))],
                     -1)


class Mlp(nn.Module):
    """`MLP` of the reference (relu between layers, none after the last)."""

    def __init__(self, din: int, hidden: int, out: int, num_layers: int = 3):
        super().__init__()
        dims = [din] + [hidden] * (num_layers - 1) + [out]
        self.layers = nn.ModuleList(Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MSDeformAttention(nn.Module):
    """Query-conditioned multi-scale deformable attention (reference
    `MSDeformAttn`): value/output projections plus per-query sampling
    offsets and softmaxed attention weights."""

    def __init__(self, d_model: int = 256, n_heads: int = 8,
                 n_levels: int = 4, n_points: int = 4):
        super().__init__()
        self.d_model, self.n_heads = d_model, n_heads
        self.n_levels, self.n_points = n_levels, n_points
        self.sampling_offsets = Linear(d_model,
                                       n_heads * n_levels * n_points * 2)
        self.attention_weights = Linear(d_model,
                                        n_heads * n_levels * n_points)
        self.value_proj = Linear(d_model, d_model)
        self.output_proj = Linear(d_model, d_model)
        # computed in float32 whatever the compute dtype (module docstring)
        self.sampling_offsets.keep_float32 = True
        self.attention_weights.keep_float32 = True

    def forward(self, query, reference_points, value_src, spatial_shapes,
                key_padding_mask=None):
        """query: (B, Lq, C); reference_points: (B, Lq, L, 2|4) in [0,1];
        value_src: (B, S, C); key_padding_mask: (B, S) True=PAD."""
        B, Lq, _ = query.shape
        M, L, P = self.n_heads, self.n_levels, self.n_points
        D = self.d_model // M
        value = self.value_proj(value_src)
        if key_padding_mask is not None:
            value = value.masked_fill(key_padding_mask[..., None], 0.0)
        value = value.view(B, -1, M, D)

        q32 = query.float()
        offsets = self.sampling_offsets(q32).view(B, Lq, M, L, P, 2)
        attn = self.attention_weights(q32).view(B, Lq, M, L * P)
        attn = attn.softmax(-1).view(B, Lq, M, L, P)

        ref = reference_points.float()
        if ref.shape[-1] == 2:
            wh = torch.tensor([[w, h] for h, w in spatial_shapes],
                              dtype=torch.float32, device=query.device)
            loc = (ref[:, :, None, :, None, :]
                   + offsets / wh[None, None, None, :, None, :])
        else:
            loc = (ref[:, :, None, :, None, :2]
                   + offsets / P * ref[:, :, None, :, None, 2:] * 0.5)
        out = ms_deform_attn_auto(value.contiguous(), tuple(spatial_shapes),
                                  loc.contiguous(), attn.contiguous())
        return self.output_proj(out)


class MultiheadSelfAttention(CastMixin, nn.Module):
    """Multi-head attention with the parameter names of
    `torch.nn.MultiheadAttention` (`in_proj_weight` rows [q; k; v],
    `out_proj`), written out in plain ops. A masked logit takes the
    dtype's lowest value, so a fully masked row gets uniform weights, as
    in the JAX package."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model)

    def forward(self, q_in, k_in, v_in, attn_mask=None):
        """attn_mask: (Lq, Lk) bool, True = blocked."""
        B, Lq, C = q_in.shape
        H = self.n_heads
        dt = self._dtype(self.in_proj_weight)
        q_in, k_in, v_in = q_in.to(dt), k_in.to(dt), v_in.to(dt)
        wq, wk, wv = self.in_proj_weight.to(dt).chunk(3)
        bq, bk, bv = self.in_proj_bias.to(dt).chunk(3)
        q = F.linear(q_in, wq, bq).view(B, Lq, H, -1).transpose(1, 2)
        k = F.linear(k_in, wk, bk).view(B, -1, H, C // H).transpose(1, 2)
        v = F.linear(v_in, wv, bv).view(B, -1, H, C // H).transpose(1, 2)
        logits = (q / math.sqrt(C // H)) @ k.transpose(-1, -2)
        if attn_mask is not None:
            logits = logits.masked_fill(attn_mask,
                                        torch.finfo(logits.dtype).min)
        w = logits.float().softmax(-1).to(v.dtype)
        out = (w @ v).transpose(1, 2).reshape(B, Lq, C)
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """Deformable self-attention + FFN (reference
    `DINOTransformerEncoderLayer`)."""

    def __init__(self, d_model=256, d_ffn=2048, n_heads=8, n_levels=4,
                 n_points=4):
        super().__init__()
        self.self_attn = MSDeformAttention(d_model, n_heads, n_levels,
                                           n_points)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self.norm2 = LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, reference_points, spatial_shapes,
                key_padding_mask):
        h = self.self_attn(src + pos, reference_points, src, spatial_shapes,
                           key_padding_mask)
        src = self.norm1(src + h)
        f = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + f)


def encoder_reference_points(spatial_shapes, valid_ratios):
    """Per-level normalized center grid scaled by valid ratios (reference
    `DINOTransformerEncoder.get_reference_points`).

    valid_ratios: (B, L, 2) as (w_ratio, h_ratio). Returns (B, S, L, 2)."""
    dev = valid_ratios.device
    refs = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        gy, gx = np.meshgrid(np.arange(h, dtype=np.float32) + 0.5,
                             np.arange(w, dtype=np.float32) + 0.5,
                             indexing="ij")
        gy = torch.from_numpy(gy.reshape(-1)).to(dev)[None] / (
            valid_ratios[:, None, lvl, 1] * h)
        gx = torch.from_numpy(gx.reshape(-1)).to(dev)[None] / (
            valid_ratios[:, None, lvl, 0] * w)
        refs.append(torch.stack([gx, gy], -1))
    ref = torch.cat(refs, 1)                                   # (B, S, 2)
    return ref[:, :, None] * valid_ratios[:, None]


def make_proposals(spatial_shapes, valid_ratios):
    """Anchor proposals per token (reference
    `gen_encoder_output_proposals`): grid centers normalized by the valid
    extent, wh = 0.05 * 2**lvl. Returns (B, S, 4), unclipped."""
    dev = valid_ratios.device
    out = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        gy, gx = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
        grid = torch.from_numpy(
            np.stack([gx.reshape(-1), gy.reshape(-1)], -1)).to(dev)
        scale = valid_ratios[:, None, lvl, :] * torch.tensor(
            [[float(w), float(h)]], device=dev)
        ctr = (grid[None] + 0.5) / scale
        wh = torch.full_like(ctr, 0.05 * (2.0 ** lvl))
        out.append(torch.cat([ctr, wh], -1))
    return torch.cat(out, 1)


class DecoderLayer(nn.Module):
    """[self-attn, deformable cross-attn, FFN] (reference
    `DINOTransformerDecoderLayer`)."""

    def __init__(self, d_model=256, d_ffn=2048, n_heads=8, n_levels=4,
                 n_points=4):
        super().__init__()
        self.self_attn = MultiheadSelfAttention(d_model, n_heads)
        self.norm2 = LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MSDeformAttention(d_model, n_heads, n_levels,
                                            n_points)
        self.norm1 = LayerNorm(d_model, eps=1e-5)
        self.linear1 = Linear(d_model, d_ffn)
        self.linear2 = Linear(d_ffn, d_model)
        self.norm3 = LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, query_pos, reference_points_input, memory,
                spatial_shapes, memory_key_padding_mask, self_attn_mask):
        q = tgt + query_pos
        h = self.self_attn(q, q, tgt, self_attn_mask)
        tgt = self.norm2(tgt + h)
        h = self.cross_attn(tgt + query_pos, reference_points_input, memory,
                            spatial_shapes, memory_key_padding_mask)
        tgt = self.norm1(tgt + h)
        f = self.linear2(F.relu(self.linear1(tgt)))
        return self.norm3(tgt + f)


class _Encoder(nn.Module):
    def __init__(self, n_layers, **kw):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(**kw)
                                    for _ in range(n_layers))


class _Decoder(nn.Module):
    def __init__(self, n_layers, d_model, **kw):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(d_model, **kw)
                                    for _ in range(n_layers))
        self.norm = LayerNorm(d_model, eps=1e-5)
        self.ref_point_head = Mlp(2 * d_model, d_model, d_model, 2)


class DINOTransformer(nn.Module):
    """Encoder + two-stage selection + decoder with iterative refinement.

    The box and class heads (`fc_reg`, `fc_enc_reg`, `fc_enc_cls`) are
    owned by the detection head and passed in, as in the reference."""

    def __init__(self, d_model=256, n_heads=8, num_queries=900,
                 num_encoder_layers=6, num_decoder_layers=6, d_ffn=2048,
                 n_levels=4, enc_n_points=4, dec_n_points=4):
        super().__init__()
        self.d_model, self.num_queries = d_model, num_queries
        self.level_embed = nn.Parameter(torch.zeros(n_levels, d_model))
        self.tgt_embed = nn.Embedding(num_queries, d_model)
        self.encoder = _Encoder(num_encoder_layers, d_model=d_model,
                                d_ffn=d_ffn, n_heads=n_heads,
                                n_levels=n_levels, n_points=enc_n_points)
        self.decoder = _Decoder(num_decoder_layers, d_model, d_ffn=d_ffn,
                                n_heads=n_heads, n_levels=n_levels,
                                n_points=dec_n_points)
        self.enc_output = Linear(d_model, d_model)
        self.enc_output_norm = LayerNorm(d_model, eps=1e-5)

    @property
    def compute_dtype(self):
        return self.enc_output.compute_dtype or self.enc_output.weight.dtype

    def encode(self, srcs: List[torch.Tensor], valid_masks, spatial_shapes,
               fc_enc_reg, fc_enc_cls):
        """Flatten + deformable encoder + two-stage top-k selection.

        srcs: list of (B, C, H_l, W_l) projected features; valid_masks:
        list of (B, H_l, W_l) bool, True = valid. Returns dict: memory
        (B, S, C), pad_mask (B, S) True=PAD, valid_ratios (B, L, 2),
        matching query init (tgt (B,nq,C), refpoint_unsig (B,nq,4)) and the
        encoder's interim outputs.
        """
        dtype = self.compute_dtype
        B = srcs[0].shape[0]
        src_flat = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
        pad_mask = torch.cat([~m.reshape(B, -1) for m in valid_masks], 1)
        pos_flat = torch.cat(
            [sine_positional_encoding_hw(m, self.d_model // 2).reshape(
                B, -1, self.d_model) + self.level_embed[lvl].float()
             for lvl, m in enumerate(valid_masks)], 1).to(dtype)
        # valid ratios (reference get_valid_ratio: first row/col of mask)
        vr = torch.stack(
            [torch.stack([m[:, 0, :].sum(1) / m.shape[2],
                          m[:, :, 0].sum(1) / m.shape[1]], -1)
             for m in valid_masks], 1).float()                 # (B, L, 2) w,h

        enc_ref = encoder_reference_points(spatial_shapes, vr)
        memory = src_flat
        for layer in self.encoder.layers:
            memory = layer(memory, pos_flat, enc_ref, spatial_shapes,
                           pad_mask)

        proposals = make_proposals(spatial_shapes, vr)         # (B, S, 4)
        prop_valid = ((proposals > 0.01) & (proposals < 0.99)).all(-1)
        token_valid = prop_valid & ~pad_mask
        out_memory = memory.masked_fill(~token_valid[..., None], 0.0)
        out_memory = self.enc_output_norm(self.enc_output(out_memory))

        enc_cls = fc_enc_cls(out_memory)                       # (B, S, K)
        enc_coord_unsig = fc_enc_reg(out_memory) + inverse_sigmoid(proposals)
        score = enc_cls.amax(-1).masked_fill(~token_valid, -1e9)
        topk_idx = torch.topk(score, self.num_queries, dim=1)[1]

        def take(x):
            return torch.gather(
                x, 1, topk_idx[..., None].expand(-1, -1, x.shape[-1]))

        ref_undetach = take(enc_coord_unsig)
        tgt = self.tgt_embed.weight[None].expand(
            B, -1, -1).to(dtype)
        return {
            "memory": memory,
            "pad_mask": pad_mask,
            "valid_ratios": vr,
            "tgt": tgt,
            "refpoint_unsig": ref_undetach.detach(),
            "enc_out_class": take(enc_cls),
            "enc_out_coord": ref_undetach.sigmoid(),
        }

    def decode(self, memory, pad_mask, valid_ratios, spatial_shapes, tgt,
               refpoint_unsig, attn_mask: Optional[torch.Tensor], fc_reg
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Decoder with detached iterative box refinement.

        tgt: (B, nq_t, C) content queries (front blocks + matching);
        refpoint_unsig: (B, nq_t, 4); attn_mask: (nq_t, nq_t) bool
        True=blocked, or None. Returns (hs (n_dec, B, nq_t, C) normed,
        refs (n_dec+1, B, nq_t, 4) sigmoided)."""
        output = tgt.to(self.compute_dtype)
        reference = refpoint_unsig.sigmoid()
        vr4 = torch.cat([valid_ratios, valid_ratios], -1)      # (B, L, 4)
        hs_raw, refs = [], [reference]
        for layer in self.decoder.layers:
            ref_input = reference[:, :, None] * vr4[:, None]   # (B,nq,L,4)
            qse = sine_embed(ref_input[:, :, 0, :], self.d_model // 2)
            query_pos = self.decoder.ref_point_head(qse)
            output = layer(output, query_pos, ref_input, memory,
                           spatial_shapes, pad_mask, attn_mask)
            new_ref = (fc_reg(output) + inverse_sigmoid(reference)).sigmoid()
            reference = new_ref.detach()
            hs_raw.append(output)
            refs.append(new_ref)
        hs = self.decoder.norm(torch.stack(hs_raw))
        return hs, torch.stack(refs)
