"""Projection-free multi-head attention (the reference's legacy MHA).

Counterpart of `semi_detr_tpu/models/attention.py`: the reference's
DAB-DETR-style `MultiheadAttention` without input projections
(`detr_od/models/utils/attention.py:54-387`). The caller supplies
projected q / k / v; the module scales q by head_dim**-0.5, splits heads,
applies the attention and key-padding masks, takes the softmax and runs
one output Linear(vdim, vdim) (`attention.py:96,380-383`). The live
decoder uses `MultiheadSelfAttention` (`models/transformer.py`); this
module is for variants built on the reference's API.

Batch-first (B, L, E); the logits and the softmax in float32 whatever the
input dtype; masks are boolean (True = blocked, the lowest float32 value,
as the JAX package) or additive, as the reference's
(`attention.py:356-372`). Dropout on the attention weights in training
mode, as `attention.py:378`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

NEG_INF = torch.finfo(torch.float32).min


class LegacyMultiheadAttention(nn.Module):
    """q / k / v are used as given (no input projections).

    Shapes: query (B, L, E); key (B, S, E); value (B, S, vdim);
    key_padding_mask (B, S) bool, True = masked; attn_mask (L, S) or
    (B*heads, L, S), bool True = blocked or float added to the logits.
    Returns (out (B, L, vdim), head-averaged weights (B, L, S)), like
    `attention.py:384-387`. The parameter is the reference's
    `out_proj.weight` / `out_proj.bias`.
    """

    def __init__(self, embed_dim: int, num_heads: int,
                 vdim: Optional[int] = None, dropout: float = 0.0):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.vdim = embed_dim if vdim is None else vdim
        if embed_dim % num_heads or self.vdim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} and vdim {self.vdim} "
                             f"must be multiples of num_heads {num_heads}")
        self.dropout = dropout
        self.out_proj = nn.Linear(self.vdim, self.vdim)

    def forward(self, query, key, value,
                key_padding_mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, l, e = query.shape
        s = key.shape[1]
        h = self.num_heads
        hd, vhd = e // h, self.vdim // h
        q = (query * hd ** -0.5).reshape(b, l, h, hd)
        k = key.reshape(b, s, h, hd)
        v = value.reshape(b, s, h, vhd)
        logits = torch.einsum("blhd,bshd->bhls", q.float(), k.float())
        if attn_mask is not None:
            m = (attn_mask[None, None] if attn_mask.dim() == 2
                 else attn_mask.reshape(b, h, l, s))
            if m.dtype == torch.bool:
                logits = logits.masked_fill(m, NEG_INF)
            else:
                logits = logits + m.float()
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                        NEG_INF)
        w = logits.softmax(-1)
        if self.dropout > 0.0 and self.training:
            w = F.dropout(w, self.dropout)
        out = torch.einsum("bhls,bshd->blhd", w.to(value.dtype), v)
        out = out.reshape(b, l, self.vdim)
        wt = self.out_proj.weight
        return self.out_proj(out.to(wt.dtype)), w.mean(1)


def legacy_mha_state_dict_from_jax(params) -> dict:
    """The JAX module's parameters ({"out_proj": {"kernel", "bias"}}) as
    this module's state dict."""
    import numpy as np
    p = params["out_proj"]
    return {"out_proj.weight": torch.from_numpy(
                np.ascontiguousarray(np.asarray(p["kernel"]).T)),
            "out_proj.bias": torch.from_numpy(np.asarray(p["bias"]))}
