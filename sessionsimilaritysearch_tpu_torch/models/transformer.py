"""Post-norm transformer encoder (counterpart of
``sessionsimilaritysearch_tpu/models/transformer.py:48-138``).

Attention is written with plain tensor ops, as the JAX code does, so both
masking semantics match exactly: key-padding positions are filled with
``finfo.min`` before the softmax, and query rows whose keys are all padding
get zero attention (the JAX code zeroes them, :65-71).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

LN_EPS = 1e-6  # flax.linen.LayerNorm's epsilon (torch's default is 1e-5)


def _attention(q, k, v, nhead: int, key_padding_mask: Optional[torch.Tensor]):
    """q/k/v [B, L, D] already projected; key_padding_mask [B, Lk] with
    True = PAD. Returns [B, Lq, D]."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    hd = D // nhead
    q = q.reshape(B, Lq, nhead, hd).transpose(1, 2)
    k = k.reshape(B, Lk, nhead, hd).transpose(1, 2)
    v = v.reshape(B, Lk, nhead, hd).transpose(1, 2)
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    if key_padding_mask is not None:
        scores = scores.masked_fill(
            key_padding_mask[:, None, None, :], torch.finfo(scores.dtype).min
        )
    att = torch.softmax(scores, dim=-1)
    if key_padding_mask is not None:
        all_masked = key_padding_mask.all(dim=-1)
        att = att.masked_fill(all_masked[:, None, None, None], 0.0)
    out = torch.matmul(att, v)
    return out.transpose(1, 2).reshape(B, Lq, D)


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, nhead: int, device=None):
        super().__init__()
        self.nhead = nhead
        self.q_proj = nn.Linear(d_model, d_model, device=device)
        self.k_proj = nn.Linear(d_model, d_model, device=device)
        self.v_proj = nn.Linear(d_model, d_model, device=device)
        self.out_proj = nn.Linear(d_model, d_model, device=device)

    def forward(self, query, key, value, key_padding_mask=None):
        out = _attention(
            self.q_proj(query), self.k_proj(key), self.v_proj(value),
            self.nhead, key_padding_mask,
        )
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """Post-norm ``nn.TransformerEncoderLayer`` semantics with a ReLU FFN.
    Inference only: the JAX serving path runs with dropout off."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, device=None):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead, device=device)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.ffn_in = nn.Linear(d_model, dim_feedforward, device=device)
        self.ffn_out = nn.Linear(dim_feedforward, d_model, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)

    def forward(self, x, key_padding_mask=None):
        x = self.norm1(x + self.self_attn(x, x, x, key_padding_mask))
        return self.norm2(x + self.ffn_out(torch.relu(self.ffn_in(x))))


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 nlayers: int, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, nhead, dim_feedforward, device=device)
            for _ in range(nlayers)
        )

    def forward(self, x, key_padding_mask=None):
        for layer in self.layers:
            x = layer(x, key_padding_mask)
        return x
