"""Post-norm transformer encoder (counterpart of
``sessionsimilaritysearch_tpu/models/transformer.py:48-138``).

Attention is written with plain tensor ops, as the JAX code does, so both
masking semantics match exactly: an additive ``attn_mask`` [Lq, Lk] is added
to the scores first, key-padding positions are then filled with
``finfo.min`` before the softmax, and query rows whose keys are all padding
get zero attention (the JAX code zeroes them, :65-71).

Dropout sits where the JAX ``EncoderLayer`` has it: on the attention block's
output, on the FFN's hidden activations and on the FFN's output. The JAX
``_attention`` takes a ``dropout`` argument but never applies it to the
attention weights, so the port drops no attention weight either. Every
dropout draws its mask from an explicit ``torch.Generator`` and is off when
``deterministic`` (or at rate 0, as Flax's ``Dropout`` returns its input).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

LN_EPS = 1e-6  # flax.linen.LayerNorm's epsilon (torch's default is 1e-5)


def dropout(x, rate: float, deterministic: bool,
            generator: Optional[torch.Generator] = None):
    """Flax ``nn.Dropout``: keep each entry with probability ``1 - rate``
    and scale the kept ones by ``1 / (1 - rate)``; the input itself when
    ``deterministic`` or ``rate == 0``. The keep mask is drawn from
    ``generator`` (on ``x``'s device), which must be given when it is."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a torch.Generator when it is on")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _attention(q, k, v, nhead: int, key_padding_mask: Optional[torch.Tensor],
               attn_mask: Optional[torch.Tensor] = None):
    """q/k/v [B, L, D] already projected; key_padding_mask [B, Lk] with
    True = PAD; attn_mask [Lq, Lk] additive (-inf blocks) or None.
    Returns [B, Lq, D]."""
    B, Lq, D = q.shape
    Lk = k.shape[1]
    hd = D // nhead
    q = q.reshape(B, Lq, nhead, hd).transpose(1, 2)
    k = k.reshape(B, Lk, nhead, hd).transpose(1, 2)
    v = v.reshape(B, Lk, nhead, hd).transpose(1, 2)
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
    if attn_mask is not None:
        scores = scores + attn_mask[None, None, :, :]
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

    def forward(self, query, key, value, key_padding_mask=None, attn_mask=None):
        out = _attention(
            self.q_proj(query), self.k_proj(key), self.v_proj(value),
            self.nhead, key_padding_mask, attn_mask,
        )
        return self.out_proj(out)


class EncoderLayer(nn.Module):
    """Post-norm ``nn.TransformerEncoderLayer`` semantics with a ReLU FFN."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, device=device)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.ffn_in = nn.Linear(d_model, dim_feedforward, device=device)
        self.ffn_out = nn.Linear(dim_feedforward, d_model, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)

    def forward(self, x, key_padding_mask=None, attn_mask=None,
                deterministic: bool = True, generator=None):
        def drop(t):
            return dropout(t, self.dropout, deterministic, generator)

        a = drop(self.self_attn(x, x, x, key_padding_mask, attn_mask))
        x = self.norm1(x + a)
        f = drop(self.ffn_out(drop(torch.relu(self.ffn_in(x)))))
        return self.norm2(x + f)


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 nlayers: int, dropout: float = 0.0, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, nhead, dim_feedforward, dropout, device=device)
            for _ in range(nlayers)
        )

    def forward(self, x, key_padding_mask=None, attn_mask=None,
                deterministic: bool = True, generator=None):
        """x [B, L, D]; key_padding_mask [B, L] True = PAD; attn_mask
        [L, L] additive. (The JAX module takes attn_mask before
        key_padding_mask; the port keeps its own serving order.)"""
        for layer in self.layers:
            x = layer(x, key_padding_mask, attn_mask, deterministic, generator)
        return x
