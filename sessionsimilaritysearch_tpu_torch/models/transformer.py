"""Post-norm transformer encoder and decoder (counterparts of
``sessionsimilaritysearch_tpu/models/transformer.py``: ``sinusoidal_pe`` :21,
``PositionalEncoding`` :34, ``_attention`` and the encoder :48-138,
``DecoderLayer`` :141, ``TransformerDecoder`` :178 and ``causal_mask`` :211).

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

import numpy as np
import torch
from torch import nn

LN_EPS = 1e-6  # flax.linen.LayerNorm's epsilon (torch's default is 1e-5)


def sinusoidal_pe(max_len: int, d_model: int) -> np.ndarray:
    """The standard sine/cosine positional table [max_len, d_model], computed
    in float32 numpy exactly as the JAX package computes it."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * (-math.log(10000.0) / d_model)
    )
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term[: pe[:, 1::2].shape[1]])
    return pe


def causal_mask(size: int, device=None) -> torch.Tensor:
    """Upper-triangular -inf additive mask [size, size] (torch's
    ``generate_square_subsequent_mask``)."""
    return torch.triu(torch.full((size, size), float("-inf"), device=device), diagonal=1)


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


class PositionalEncoding(nn.Module):
    """Adds the sinusoidal table, then dropout. The table is a buffer left
    out of the ``state_dict`` (Flax recomputes it and keeps no parameter)."""

    def __init__(self, d_model: int, dropout: float = 0.1, max_len: int = 5000,
                 device=None):
        super().__init__()
        self.dropout = dropout
        self.register_buffer("pe", torch.from_numpy(sinusoidal_pe(max_len, d_model)).to(device),
                             persistent=False)

    def forward(self, x, deterministic: bool = True, generator=None):
        x = x + self.pe[None, : x.shape[1], :].to(x.dtype)
        return dropout(x, self.dropout, deterministic, generator)


class DecoderLayer(nn.Module):
    """Post-norm ``nn.TransformerDecoderLayer``: self-attention (``self_attn``,
    ``norm1``) -> cross-attention over the memory (``cross_attn``, ``norm2``)
    -> ReLU FFN (``ffn_in``, ``ffn_out``, ``norm3``); dropout where the JAX
    layer has it. A query row whose keys are all padding gets zero attention
    (``_attention``), as in JAX: the decoder's rows for a session with no
    target query are such rows."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, device=device)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.cross_attn = MultiHeadAttention(d_model, nhead, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.ffn_in = nn.Linear(d_model, dim_feedforward, device=device)
        self.ffn_out = nn.Linear(dim_feedforward, d_model, device=device)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)

    def forward(self, tgt, memory, tgt_mask=None, tgt_key_padding_mask=None,
                memory_key_padding_mask=None, deterministic: bool = True, generator=None):
        def drop(t):
            return dropout(t, self.dropout, deterministic, generator)

        a = drop(self.self_attn(tgt, tgt, tgt, tgt_key_padding_mask, tgt_mask))
        x = self.norm1(tgt + a)
        c = drop(self.cross_attn(x, memory, memory, memory_key_padding_mask))
        x = self.norm2(x + c)
        f = drop(self.ffn_out(drop(torch.relu(self.ffn_in(x)))))
        return self.norm3(x + f)


class TransformerDecoder(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 nlayers: int, dropout: float = 0.0, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, nhead, dim_feedforward, dropout, device=device)
            for _ in range(nlayers)
        )

    def forward(self, tgt, memory, tgt_mask=None, tgt_key_padding_mask=None,
                memory_key_padding_mask=None, deterministic: bool = True, generator=None):
        """tgt [B, T, D]; memory [B, S, D]; tgt_mask [T, T] additive;
        the padding masks [B, T] / [B, S] with True = PAD."""
        x = tgt
        for layer in self.layers:
            x = layer(x, memory, tgt_mask, tgt_key_padding_mask, memory_key_padding_mask,
                      deterministic, generator)
        return x
