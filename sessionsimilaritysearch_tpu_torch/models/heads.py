"""Projection, hashing and generation heads (counterparts of
``sessionsimilaritysearch_tpu/models/heads.py:23`` ``MLP``, ``:53``
``BinarizeHead``, ``:92`` ``TransformerDecoderHead`` and ``:127``
``CrossAttentionTransformer``).

``BatchNorm`` writes Flax's ``nn.BatchNorm`` out rather than using
``torch.nn.BatchNorm1d``, whose running variance is the unbiased batch
variance (2% off at a batch of 50) and whose momentum counts the other way.
Flax, with its defaults: the batch statistics over every axis but the last,
``var = max(0, mean(x^2) - mean(x)^2)`` (biased), ``y = (x - mean) *
rsqrt(var + 1e-5) * scale + bias``, and in training the running statistics
become ``0.99 * running + 0.01 * batch``; ``deterministic`` normalizes by
the running statistics and leaves them as they are. The running statistics
are buffers named as Flax's ``batch_stats`` leaves, ``mean`` and ``var``.

The batch statistics are those of the global batch of ``group`` (a
``parallel.sharding.BatchGroup``; by default ``ALONE``, this process by
itself): every rank holds as many rows, so the means of x and x^2 over
the global batch are the average over the ranks of each rank's means
(summed with their gradient), and in a data-parallel step every rank
normalizes by, and updates its running statistics with, the same values.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sessionsimilaritysearch_tpu_torch.parallel.sharding import ALONE, BatchGroup

from sessionsimilaritysearch_tpu_torch.models.transformer import (
    PositionalEncoding,
    TransformerDecoder,
    TransformerEncoder,
    dropout,
)

BN_MOMENTUM = 0.99
BN_EPS = 1e-5


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm`` over the last axis (see the module docstring)."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, device=device))  # Flax 'scale'
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x, deterministic: bool = True, group: BatchGroup = ALONE):
        if deterministic:
            return (x - self.mean) * (torch.rsqrt(self.var + BN_EPS) * self.weight) + self.bias
        flat = x.reshape(-1, x.shape[-1])
        c = flat.shape[-1]
        means = group.sum(torch.cat([flat.mean(dim=0), (flat * flat).mean(dim=0)]) / group.world)
        mean = means[:c]
        var = torch.clamp(means[c:] - mean * mean, min=0.0)
        with torch.no_grad():
            self.mean.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * mean)
            self.var.mul_(BN_MOMENTUM).add_((1.0 - BN_MOMENTUM) * var)
        return (x - mean) * (torch.rsqrt(var + BN_EPS) * self.weight) + self.bias


class MLP(nn.Module):
    """Linear -> BatchNorm -> ReLU -> Dropout for each of the
    ``1 + n_hidden_layers`` hidden layers (``dense_{i}``, ``bn_{i}``), then
    ``dense_out``, tanh last when ``last_act``. The JAX module's ``jump``
    (input concat) is used by no trainer and is not ported."""

    def __init__(self, in_features: int, n_output: int, n_hidden: int,
                 n_hidden_layers: int = 0, dropout: float = 0.0,
                 last_act: bool = True, device=None):
        super().__init__()
        self.depth = 1 + n_hidden_layers
        self.dropout = dropout
        self.last_act = last_act
        width = in_features
        for i in range(self.depth):
            self.add_module(f"dense_{i}", nn.Linear(width, n_hidden, device=device))
            self.add_module(f"bn_{i}", BatchNorm(n_hidden, device=device))
            width = n_hidden
        self.dense_out = nn.Linear(width, n_output, device=device)

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, group: BatchGroup = ALONE):
        """``group``: the data-parallel step's ranks, for the BatchNorms'
        global-batch statistics."""
        for i in range(self.depth):
            x = getattr(self, f"bn_{i}")(getattr(self, f"dense_{i}")(x), deterministic, group)
            x = dropout(torch.relu(x), self.dropout, deterministic, generator)
        x = self.dense_out(x)
        return torch.tanh(x) if self.last_act else x


class BinarizeHead(nn.Module):
    """Hashing head: ``lin1`` over the input (or, with ``use_mlp``, over
    tanh of an ``MLP`` of width ``mlp_hidden`` without its last tanh,
    joined to the input when ``jump``). Training returns ``tanh(out)``, the
    relaxed code; eval the straight-through sign ``(sign(out) -
    tanh(out)).detach() + tanh(out)``: exact +-1 codes (0 where out is 0)
    with tanh's gradient."""

    def __init__(self, in_features: int, n_output: int, use_mlp: bool = False,
                 mlp_hidden: int = 0, jump: bool = False, device=None):
        super().__init__()
        self.use_mlp = use_mlp
        self.jump = jump
        width = in_features
        if use_mlp:
            self.mlp = MLP(in_features, mlp_hidden, mlp_hidden, 0, 0.0, last_act=False,
                           device=device)
            width = mlp_hidden + (in_features if jump else 0)
        self.lin1 = nn.Linear(width, n_output, device=device)

    def forward(self, x, train: bool = True):
        """Training (``train``) also uses the MLP's batch statistics and
        updates its running ones, as Flax's ``deterministic = not train``."""
        out = x
        if self.use_mlp:
            out = torch.tanh(self.mlp(x, deterministic=not train))
            if self.jump:
                out = torch.cat([out, x], dim=-1)
        out = self.lin1(out)
        soft = torch.tanh(out)
        if train:
            return soft
        return (torch.sign(out) - soft).detach() + soft


class TransformerDecoderHead(nn.Module):
    """PE -> transformer decoder over a session-embedding memory -> dropout
    -> ``lin`` (the next/last-query generation heads). The JAX module's
    ``TransformerDecoder_0`` is the port's ``decoder``."""

    def __init__(self, ninp: int, nout: int, nhead: int, nhid: int, nlayers: int,
                 dropout: float = 0.5, device=None):
        super().__init__()
        self.dropout = dropout
        self.pos_encoder = PositionalEncoding(ninp, dropout, device=device)
        self.decoder = TransformerDecoder(ninp, nhead, nhid, nlayers, dropout, device=device)
        self.lin = nn.Linear(ninp, nout, device=device)

    def forward(self, tgt, memory, tgt_mask=None, tgt_key_padding_mask=None,
                deterministic: bool = True, generator: Optional[torch.Generator] = None):
        """tgt [B, T, ninp]; memory [B, S, ninp]; tgt_mask [T, T] additive;
        tgt_key_padding_mask [B, T], True = PAD -> [B, T, nout]."""
        x = self.pos_encoder(tgt, deterministic, generator)
        x = self.decoder(x, memory, tgt_mask, tgt_key_padding_mask, None, deterministic,
                         generator)
        return self.lin(dropout(x, self.dropout, deterministic, generator))


class CrossAttentionTransformer(nn.Module):
    """Injects K latent tokens derived from a node embedding (``node_lin``)
    into that node's token sequence and transformer-encodes the whole, with
    ``attn_mask[:K, K:] = -inf`` so latent rows do not attend to token rows;
    returns the updated token embeddings. The JAX module's
    ``TransformerEncoder_0`` is the port's ``encoder``."""

    def __init__(self, node_features: int, nlayers: int, node_emb_K: int,
                 token_dim: int, nhead: int, nhid: int, dropout: float = 0.5,
                 device=None):
        super().__init__()
        self.K = node_emb_K
        self.token_dim = token_dim
        self.node_lin = nn.Linear(node_features, node_emb_K * token_dim, device=device)
        self.encoder = TransformerEncoder(token_dim, nhead, nhid, nlayers, dropout,
                                          device=device)

    def forward(self, node_emb, token_emb, token_mask, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """node_emb [B, node_dim]; token_emb [B, S, token_dim]; token_mask
        [B, S] True = PAD -> [B, S, token_dim]."""
        B, S, _ = token_emb.shape
        K = self.K
        lat = self.node_lin(node_emb).reshape(B, K, self.token_dim)
        x = torch.cat([lat, token_emb], dim=1)
        attn_mask = torch.zeros(K + S, K + S, dtype=x.dtype, device=x.device)
        attn_mask[:K, K:] = float("-inf")
        pad = torch.cat([torch.zeros(B, K, dtype=torch.bool, device=x.device),
                         token_mask.bool()], dim=1)
        out = self.encoder(x, pad, attn_mask, deterministic, generator)
        return out[:, K:, :]
