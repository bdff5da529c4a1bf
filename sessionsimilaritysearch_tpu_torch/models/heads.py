"""Projection heads (counterparts of
``sessionsimilaritysearch_tpu/models/heads.py:23`` ``MLP`` and ``:127``
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
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sessionsimilaritysearch_tpu_torch.models.transformer import (
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

    def forward(self, x, deterministic: bool = True):
        if deterministic:
            mean, var = self.mean, self.var
        else:
            flat = x.reshape(-1, x.shape[-1])
            mean = flat.mean(dim=0)
            var = torch.clamp((flat * flat).mean(dim=0) - mean * mean, min=0.0)
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
                generator: Optional[torch.Generator] = None):
        for i in range(self.depth):
            x = getattr(self, f"bn_{i}")(getattr(self, f"dense_{i}")(x), deterministic)
            x = dropout(torch.relu(x), self.dropout, deterministic, generator)
        x = self.dense_out(x)
        return torch.tanh(x) if self.last_act else x


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
