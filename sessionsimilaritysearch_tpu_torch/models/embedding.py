"""Node embedders: text -> vector, asin id -> vector (counterparts of
``sessionsimilaritysearch_tpu/models/embedding.py:25`` ``AveragePooling``,
``:34`` ``NodeTextTransformer``, ``:64`` ``TextEncoder`` and ``:122``
``NodeAsinEmbedding``), and :class:`RowShardedEmbedding`, the lookup into a
table whose rows are split over the ranks of a data-parallel step."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sessionsimilaritysearch_tpu_torch.models.transformer import (
    LN_EPS,
    PositionalEncoding,
    TransformerEncoder,
)


class RowShardedEmbedding(nn.Embedding):
    """An ``nn.Embedding`` that holds rows [start, stop) of a table split
    over the ranks of a data-parallel step (``row_shard``, a
    ``parallel.sharding.RowShard``; ``parallel.sharding.shard_params`` turns
    a table into one). Each rank looks up different ids, so a lookup
    gathers every rank's ids, looks up the ones in this rank's range (zeros
    for the rest) and reduce-scatters the rows back to the ranks that asked:
    the sum over ranks is each id's row, exactly. Its backward all-gathers
    the rows' gradients, and each rank adds up those of its own rows. Every
    rank must look up an id grid of the same shape at the same time."""

    row_shard = None

    def forward(self, ids):
        shard = self.row_shard
        group = shard.group
        local = group.gather(ids) - shard.start
        mine = (local >= 0) & (local < shard.stop - shard.start)
        rows = F.embedding(torch.where(mine, local, 0), self.weight)
        return group.scatter_sum(rows * mine[..., None].to(rows.dtype))


class AveragePooling(nn.Module):
    """Mean over one axis."""

    def __init__(self, axis: int = 1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return x.mean(dim=self.axis)


class NodeTextTransformer(nn.Module):
    """From-scratch text-to-node-vector encoder (the session trainers'
    scratch encoder): token embedding * sqrt(ninp) + sinusoidal PE ->
    post-norm transformer with the key-padding mask -> the mean over ALL
    positions, padding included (the reference's AveragePooling, kept for
    parity, JAX ``embedding.py:62``). Unlike ``TextEncoder`` it is trained:
    nothing is detached."""

    def __init__(self, ntoken: int, ninp: int, nhead: int, nhid: int, nlayers: int,
                 dropout: float = 0.5, device=None):
        super().__init__()
        self.ninp = ninp
        self.embedding = nn.Embedding(ntoken, ninp, device=device)
        self.pos_encoder = PositionalEncoding(ninp, dropout, device=device)
        self.encoder = TransformerEncoder(ninp, nhead, nhid, nlayers, dropout, device=device)

    def forward(self, input_ids, attention_mask, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """input_ids [B', T] int; attention_mask [B', T] (1 = real token)
        -> [B', ninp]."""
        x = self.embedding(input_ids) * math.sqrt(self.ninp)
        x = self.pos_encoder(x, deterministic, generator)
        x = self.encoder(x, attention_mask == 0, None, deterministic, generator)
        return x.mean(dim=1)


class TextEncoder(nn.Module):
    """BERT-style frozen text encoder: token + learned position + token-type
    embeddings -> LayerNorm -> post-norm transformer -> masked mean over
    real tokens, detached (the reference's frozen ``.detach()``). The JAX
    module's optional output Linear (``nout``) is not used by the flagship
    encoder and is not ported."""

    def __init__(self, vocab_size: int, d_model: int = 768, nhead: int = 4,
                 nhid: int = 1024, nlayers: int = 2, max_len: int = 64,
                 device=None):
        super().__init__()
        self.tok_emb = nn.Embedding(vocab_size, d_model, device=device)
        self.pos_emb = nn.Embedding(max_len, d_model, device=device)
        self.type_emb = nn.Embedding(2, d_model, device=device)
        self.emb_ln = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.encoder = TransformerEncoder(d_model, nhead, nhid, nlayers, device=device)

    def forward(self, input_ids, token_type_ids, attention_mask, get_token: bool = False):
        """[B', T] int grids -> [B', d_model] (and, with ``get_token``, the
        per-token embeddings [B', T, d_model]).

        Only the pooled vector is detached, as the JAX module's
        ``stop_gradient`` (``embedding.py:111-112``) stops only it: the
        per-token embeddings carry gradients into the backbone. So the
        backbone runs without autograd unless ``get_token`` asks for them."""
        with torch.set_grad_enabled(get_token and torch.is_grad_enabled()):
            pos = torch.arange(input_ids.shape[-1], device=input_ids.device)
            x = self.emb_ln(
                self.tok_emb(input_ids)
                + self.pos_emb(pos)[None]
                + self.type_emb(torch.clamp(token_type_ids, 0, 1))
            )
            token_emb = self.encoder(x, key_padding_mask=attention_mask == 0)
            mask = attention_mask.to(token_emb.dtype)
            denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
            out = ((token_emb * mask[..., None]).sum(dim=1) / denom).detach()
        if get_token:
            return out, token_emb
        return out


class NodeAsinEmbedding(nn.Module):
    """One learned vector per product id."""

    def __init__(self, nproducts: int, ninp: int, device=None):
        super().__init__()
        self.encoder = nn.Embedding(nproducts, ninp, device=device)

    def forward(self, ids):
        return self.encoder(ids)
